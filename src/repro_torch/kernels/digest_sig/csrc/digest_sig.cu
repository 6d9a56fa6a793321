// Fused Adler-32 partials + n-gram hashes over padded byte matrices, for
// sm_90a.
//
// Replaces: src/repro/kernels/digest_sig/digest_sig.py : digest_sig_partials_batch
//           (Pallas body _digest_sig_kernel).
//   per (row, sub-block of kblock bytes): S = sum b, T = sum t * b  (t = offset
//   in the sub-block); per position i: h_i = sum_{j<n} b_{i+j} * P^(n-1-j)
//   mod 2^32, P = 0x01000193.
//
// Bound on the H100: bytes moved. Per row the kernel reads W + 128 input
// bytes and writes 4 W bytes of hashes plus 8 bytes of partials per
// sub-block; the n - 1 multiply-adds per position are far below the
// integer rate, so device memory (3.35 TB/s) bounds it, and the hash
// writes are 80 % of the traffic.
//
// One launch covers a group of matrices (the width buckets of one wrapper
// call, or a single matrix). The group's descriptor table travels by value
// as a kernel parameter: per matrix its input offset, rows, width, kblock
// and the offsets of its S, T and H outputs in one int32 output buffer. A
// grid of a few blocks per SM walks the units of every matrix in turn,
// grid-stride, with a per-block cursor over the table (no division by a
// 64-bit value anywhere).
//
// Fast body (n <= 17, kblock <= 2048): a 128-thread block takes a tile of
// 128 / (kblock / 16) whole sub-blocks; each thread owns 16 consecutive
// positions. It loads its 16-byte chunk and the next one as two uint4 (the
// 128-byte zero tail keeps every window of n <= 17 bytes in bounds), takes
// the bytes out of the eight words in registers (PRMT) and runs Horner's
// rule for its 16 hashes. It puts them in shared memory as four int4 (the
// slot swizzled by thread so a quarter warp's stores hit distinct banks);
// a tile's hashes are one contiguous span of the output, so each warp then
// writes its threads' 2 KiB as four 512-byte coalesced rows (writing the
// four int4 straight from registers, 64 bytes apart across a warp, was
// 15 % slower on the H100 at 96 x 12,416). S and T of the
// chunk are eight __dp4a (T weights the bytes by their offset 0..15, plus
// 16 * chunk * S). A segmented shuffle sum within each warp (segments are
// the sub-blocks, contiguous runs of threads) leaves one partial per
// (warp, sub-block), added into shared memory; thread k then writes
// sub-block k's S and T. A 2048-byte sub-block is exactly the 128 threads.
//
// General body (17 < n <= 129, or kblock > 2048): one 256-thread block per
// (row, sub-block) unit stages the sub-block plus its 128-byte look-ahead in
// shared memory (each payload byte is read from device memory once although
// n windows cover it), thread t handles positions t, t + 256, ..., and a
// warp-shuffle reduction plus one shared step sum S and T.
//
// Hash arithmetic is uint32_t, whose wrap is defined, where the Pallas
// kernel relied on int32 wrap-around; the int32 outputs carry the same bit
// patterns. T < 2^31 for kblock <= 2048.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFastThreads = 128;  // one 2048-byte sub-block, 16 bytes each
constexpr int kThreads = 256;      // general body
constexpr int kHpad = 128;  // zero bytes after each packed row (ROWGROUP_PAD)
constexpr int kFastMaxN = 17;        // 16 positions + n - 1 <= 32 bytes
constexpr int kFastMaxKblock = 2048;
constexpr int kMaxKblock = 32 * 1024;  // sub-block + look-ahead in 48 KiB
constexpr int kMaxGroup = 64;        // table entries a launch takes
constexpr uint32_t kFnvPrime = 0x01000193u;

// One matrix of the group; must match GROUP_DTYPE in digest_sig.py.
struct Desc {
  int64_t in_off;  // byte offset of the (rows, width + 128) matrix in buf
  int64_t s_off;   // int32 offsets in out: S (rows, width / kblock),
  int64_t t_off;   // T (rows, width / kblock)
  int64_t h_off;   // and H (rows, width)
  int32_t rows;
  int32_t width;
  int32_t kblock;
  int32_t pad;
};
static_assert(sizeof(Desc) == 48, "Desc layout");

struct Table {
  int32_t count;
  int32_t pad[3];
  Desc e[kMaxGroup];
};

__device__ __forceinline__ uint32_t sub_blocks(const Desc& d) {
  return static_cast<uint32_t>(d.rows) *
         static_cast<uint32_t>(d.width / d.kblock);
}

// Advance (b, base) so that unit g lies in entry b: base is the first unit
// of entry b. Units per entry: units(entry). g only grows, so every block
// walks the table once over its whole grid-stride loop.
template <typename Units>
__device__ __forceinline__ bool seek(const Table& tab, uint32_t g, int& b,
                                     uint32_t& base, Units units) {
  while (b < tab.count && g >= base + units(tab.e[b])) {
    base += units(tab.e[b]);
    ++b;
  }
  return b < tab.count;
}

__global__ void __launch_bounds__(kFastThreads)
digest_sig_fast(const __grid_constant__ Table tab, const uint8_t* __restrict__ buf,
                int32_t* __restrict__ out, int n) {
  __shared__ uint32_t red_s[kFastThreads];
  __shared__ uint32_t red_t[kFastThreads];
  __shared__ int4 stage[kFastThreads * 4];  // each thread's 16 hashes
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  red_s[tid] = 0u;
  red_t[tid] = 0u;
  __syncthreads();

  auto tiles = [](const Desc& d) {
    const uint32_t spt = kFastThreads / (d.kblock / 16);
    return (sub_blocks(d) + spt - 1) / spt;
  };
  int b = 0, cur = -1;
  uint32_t base = 0;
  uint32_t kb16 = 0, spt = 0, sb_local = 0, c = 0, nsb = 0, total = 0;
  for (uint32_t g = blockIdx.x; seek(tab, g, b, base, tiles); g += gridDim.x) {
    const Desc& d = tab.e[b];
    if (b != cur) {  // per-entry geometry; divisions by block-uniform values
      cur = b;
      kb16 = static_cast<uint32_t>(d.kblock) / 16;
      spt = kFastThreads / kb16;
      sb_local = tid / kb16;
      c = tid - sb_local * kb16;
      nsb = static_cast<uint32_t>(d.width / d.kblock);
      total = sub_blocks(d);
    }
    const uint32_t sb0 = (g - base) * spt;
    const uint32_t sb = sb0 + sb_local;
    const bool active = sb_local < spt && sb < total;
    uint32_t s = 0u, t = 0u;
    if (active) {
      const uint32_t row = sb / nsb;
      const uint32_t sbr = sb - row * nsb;
      const uint8_t* src = buf + d.in_off +
                           static_cast<int64_t>(row) * (d.width + kHpad) +
                           static_cast<int64_t>(sbr) * d.kblock + 16 * c;
      const uint4 lo = *reinterpret_cast<const uint4*>(src);
      const uint4 hi = *reinterpret_cast<const uint4*>(src + 16);
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t by[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) by[k] = __byte_perm(w[k >> 2], 0u, 0x4440 | (k & 3));
      uint32_t h[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) h[i] = by[i];
#pragma unroll
      for (int j = 1; j < kFastMaxN; ++j) {
        if (j >= n) break;  // n is uniform: a uniform branch
#pragma unroll
        for (int i = 0; i < 16; ++i) h[i] = h[i] * kFnvPrime + by[i + j];
      }
      const int sw = (tid >> 1) & 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        stage[tid * 4 + (q ^ sw)] = make_int4(
            static_cast<int>(h[4 * q]), static_cast<int>(h[4 * q + 1]),
            static_cast<int>(h[4 * q + 2]), static_cast<int>(h[4 * q + 3]));
      }
      s = __dp4a(w[0], 0x01010101u, 0u);
      s = __dp4a(w[1], 0x01010101u, s);
      s = __dp4a(w[2], 0x01010101u, s);
      s = __dp4a(w[3], 0x01010101u, s);
      t = __dp4a(w[0], 0x03020100u, 0u);
      t = __dp4a(w[1], 0x07060504u, t);
      t = __dp4a(w[2], 0x0B0A0908u, t);
      t = __dp4a(w[3], 0x0F0E0D0Cu, t);
      t += 16u * c * s;
    }
    // the warp's 32 threads own 2 KiB of consecutive hashes: it writes
    // them back as four fully coalesced 512-byte rows of 16-byte stores
    __syncwarp();
    {
      const uint32_t live = (total - sb0 < spt ? total - sb0 : spt) * kb16;
      int4* dst = reinterpret_cast<int4*>(
          out + d.h_off + static_cast<int64_t>(sb0) * d.kblock);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t u = (tid & ~31) * 4 + 32 * k + lane;
        const uint32_t owner = u >> 2;
        if (owner < live) dst[u] = stage[owner * 4 + ((u & 3) ^ ((owner >> 1) & 3))];
      }
    }
    // segmented suffix sum: lane + off holds the same sub-block iff
    // c + off < kb16 (sub-blocks are runs of kb16 threads from c = 0)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t s2 = __shfl_down_sync(0xffffffffu, s, off);
      const uint32_t t2 = __shfl_down_sync(0xffffffffu, t, off);
      if (lane + off < 32 && c + off < kb16) {
        s += s2;
        t += t2;
      }
    }
    if (active && (lane == 0 || c == 0)) {  // the head of a segment
      atomicAdd(&red_s[sb_local], s);
      atomicAdd(&red_t[sb_local], t);
    }
    __syncthreads();
    if (tid < static_cast<int>(spt)) {
      if (sb0 + tid < total) {
        out[d.s_off + sb0 + tid] = static_cast<int32_t>(red_s[tid]);
        out[d.t_off + sb0 + tid] = static_cast<int32_t>(red_t[tid]);
      }
      red_s[tid] = 0u;
      red_t[tid] = 0u;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
digest_sig_general(const __grid_constant__ Table tab,
                   const uint8_t* __restrict__ buf, int32_t* __restrict__ out,
                   int n) {
  extern __shared__ __align__(16) uint8_t tile[];  // kblock + kHpad bytes
  __shared__ uint32_t red_s[kThreads / 32];
  __shared__ uint32_t red_t[kThreads / 32];

  auto units = [](const Desc& d) { return sub_blocks(d); };
  int b = 0;
  uint32_t base = 0;
  for (uint32_t g = blockIdx.x; seek(tab, g, b, base, units); g += gridDim.x) {
    const Desc& d = tab.e[b];
    const int kblock = d.kblock;
    const uint32_t nsb = static_cast<uint32_t>(d.width / kblock);
    const uint32_t u = g - base;
    const uint32_t r = u / nsb;
    const uint32_t sb = u - r * nsb;
    const uint8_t* src = buf + d.in_off +
                         static_cast<int64_t>(r) * (d.width + kHpad) +
                         static_cast<int64_t>(sb) * kblock;
    const int span16 = (kblock + kHpad) / 16;
    for (int i = threadIdx.x; i < span16; i += kThreads) {
      reinterpret_cast<uint4*>(tile)[i] = reinterpret_cast<const uint4*>(src)[i];
    }
    __syncthreads();

    uint32_t s = 0, t = 0;
    int32_t* hrow = out + d.h_off + static_cast<int64_t>(u) * kblock;
    for (int i = threadIdx.x; i < kblock; i += kThreads) {
      const uint32_t bv = tile[i];
      s += bv;
      t += static_cast<uint32_t>(i) * bv;
      uint32_t h = bv;
      for (int j = 1; j < n; ++j) h = h * kFnvPrime + tile[i + j];
      hrow[i] = static_cast<int32_t>(h);
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
      t += __shfl_down_sync(0xffffffffu, t, off);
    }
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      red_s[warp] = s;
      red_t[warp] = t;
    }
    __syncthreads();
    if (warp == 0) {
      s = lane < kThreads / 32 ? red_s[lane] : 0u;
      t = lane < kThreads / 32 ? red_t[lane] : 0u;
#pragma unroll
      for (int off = kThreads / 64; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
        t += __shfl_down_sync(0xffffffffu, t, off);
      }
      if (lane == 0) {
        out[d.s_off + u] = static_cast<int32_t>(s);
        out[d.t_off + u] = static_cast<int32_t>(t);
      }
    }
    __syncthreads();  // the tile and red_* are reused by the next unit
  }
}

// Resident blocks of `kernel` on the whole card (SMs x blocks an SM holds).
template <typename Kernel>
int64_t resident_blocks(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// One launch over a group of padded matrices.
// buf: device bytes; entry i's matrix is (rows, width + 128) uint8 at
// buf + in_off, 16-byte aligned, with a zero tail. out: device int32;
// entry i's S and T are (rows, width / kblock) at out + s_off / t_off, its
// H (rows, width) at out + h_off (16-byte aligned). table: host array of
// count 48-byte entries (see Desc), 1 <= count <= 64; width % kblock == 0,
// kblock % 16 == 0, 16 <= kblock <= 32 KiB, rows * (width / kblock) < 2^31
// summed over the group. 2 <= n <= 129.
extern "C" int digest_sig_group(const void* buf, void* out, const void* table,
                                int count, int n, void* stream) {
  if (count < 1 || count > kMaxGroup || n < 2 || n > kHpad + 1 ||
      reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab;
  tab.count = count;
  const Desc* src = static_cast<const Desc*>(table);
  bool fast = n <= kFastMaxN;
  int max_kblock = 0;
  uint64_t units = 0, tiles = 0;
  for (int i = 0; i < count; ++i) {
    const Desc& d = src[i];
    if (d.rows < 0 || d.width <= 0 || d.kblock < 16 || d.kblock % 16 ||
        d.kblock > kMaxKblock || d.width % d.kblock || d.in_off % 16 ||
        d.h_off % 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.e[i] = d;
    fast = fast && d.kblock <= kFastMaxKblock;
    if (d.kblock > max_kblock) max_kblock = d.kblock;
    const uint64_t sbs = static_cast<uint64_t>(d.rows) * (d.width / d.kblock);
    const uint64_t spt = kFastThreads / (d.kblock / 16);
    units += sbs;
    tiles += spt ? (sbs + spt - 1) / spt : 0;
  }
  if (units >= (1ull << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(buf);
  auto* o = static_cast<int32_t*>(out);
  if (units == 0) return static_cast<int>(cudaGetLastError());
  // one wave of resident blocks at most, each walking its units in turn
  static int64_t fast_blocks = 0;
  if (fast) {
    if (fast_blocks == 0) fast_blocks = resident_blocks(digest_sig_fast, kFastThreads, 0);
    const int64_t tl = static_cast<int64_t>(tiles);
    digest_sig_fast<<<static_cast<unsigned>(tl < fast_blocks ? tl : fast_blocks),
                      kFastThreads, 0, st>>>(tab, in, o, n);
  } else {
    const size_t smem = max_kblock + kHpad;
    const int64_t blocks = resident_blocks(digest_sig_general, kThreads, smem);
    const int64_t un = static_cast<int64_t>(units);
    digest_sig_general<<<static_cast<unsigned>(un < blocks ? un : blocks),
                         kThreads, smem, st>>>(tab, in, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// Multi-byte pattern scan over a padded byte matrix, for sm_90a.
//
// Replaces: src/repro/kernels/pattern_scan/pattern_scan.py
//   pattern_scan_batch          (Pallas body _scan_kernel): rows of W + 16
//                               bytes, one pattern for the launch;
//   pattern_scan_rowgroup       (Pallas body _scan_kernel_group): rows of
//                               W + 128 bytes, the columnar store's
//                               row-groups, one pattern;
//   pattern_scan_batch_multi    (Pallas body _scan_kernel_multi): rows of
//                               W + 16 bytes, one pattern per row;
//   pattern_scan_rowgroup_multi (Pallas body _scan_kernel_group_multi):
//                               rows of W + 128 bytes, one pattern per row.
//   mask[r, i] = AND_{j < P_r} buf[r, i + j] == p_r[j],  1 <= P_r <= 16.
//
// Bound on the H100: bytes moved. Per row the kernel reads its W + tail
// input bytes (plus 17 bytes of pattern and length in the multi forms) and
// writes W mask bytes, with a handful of integer operations per byte, so
// it is limited by device memory (3.35 TB/s), never by compute.
//
// Design: Pallas needed an explicit halo input because BlockSpecs cannot
// overlap. Here each row carries a zero tail of at least 16 bytes (the
// row stride is W + 16 for batches, W + 128 for row-groups), so every
// window starting in the row is in bounds and no halo exists. The Pallas
// row-group grid's row grouping (a VMEM budget) has no counterpart: one
// thread per 16 mask bytes covers any row count.
//
// Each thread produces 16 mask bytes: it loads its 16-byte chunk and the next
// one as two uint4 (neighbouring threads on neighbouring addresses, fully
// coalesced; the second load is the neighbour's first and hits cache),
// then for each pattern byte j compares the 16 bytes window[j..j+15]
// against p[j] four at a time with __vcmpeq4 on funnel-shifted words. All
// indices are compile-time constants after unrolling, so the 32-byte
// window stays in registers. The mask is written as one uint4 store.
//
// The row-group entry (pattern_scan_rowgroup) has its own body,
// pattern_scan_rowgroup_kernel: a block walks the 16-byte chunks of one row
// (grid-stride over rows, a grid of at most one wave of resident blocks,
// no division; when the rows are fewer than a wave, a second grid
// dimension splits each row over several blocks so the card stays full),
// and each chunk is a candidate filter with early exit. It
// compares pattern byte 0 at the chunk's 16 positions and goes on to byte
// j + 1 only while some position is still alive; on crawl text most chunks
// die after one or two bytes. The byte compare is the exact SWAR zero-byte
// test on x = window ^ (p_j * 0x01010101): bit 7 of ((x & 0x7F7F7F7F) +
// 0x7F7F7F7F) | x is set exactly where a byte of x is non-zero (no carry
// crosses a byte), so acc &= ~that keeps bit 7 of each byte alive while the
// window matches: one funnel shift, three LOP3 and one IADD3 per 4
// positions and pattern byte. A thread loads up to kAhead of its chunks
// before it compares any (more bytes in flight: 5 % faster on crawl-like
// text at 675 x 12,416 than one chunk at a time). The mask is bit-for-bit
// the batch form's.
//
// The multi forms (kMulti) read the row's 16-byte pattern as one uint4 and
// its length from device arrays; the loop runs to the launch's longest
// pattern (max_len) and a position j >= 1 at or past the row's own length
// is skipped, i.e. forced to match, exactly as the Pallas kernel ORs in
// j >= plen (position 0 is always compared, as there). So any length
// value gives the Pallas result and no length needs a device-side check.
// The gateway pads a batch with inert rows (all zero, pattern [1, 0, ...]
// of length 1), whose masks it discards.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatchTail = 16;  // zero bytes after a batch row (MAX_PATTERN)
constexpr int kGroupTail = 128;  // ... after a row-group row (ROWGROUP_PAD)
constexpr int kAhead = 4;  // chunks a row-group thread loads before comparing

// row_stride: bytes from one row of buf to the next (W + the zero tail).
// Single-pattern form: the pattern in pat_lo/pat_hi, pat_len its length.
// Multi form: row r's pattern is pats[16 r .. 16 r + 15] and its length
// lens[r]; pat_len is the launch's longest length (the loop bound).
template <bool kMulti>
__global__ void __launch_bounds__(kThreads)
pattern_scan_kernel(const uint8_t* __restrict__ buf, uint8_t* __restrict__ mask,
                    int64_t rows, int64_t width, int64_t row_stride,
                    uint64_t pat_lo, uint64_t pat_hi, int pat_len,
                    const uint8_t* __restrict__ pats,
                    const int32_t* __restrict__ lens) {
  const int64_t vecs_per_row = width / 16;
  const int64_t total = rows * vecs_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < total; v += stride) {
    const int64_t r = v / vecs_per_row;
    const int64_t c = (v - r * vecs_per_row) * 16;
    uint64_t lo = pat_lo, hi = pat_hi;
    int row_len = pat_len;
    if (kMulti) {
      const uint4 p = reinterpret_cast<const uint4*>(pats)[r];
      lo = static_cast<uint64_t>(p.x) | (static_cast<uint64_t>(p.y) << 32);
      hi = static_cast<uint64_t>(p.z) | (static_cast<uint64_t>(p.w) << 32);
      row_len = lens[r];
    }
    const uint8_t* src = buf + r * row_stride + c;
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const uint4 b = *reinterpret_cast<const uint4*>(src + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t acc[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      // positions past the row's own length are forced to match
      if (j < pat_len && (!kMulti || j == 0 || j < row_len)) {
        const uint64_t word = j < 8 ? lo : hi;
        const uint32_t pj =
            static_cast<uint32_t>((word >> (8 * (j & 7))) & 0xFFu) * 0x01010101u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int off = j + 4 * q;  // first window byte of this word
          const uint32_t bytes4 =
              __funnelshift_r(w[off >> 2], w[(off >> 2) + 1], (off & 3) * 8);
          acc[q] &= __vcmpeq4(bytes4, pj);
        }
      }
    }
    uint4 out;
    out.x = acc[0] & 0x01010101u;
    out.y = acc[1] & 0x01010101u;
    out.z = acc[2] & 0x01010101u;
    out.w = acc[3] & 0x01010101u;
    *reinterpret_cast<uint4*>(mask + r * width + c) = out;
  }
}

// One block per row (grid-stride; gridDim.y blocks per row when rows are
// few), its threads walking the row's chunks kAhead at a time.
__global__ void __launch_bounds__(kThreads)
pattern_scan_rowgroup_kernel(const uint8_t* __restrict__ buf,
                             uint8_t* __restrict__ mask, int64_t rows,
                             int64_t width, int64_t row_stride,
                             uint64_t pat_lo, uint64_t pat_hi, int pat_len) {
  uint32_t pj[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint64_t word = j < 8 ? pat_lo : pat_hi;
    pj[j] = static_cast<uint32_t>((word >> (8 * (j & 7))) & 0xFFu) * 0x01010101u;
  }
  const int64_t chunks = width / 16;
  // gridDim.y blocks share a row (when the rows are fewer than a wave),
  // interleaved a block's width apart
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.y;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const uint8_t* row = buf + r * row_stride;
    uint8_t* out_row = mask + r * width;
    for (int64_t c0 = blockIdx.y * blockDim.x + threadIdx.x; c0 < chunks;
         c0 += kAhead * stride) {
      uint4 lo[kAhead], hi[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int64_t c = c0 + u * stride;
        if (c < chunks) {
          lo[u] = *reinterpret_cast<const uint4*>(row + 16 * c);
          hi[u] = *reinterpret_cast<const uint4*>(row + 16 * c + 16);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int64_t c = c0 + u * stride;
        if (c >= chunks) break;
        const uint32_t w[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                               hi[u].x, hi[u].y, hi[u].z, hi[u].w};
        uint32_t acc[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j >= pat_len || (acc[0] | acc[1] | acc[2] | acc[3]) == 0u) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int off = j + 4 * q;  // first window byte of this word
            const uint32_t x =
                __funnelshift_r(w[off >> 2], w[(off >> 2) + 1], (off & 3) * 8) ^ pj[j];
            acc[q] &= ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
          }
        }
        *reinterpret_cast<uint4*>(out_row + 16 * c) =
            make_uint4(acc[0] >> 7, acc[1] >> 7, acc[2] >> 7, acc[3] >> 7);
      }
    }
  }
}

// pats == nullptr launches the single-pattern form.
int launch(const void* buf, void* mask, int64_t rows, int64_t width,
           int64_t row_stride, uint64_t pat_lo, uint64_t pat_hi, int pat_len,
           const void* pats, const void* lens, void* stream) {
  if (width <= 0 || width % 16 || pat_len < 1 || pat_len > 16 ||
      reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16 ||
      reinterpret_cast<uintptr_t>(pats) % 16 ||
      reinterpret_cast<uintptr_t>(lens) % 4 ||
      (pats == nullptr) != (lens == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = rows * (width / 16);
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > (1 << 30)) blocks = 1 << 30;
    const auto grid = static_cast<unsigned>(blocks);
    const auto st = static_cast<cudaStream_t>(stream);
    const auto* in = static_cast<const uint8_t*>(buf);
    auto* out = static_cast<uint8_t*>(mask);
    if (pats == nullptr) {
      pattern_scan_kernel<false><<<grid, kThreads, 0, st>>>(
          in, out, rows, width, row_stride, pat_lo, pat_hi, pat_len, nullptr,
          nullptr);
    } else {
      pattern_scan_kernel<true><<<grid, kThreads, 0, st>>>(
          in, out, rows, width, row_stride, 0, 0, pat_len,
          static_cast<const uint8_t*>(pats),
          static_cast<const int32_t*>(lens));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf: (rows, width + 16) uint8, mask: (rows, width) uint8, width % 16 == 0,
// both 16-byte aligned. The pattern's bytes are packed little-endian into
// pat_lo (bytes 0-7) and pat_hi (bytes 8-15); 1 <= pat_len <= 16.
extern "C" int pattern_scan_batch(const void* buf, void* mask, int64_t rows,
                                  int64_t width, uint64_t pat_lo,
                                  uint64_t pat_hi, int pat_len, void* stream) {
  return launch(buf, mask, rows, width, width + kBatchTail, pat_lo, pat_hi,
                pat_len, nullptr, nullptr, stream);
}

// The row-group form: buf is (rows, stride) uint8 with stride == width + 128
// (payload left-justified, zero tail), everything else as above.
extern "C" int pattern_scan_rowgroup(const void* buf, void* mask, int64_t rows,
                                     int64_t width, int64_t stride,
                                     uint64_t pat_lo, uint64_t pat_hi,
                                     int pat_len, void* stream) {
  if (stride != width + kGroupTail || width <= 0 || width % 16 ||
      pat_len < 1 || pat_len > 16 || reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0) {
    // a block as wide as the row's chunks (whole warps, at most kThreads),
    // and at most one wave of resident blocks
    const int64_t chunks = width / 16;
    const int threads = static_cast<int>(
        chunks >= kThreads ? kThreads : (chunks + 31) / 32 * 32);
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pattern_scan_rowgroup_kernel, threads, 0);
    const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    // rows fewer than a wave: split each row over blocks, at most until
    // a thread has kAhead chunks
    const int64_t rounds = (chunks + threads * kAhead - 1) / (threads * kAhead);
    int64_t per_row = rows < wave ? wave / rows : 1;
    if (per_row > rounds) per_row = rounds;
    const dim3 grid(static_cast<unsigned>(rows < wave ? rows : wave),
                    static_cast<unsigned>(per_row));
    pattern_scan_rowgroup_kernel<<<grid, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(mask), rows,
        width, stride, pat_lo, pat_hi, pat_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// One pattern per row: pats is (rows, 16) uint8, 16-byte aligned, row r's
// pattern zero-padded; lens is (rows,) int32, the rows' pattern lengths
// (1..max_len for a real pattern); 1 <= max_len <= 16. buf and mask as in
// pattern_scan_batch.
extern "C" int pattern_scan_batch_multi(const void* buf, void* mask,
                                        int64_t rows, int64_t width,
                                        const void* pats, const void* lens,
                                        int max_len, void* stream) {
  if (pats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(buf, mask, rows, width, width + kBatchTail, 0, 0, max_len,
                pats, lens, stream);
}

// The row-group form of pattern_scan_batch_multi: buf is (rows, stride)
// uint8 with stride == width + 128.
extern "C" int pattern_scan_rowgroup_multi(const void* buf, void* mask,
                                           int64_t rows, int64_t width,
                                           int64_t stride, const void* pats,
                                           const void* lens, int max_len,
                                           void* stream) {
  if (stride != width + kGroupTail || pats == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(buf, mask, rows, width, stride, 0, 0, max_len, pats, lens,
                stream);
}

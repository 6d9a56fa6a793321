// Multi-byte pattern scan over padded byte matrices, for sm_90a.
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
// Which entry runs which body (every one the candidate filter below):
//   pattern_scan_group, pattern_scan_multi_group (the batch forms, #1 and
//     #4, as grouped launches) -> pattern_scan_group_kernel<kMulti>;
//   pattern_scan_rowgroup (#3) -> pattern_scan_rowgroup_kernel;
//   pattern_scan_rowgroup_multi (#5) -> pattern_scan_rowgroup_multi_kernel,
//     #3's grid over the group body's row loop.
//
// Bound on the H100: bytes moved. Per row a kernel reads its W + tail
// input bytes (plus 20 bytes of pattern and length in the multi forms) and
// writes W mask bytes, with a handful of integer operations per byte, so
// it is limited by device memory (3.35 TB/s), never by compute.
//
// No halo: Pallas needed an explicit halo input because BlockSpecs cannot
// overlap. Here each row carries a zero tail of at least 16 bytes (the
// row stride is W + 16 for batches, W + 128 for row-groups), so every
// window starting in the row is in bounds.
//
// The candidate filter, which every entry runs: a thread takes 16-byte
// chunks of one row, loading kAhead of them before it compares any, and
// for each chunk compares pattern byte 0 at the chunk's
// 16 positions, going on to byte j + 1 only while some position is still
// alive; on crawl text most chunks die after one or two bytes. The byte
// compare is the exact SWAR zero-byte test on x = window ^ (p_j *
// 0x01010101): bit 7 of ((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x is set exactly
// where a byte of x is non-zero (no carry crosses a byte), so acc &= ~that
// keeps bit 7 of each byte alive while the window matches: one funnel
// shift, three LOP3 and one IADD3 per 4 positions and pattern byte. No
// chunk loop compares with __vcmpeq4 (which sm_90 lowers to PRMT/LOP3) or
// runs an integer division.
//
// The batch forms (#1, #4): one launch of their group body sweeps every
// width bucket of a wrapper call: the buckets are packed at 16-byte-aligned
// offsets of one buffer, and a descriptor table (Desc, at most kMaxGroup
// entries, by value as a __grid_constant__ parameter) gives each its
// offsets, rows and width. The launcher adds each entry's block geometry:
// a row takes 2^shift threads of a block (a row of fewer than 256 chunks
// shares its block with other rows), and when the rows of the launch are
// fewer than a wave of resident blocks, each row is split over `parts`
// blocks, at most until a thread has one chunk, so that a launch of few
// rows (48 rows of 16,400 bytes is the CDX scan's usual bucket) fills the
// card. A block finds its entry by a scan of the entries' first blocks.
//
// The multi forms read the row's 16-byte pattern as one uint4 and its
// length, once per row, after the row's first chunk loads are issued; a
// position j >= 1 at or past the row's own length is forced to match,
// exactly as the Pallas kernel ORs in j >= plen (position 0 is always
// compared, as there). So the loop stops at min(max_len, lens[r]) (at
// least 1), any length value gives the Pallas result, and no length needs
// a device-side check. The gateway pads a bucket with inert rows (all
// zero, pattern [1, 0, ...] of length 1): they die at byte 0, and their
// masks are discarded.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLogThreads = 8;
constexpr int kBatchTail = 16;  // zero bytes after a batch row (MAX_PATTERN)
constexpr int kGroupTail = 128;  // ... after a row-group row (ROWGROUP_PAD)
constexpr int kAhead = 4;  // chunks a thread loads before comparing
constexpr int kMaxGroup = 64;  // table entries a launch takes

// One width bucket of a grouped batch launch; must match GROUP_DTYPE in
// pattern_scan.py. Offsets are in bytes from their own base pointer.
struct Desc {
  int64_t in_off;    // the (rows, width + 16) matrix in buf
  int64_t mask_off;  // the (rows, width) mask in mask
  int64_t pat_off;   // multi: the (rows, 16) patterns in pats
  int64_t len_off;   // multi: the (rows,) int32 lengths in lens
  int32_t rows;
  int32_t width;
  int32_t max_len;   // multi: the entry's loop bound (its longest length)
  int32_t first;     // set by the launcher: the entry's first block
  int32_t parts;     // set by the launcher: blocks a row is split over
  int32_t shift;     // set by the launcher: log2 of a row's threads
};
static_assert(sizeof(Desc) == 56, "Desc layout");

struct Table {
  int32_t count;
  int32_t pad[3];
  Desc e[kMaxGroup];
};

// The filter over one chunk: w holds the chunk and the next 16 bytes, pj
// the pattern bytes times 0x01010101; returns the 16 mask bytes.
__device__ __forceinline__ uint4 scan_chunk(const uint4 lo, const uint4 hi,
                                            const uint32_t (&pj)[16],
                                            int bound) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t acc[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j >= bound || (acc[0] | acc[1] | acc[2] | acc[3]) == 0u) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int off = j + 4 * q;  // first window byte of this word
      const uint32_t x =
          __funnelshift_r(w[off >> 2], w[(off >> 2) + 1], (off & 3) * 8) ^ pj[j];
      acc[q] &= ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
    }
  }
  return make_uint4(acc[0] >> 7, acc[1] >> 7, acc[2] >> 7, acc[3] >> 7);
}

__device__ __forceinline__ void spread(uint64_t lo, uint64_t hi,
                                       uint32_t (&pj)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint64_t word = j < 8 ? lo : hi;
    pj[j] = static_cast<uint32_t>((word >> (8 * (j & 7))) & 0xFFu) * 0x01010101u;
  }
}

// A multi form's row: its pattern (16 bytes at pat) spread into pj and its
// loop bound, min(*len, max_len) but at least 1 (positions past the row's
// length are forced to match; position 0 is always compared).
__device__ __forceinline__ void row_pattern(const uint8_t* __restrict__ pat,
                                            const uint8_t* __restrict__ len,
                                            int max_len, uint32_t (&pj)[16],
                                            int& bound) {
  const uint4 p = *reinterpret_cast<const uint4*>(pat);
  const int n = *reinterpret_cast<const int32_t*>(len);
  spread(static_cast<uint64_t>(p.x) | (static_cast<uint64_t>(p.y) << 32),
         static_cast<uint64_t>(p.z) | (static_cast<uint64_t>(p.w) << 32), pj);
  bound = n < max_len ? n : max_len;
  if (bound < 1) bound = 1;
}

// A thread's chunks of one row of the group body: c0, c0 + stride, ...,
// kAhead loaded ahead. pattern(pj, bound) sets the pattern bytes times
// 0x01010101 and the loop bound; it runs after the first chunks' loads
// are issued, so a pattern read from device memory waits beside them, not
// before them.
template <typename Pattern>
__device__ __forceinline__ void scan_row(const uint8_t* __restrict__ row,
                                         uint8_t* __restrict__ out_row,
                                         int64_t chunks, int64_t c0,
                                         int64_t stride, Pattern pattern) {
  uint4 lo[kAhead], hi[kAhead];
  auto load = [&](int64_t from) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t c = from + u * stride;
      if (c < chunks) {
        lo[u] = *reinterpret_cast<const uint4*>(row + 16 * c);
        hi[u] = *reinterpret_cast<const uint4*>(row + 16 * c + 16);
      }
    }
  };
  if (c0 >= chunks) return;
  load(c0);
  uint32_t pj[16];
  int bound;
  pattern(pj, bound);
  for (;;) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t c = c0 + u * stride;
      if (c >= chunks) break;
      *reinterpret_cast<uint4*>(out_row + 16 * c) =
          scan_chunk(lo[u], hi[u], pj, bound);
    }
    c0 += kAhead * stride;
    if (c0 >= chunks) break;
    load(c0);
  }
}

// The batch forms, grouped: block b serves entry e with first <= b < the
// next entry's first. Single-pattern form: the pattern in pat_lo/pat_hi,
// pat_len its length, for every entry. Multi form: row r of entry e has its
// pattern at pats + pat_off + 16 r and its length at lens + len_off + 4 r.
template <bool kMulti>
__global__ void __launch_bounds__(kThreads)
pattern_scan_group_kernel(const __grid_constant__ Table tab,
                          const uint8_t* __restrict__ buf,
                          uint8_t* __restrict__ mask,
                          const uint8_t* __restrict__ pats,
                          const uint8_t* __restrict__ lens, uint64_t pat_lo,
                          uint64_t pat_hi, int pat_len) {
  int b = 0;
  while (b + 1 < tab.count &&
         blockIdx.x >= static_cast<uint32_t>(tab.e[b + 1].first)) {
    ++b;
  }
  const Desc& d = tab.e[b];
  uint32_t unit = blockIdx.x - static_cast<uint32_t>(d.first);
  uint32_t part = 0;
  if (d.parts > 1) {  // once per block, by a block-uniform value
    const uint32_t rowblock = unit / static_cast<uint32_t>(d.parts);
    part = unit - rowblock * static_cast<uint32_t>(d.parts);
    unit = rowblock;
  }
  const uint32_t r =
      (unit << (kLogThreads - d.shift)) + (threadIdx.x >> d.shift);
  if (r >= static_cast<uint32_t>(d.rows)) return;
  const uint32_t tpr = 1u << d.shift;  // threads a row takes in a block
  scan_row(buf + d.in_off + static_cast<int64_t>(r) * (d.width + kBatchTail),
           mask + d.mask_off + static_cast<int64_t>(r) * d.width, d.width >> 4,
           part * tpr + (threadIdx.x & (tpr - 1)),
           static_cast<int64_t>(tpr) * d.parts,
           [&](uint32_t (&pj)[16], int& bound) {
             if constexpr (!kMulti) {
               spread(pat_lo, pat_hi, pj);
               bound = pat_len;
               return;
             }
             row_pattern(pats + d.pat_off + 16 * static_cast<int64_t>(r),
                         lens + d.len_off + 4 * static_cast<int64_t>(r),
                         d.max_len, pj, bound);
           });
}

// One block per row (grid-stride; gridDim.y blocks per row when rows are
// few), its threads walking the row's chunks kAhead at a time.
__global__ void __launch_bounds__(kThreads)
pattern_scan_rowgroup_kernel(const uint8_t* __restrict__ buf,
                             uint8_t* __restrict__ mask, int64_t rows,
                             int64_t width, int64_t row_stride,
                             uint64_t pat_lo, uint64_t pat_hi, int pat_len) {
  uint32_t pj[16];
  spread(pat_lo, pat_hi, pj);
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
        *reinterpret_cast<uint4*>(out_row + 16 * c) =
            scan_chunk(lo[u], hi[u], pj, pat_len);
      }
    }
  }
}

// The row-group form with one pattern per row: #3's grid (one block per
// row, grid-stride; gridDim.y blocks per row when rows are few) over the
// group body's row loop, so row r's pattern and length are read once per
// row and thread, after its first chunk loads. #3 keeps its own loop: on
// the group body's it lost ~3 %.
__global__ void __launch_bounds__(kThreads)
pattern_scan_rowgroup_multi_kernel(const uint8_t* __restrict__ buf,
                                   uint8_t* __restrict__ mask, int64_t rows,
                                   int64_t width, int64_t row_stride,
                                   const uint8_t* __restrict__ pats,
                                   const uint8_t* __restrict__ lens,
                                   int max_len) {
  const int64_t chunks = width / 16;
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * blockDim.x + threadIdx.x;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    scan_row(buf + r * row_stride, mask + r * width, chunks, c0, stride,
             [&](uint32_t (&pj)[16], int& bound) {
               row_pattern(pats + 16 * r, lens + 4 * r, max_len, pj, bound);
             });
  }
}

// Resident blocks of `kernel` on the whole card (SMs x blocks an SM holds).
template <typename Kernel>
int64_t resident_blocks(Kernel kernel) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// Blocks of an entry's rows before any split: 256 >> shift rows a block.
int64_t row_blocks(const Desc& d) {
  return (static_cast<int64_t>(d.rows) + (kThreads >> d.shift) - 1) >>
         (kLogThreads - d.shift);
}

// Validate a group's table, fill in each entry's block geometry and launch
// it once. multi: pats and lens are the base pointers of the entries'
// patterns and lengths.
int launch_group(const void* buf, void* mask, const void* pats,
                 const void* lens, const void* table, int count,
                 uint64_t pat_lo, uint64_t pat_hi, int pat_len, bool multi,
                 void* stream) {
  if (count < 1 || count > kMaxGroup || pat_len < 1 || pat_len > 16 ||
      reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16 ||
      (multi && (pats == nullptr || lens == nullptr ||
                 reinterpret_cast<uintptr_t>(pats) % 16 ||
                 reinterpret_cast<uintptr_t>(lens) % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab;
  tab.count = count;
  const Desc* src = static_cast<const Desc*>(table);
  int64_t rowblocks = 0;
  for (int i = 0; i < count; ++i) {
    Desc d = src[i];
    if (d.rows < 0 || d.width <= 0 || d.width % 16 || d.in_off % 16 ||
        d.mask_off % 16 ||
        (multi && (d.pat_off % 16 || d.len_off % 4 || d.max_len < 1 ||
                   d.max_len > 16))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int32_t chunks = d.width / 16;
    d.shift = 0;  // a row's threads: the chunks' power of two, at most 256
    while (d.shift < kLogThreads && (1 << d.shift) < chunks) ++d.shift;
    rowblocks += row_blocks(d);
    tab.e[i] = d;
  }
  static int64_t wave = 0;
  if (wave == 0) wave = resident_blocks(pattern_scan_group_kernel<true>);
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    Desc& d = tab.e[i];
    const int64_t rb = row_blocks(d);
    // rows fewer than a wave: split each whole-block row over blocks, at
    // most until a thread has one chunk
    int64_t parts = 1;
    if (d.shift == kLogThreads && rowblocks > 0 && rowblocks < wave) {
      parts = (wave + rowblocks - 1) / rowblocks;
      const int64_t most = (d.width / 16 + kThreads - 1) / kThreads;
      if (parts > most) parts = most;
    }
    d.parts = static_cast<int32_t>(parts);
    d.first = static_cast<int32_t>(blocks);
    blocks += rb * parts;
    if (blocks >= (int64_t{1} << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto grid = static_cast<unsigned>(blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(buf);
  auto* out = static_cast<uint8_t*>(mask);
  const auto* p = static_cast<const uint8_t*>(pats);
  const auto* n = static_cast<const uint8_t*>(lens);
  if (blocks > 0 && multi) {
    pattern_scan_group_kernel<true><<<grid, kThreads, 0, st>>>(
        tab, in, out, p, n, 0, 0, 1);
  } else if (blocks > 0) {
    pattern_scan_group_kernel<false><<<grid, kThreads, 0, st>>>(
        tab, in, out, nullptr, nullptr, pat_lo, pat_hi, pat_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch a row-group kernel over rows of `width` bytes: a block as wide as
// the row's chunks (whole warps, at most kThreads), at most one wave of
// resident blocks, and, when the rows are fewer than a wave, each row split
// over gridDim.y blocks, at most until a thread has kAhead chunks.
template <typename Kernel, typename... Args>
int launch_rowgroup(Kernel kernel, int64_t rows, int64_t width, void* stream,
                    Args... args) {
  if (rows > 0) {
    const int64_t chunks = width / 16;
    const int threads = static_cast<int>(
        chunks >= kThreads ? kThreads : (chunks + 31) / 32 * 32);
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
    const int64_t rounds = (chunks + threads * kAhead - 1) / (threads * kAhead);
    int64_t per_row = rows < wave ? wave / rows : 1;
    if (per_row > rounds) per_row = rounds;
    const dim3 grid(static_cast<unsigned>(rows < wave ? rows : wave),
                    static_cast<unsigned>(per_row));
    kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over a group of batch matrices, one pattern for all.
// buf: device bytes; entry i's matrix is (rows, width + 16) uint8 at
// buf + in_off with a zero tail, its mask (rows, width) uint8 at mask +
// mask_off, both 16-byte aligned, width % 16 == 0. table: host array of
// count 56-byte entries (see Desc), 1 <= count <= 64. The pattern's bytes
// are packed little-endian into pat_lo (bytes 0-7) and pat_hi (bytes 8-15);
// 1 <= pat_len <= 16.
extern "C" int pattern_scan_group(const void* buf, void* mask,
                                  const void* table, int count,
                                  uint64_t pat_lo, uint64_t pat_hi,
                                  int pat_len, void* stream) {
  return launch_group(buf, mask, nullptr, nullptr, table, count, pat_lo,
                      pat_hi, pat_len, false, stream);
}

// The same with one pattern per row: entry i's patterns are (rows, 16)
// uint8 at pats + pat_off (16-byte aligned, zero-padded), its lengths
// (rows,) int32 at lens + len_off; 1 <= max_len <= 16 per entry.
extern "C" int pattern_scan_multi_group(const void* buf, void* mask,
                                        const void* pats, const void* lens,
                                        const void* table, int count,
                                        void* stream) {
  return launch_group(buf, mask, pats, lens, table, count, 0, 0, 1, true,
                      stream);
}

// The row-group form: buf is (rows, stride) uint8 with stride == width + 128
// (payload left-justified, zero tail), mask (rows, width) uint8, both
// 16-byte aligned; the pattern as in pattern_scan_group.
extern "C" int pattern_scan_rowgroup(const void* buf, void* mask, int64_t rows,
                                     int64_t width, int64_t stride,
                                     uint64_t pat_lo, uint64_t pat_hi,
                                     int pat_len, void* stream) {
  if (stride != width + kGroupTail || width <= 0 || width % 16 ||
      pat_len < 1 || pat_len > 16 || reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rowgroup(pattern_scan_rowgroup_kernel, rows, width, stream,
                         static_cast<const uint8_t*>(buf),
                         static_cast<uint8_t*>(mask), rows, width, stride,
                         pat_lo, pat_hi, pat_len);
}

// One pattern per row over a row-group: buf is (rows, stride) uint8 with
// stride == width + 128, mask (rows, width) uint8, both 16-byte aligned;
// pats is (rows, 16) uint8, 16-byte aligned, row r's pattern zero-padded;
// lens is (rows,) int32, the rows' pattern lengths (any value: see the
// multi forms above); 1 <= max_len <= 16.
extern "C" int pattern_scan_rowgroup_multi(const void* buf, void* mask,
                                           int64_t rows, int64_t width,
                                           int64_t stride, const void* pats,
                                           const void* lens, int max_len,
                                           void* stream) {
  if (stride != width + kGroupTail || width <= 0 || width % 16 ||
      max_len < 1 || max_len > 16 || pats == nullptr || lens == nullptr ||
      reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16 ||
      reinterpret_cast<uintptr_t>(pats) % 16 ||
      reinterpret_cast<uintptr_t>(lens) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_rowgroup(pattern_scan_rowgroup_multi_kernel, rows, width,
                         stream, static_cast<const uint8_t*>(buf),
                         static_cast<uint8_t*>(mask), rows, width, stride,
                         static_cast<const uint8_t*>(pats),
                         static_cast<const uint8_t*>(lens), max_len);
}

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
  if (stride != width + kGroupTail) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(buf, mask, rows, width, stride, pat_lo, pat_hi, pat_len,
                nullptr, nullptr, stream);
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

// Multi-byte pattern scan over a padded byte matrix, for sm_90a.
//
// Replaces: src/repro/kernels/pattern_scan/pattern_scan.py
//   pattern_scan_batch    (Pallas body _scan_kernel): rows of W + 16 bytes;
//   pattern_scan_rowgroup (Pallas body _scan_kernel_group): rows of
//                         W + 128 bytes, the columnar store's row-groups.
//   mask[r, i] = AND_{j < P} buf[r, i + j] == p[j],  P <= 16.
//
// Bound on the H100: bytes moved. Per row the kernel reads its W + tail
// input bytes and writes W mask bytes, with a handful of integer
// operations per byte, so it is limited by device memory (3.35 TB/s),
// never by compute.
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
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatchTail = 16;  // zero bytes after a batch row (MAX_PATTERN)
constexpr int kGroupTail = 128;  // ... after a row-group row (ROWGROUP_PAD)

// row_stride: bytes from one row of buf to the next (W + the zero tail).
__global__ void __launch_bounds__(kThreads)
pattern_scan_kernel(const uint8_t* __restrict__ buf, uint8_t* __restrict__ mask,
                    int64_t rows, int64_t width, int64_t row_stride,
                    uint64_t pat_lo, uint64_t pat_hi, int pat_len) {
  const int64_t vecs_per_row = width / 16;
  const int64_t total = rows * vecs_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < total; v += stride) {
    const int64_t r = v / vecs_per_row;
    const int64_t c = (v - r * vecs_per_row) * 16;
    const uint8_t* src = buf + r * row_stride + c;
    const uint4 a = *reinterpret_cast<const uint4*>(src);
    const uint4 b = *reinterpret_cast<const uint4*>(src + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t acc[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < pat_len) {
        const uint64_t word = j < 8 ? pat_lo : pat_hi;
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

int launch(const void* buf, void* mask, int64_t rows, int64_t width,
           int64_t row_stride, uint64_t pat_lo, uint64_t pat_hi, int pat_len,
           void* stream) {
  if (width <= 0 || width % 16 || pat_len < 1 || pat_len > 16 ||
      reinterpret_cast<uintptr_t>(buf) % 16 ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = rows * (width / 16);
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > (1 << 30)) blocks = 1 << 30;
    pattern_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(mask), rows,
        width, row_stride, pat_lo, pat_hi, pat_len);
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
                pat_len, stream);
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
                stream);
}

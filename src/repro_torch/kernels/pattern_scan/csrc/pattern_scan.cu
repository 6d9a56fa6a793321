// Multi-byte pattern scan over a padded byte matrix, for sm_90a.
//
// Replaces: src/repro/kernels/pattern_scan/pattern_scan.py : pattern_scan_batch
//           (Pallas body _scan_kernel).
//   mask[r, i] = AND_{j < P} buf[r, i + j] == p[j],  P <= 16.
//
// Bound on the H100: bytes moved. Per row the kernel reads W + 16 input
// bytes and writes W mask bytes, with a handful of integer operations per
// byte, so it is limited by device memory (3.35 TB/s), never by compute.
//
// Design: Pallas needed an explicit halo input because BlockSpecs cannot
// overlap. Here each row is packed as (W + 16) bytes with a zero tail, so
// every window starting in the row is in bounds and no halo exists. Each
// thread produces 16 mask bytes: it loads its 16-byte chunk and the next
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
constexpr int kTail = 16;  // zero bytes after each packed row (MAX_PATTERN)

__global__ void __launch_bounds__(kThreads)
pattern_scan_kernel(const uint8_t* __restrict__ buf, uint8_t* __restrict__ mask,
                    int64_t rows, int64_t width, uint64_t pat_lo,
                    uint64_t pat_hi, int pat_len) {
  const int64_t vecs_per_row = width / 16;
  const int64_t total = rows * vecs_per_row;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < total; v += stride) {
    const int64_t r = v / vecs_per_row;
    const int64_t c = (v - r * vecs_per_row) * 16;
    const uint8_t* src = buf + r * (width + kTail) + c;
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

}  // namespace

// buf: (rows, width + 16) uint8, mask: (rows, width) uint8, width % 16 == 0,
// both 16-byte aligned. The pattern's bytes are packed little-endian into
// pat_lo (bytes 0-7) and pat_hi (bytes 8-15); 1 <= pat_len <= 16.
extern "C" int pattern_scan_batch(const void* buf, void* mask, int64_t rows,
                                  int64_t width, uint64_t pat_lo,
                                  uint64_t pat_hi, int pat_len, void* stream) {
  const int64_t total = rows * (width / 16);
  if (total > 0) {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > (1 << 30)) blocks = 1 << 30;
    pattern_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(mask), rows,
        width, pat_lo, pat_hi, pat_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// Adler-32 partial sums over a zero-padded byte matrix, for sm_90a.
//
// Replaces: src/repro/kernels/adler32/adler32.py : adler32_partials_batch
//           (Pallas body _adler_kernel).
//   per (row, 2048-byte block j): S_j = sum_t b_t,  T_j = sum_t t * b_t
//   (t = offset inside the block). The host combines the partials mod 65521.
//
// Bound on the H100: bytes moved. Per row the kernel reads its W input
// bytes and writes 8 bytes per 2048-byte block; two dot products of four
// bytes per loaded word are far below the integer rate, so device memory
// (3.35 TB/s) bounds it.
//
// Design: the Pallas grid ran one (1, 2048) tile per step in order. Here
// one warp owns one (row, block): each lane makes four coalesced 16-byte
// loads (lane l reads bytes 16 l + 512 k, k = 0..3, so a warp reads 512
// contiguous bytes per step), forms the sums of its words with __dp4a
// (weights 1,1,1,1 for S and 0,1,2,3 for the in-word offset of T), and the
// warp reduces S and T with shuffles. Eight warps per thread block, a
// grid-stride loop over (row, block) pairs. Accumulation is uint32_t:
// T <= 2047 * 2048 / 2 * 255 ~ 5.3e8 < 2^31, so the int32 outputs hold the
// exact sums; the unsigned type keeps every intermediate defined.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 2048;                   // bytes per Adler block
constexpr int kThreads = 256;                  // 8 warps per thread block
constexpr int kWarps = kThreads / 32;
constexpr int kVecsPerLane = kBlock / 16 / 32;  // 4 uint4 loads per lane

__device__ __forceinline__ void add_word(uint32_t w, uint32_t off,
                                         uint32_t& s, uint32_t& t) {
  const uint32_t sum = __dp4a(w, 0x01010101u, 0u);  // b0 + b1 + b2 + b3
  s += sum;
  // sum_i (off + i) * b_i = off * sum + (0 b0 + 1 b1 + 2 b2 + 3 b3)
  t += off * sum + __dp4a(w, 0x03020100u, 0u);
}

__global__ void __launch_bounds__(kThreads)
adler32_partials_kernel(const uint8_t* __restrict__ buf,
                        int32_t* __restrict__ s_out,
                        int32_t* __restrict__ t_out, int64_t rows,
                        int64_t width) {
  const int lane = threadIdx.x & 31;
  const int64_t nblocks = width / kBlock;
  const int64_t tasks = rows * nblocks;
  const int64_t warp0 =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t task = warp0; task < tasks; task += step) {
    const int64_t r = task / nblocks;
    const int64_t j = task - r * nblocks;
    const uint4* src =
        reinterpret_cast<const uint4*>(buf + r * width + j * kBlock);
    uint32_t s = 0, t = 0;
#pragma unroll
    for (int k = 0; k < kVecsPerLane; ++k) {
      const int v = k * 32 + lane;  // 16-byte vector index in the block
      const uint4 q = src[v];
      const uint32_t off = static_cast<uint32_t>(v) * 16u;
      add_word(q.x, off, s, t);
      add_word(q.y, off + 4u, s, t);
      add_word(q.z, off + 8u, s, t);
      add_word(q.w, off + 12u, s, t);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      t += __shfl_down_sync(0xffffffffu, t, o);
    }
    if (lane == 0) {
      s_out[task] = static_cast<int32_t>(s);
      t_out[task] = static_cast<int32_t>(t);
    }
  }
}

}  // namespace

// buf: (rows, width) uint8, 16-byte aligned, width a positive multiple of
// 2048; s, t: (rows, width / 2048) int32. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a bad width or alignment).
extern "C" int adler32_partials_batch(const void* buf, void* s, void* t,
                                      int64_t rows, int64_t width,
                                      void* stream) {
  if (rows < 0 || width <= 0 || width % kBlock ||
      reinterpret_cast<uintptr_t>(buf) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tasks = rows * (width / kBlock);
  if (tasks > 0) {
    int64_t blocks = (tasks + kWarps - 1) / kWarps;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride covers the rest
    adler32_partials_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<int32_t*>(s),
        static_cast<int32_t*>(t), rows, width);
  }
  return static_cast<int>(cudaGetLastError());
}

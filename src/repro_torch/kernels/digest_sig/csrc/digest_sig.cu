// Fused Adler-32 partials + n-gram hashes over a padded byte matrix, for sm_90a.
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
// Design: one thread block per (row, sub-block). The block stages its
// sub-block plus the 128-byte look-ahead (the zero tail bounds every
// n-gram window, n <= 129) in shared memory with coalesced 16-byte loads,
// so each payload byte is read from device memory once although n windows
// cover it. Thread t then handles positions t, t + 256, ...: consecutive
// threads write consecutive hash words (coalesced stores), and each
// thread keeps running S and T sums that a warp-shuffle reduction and one
// shared-memory step combine. Hash arithmetic is uint32_t, whose wrap is
// defined, where the Pallas kernel relied on int32 wrap-around; the int32
// outputs carry the same bit patterns. T < 2^31 for kblock <= 2048.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kHpad = 128;  // zero bytes after each packed row (ROWGROUP_PAD)
constexpr uint32_t kFnvPrime = 0x01000193u;

__global__ void __launch_bounds__(kThreads)
digest_sig_kernel(const uint8_t* __restrict__ buf, int32_t* __restrict__ s_out,
                  int32_t* __restrict__ t_out, int32_t* __restrict__ h_out,
                  int64_t width, int kblock, int n) {
  extern __shared__ __align__(16) uint8_t tile[];  // kblock + kHpad bytes
  __shared__ uint32_t red_s[kThreads / 32];
  __shared__ uint32_t red_t[kThreads / 32];

  const int64_t nsb = width / kblock;
  const int64_t r = blockIdx.x / nsb;
  const int64_t sb = blockIdx.x - r * nsb;
  const uint8_t* src = buf + r * (width + kHpad) + sb * kblock;
  const int span16 = (kblock + kHpad) / 16;
  for (int i = threadIdx.x; i < span16; i += kThreads) {
    reinterpret_cast<uint4*>(tile)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
  __syncthreads();

  uint32_t s = 0, t = 0;
  int32_t* hrow = h_out + r * width + sb * kblock;
  for (int i = threadIdx.x; i < kblock; i += kThreads) {
    const uint32_t b = tile[i];
    s += b;
    t += static_cast<uint32_t>(i) * b;
    uint32_t h = b;
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
      s_out[r * nsb + sb] = static_cast<int32_t>(s);
      t_out[r * nsb + sb] = static_cast<int32_t>(t);
    }
  }
}

}  // namespace

// buf: (rows, width + 128) uint8, 16-byte aligned; width % kblock == 0,
// kblock % 16 == 0, kblock <= 32 KiB; 2 <= n <= 129.
// s, t: (rows, width / kblock) int32; h: (rows, width) int32.
extern "C" int digest_sig_partials_batch(const void* buf, void* s, void* t,
                                         void* h, int64_t rows, int64_t width,
                                         int kblock, int n, void* stream) {
  const int64_t blocks = rows * (width / kblock);
  if (blocks > 0) {
    digest_sig_kernel<<<static_cast<unsigned>(blocks), kThreads,
                        kblock + kHpad, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(buf), static_cast<int32_t*>(s),
        static_cast<int32_t*>(t), static_cast<int32_t*>(h), width, kblock, n);
  }
  return static_cast<int>(cudaGetLastError());
}

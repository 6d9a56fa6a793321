// Backward of blocked GQA attention (FlashAttention-2 style recompute),
// for sm_90a.
//
// The reference has no backward kernel: it differentiates its jnp
// chunked_attention under XLA (src/repro/models/attention.py:51, inside the
// layer's jax.checkpoint). This is the gradient of the forward kernel in
// flash_attention.cu, computed from what that kernel's f32 prefill path
// keeps: the output O and the log-sum-exp lse of each query row's scaled
// scores (m + log l; 1e30 on a row with no key). Nothing of size
// [Sq, Sk] is stored: the scores are recomputed tile by tile.
//
//   scale = 1 / sqrt(D), G = H / Hkv query heads a KV head,
//   P  = exp(scale Q K^T - lse)      (0 where the mask drops the key)
//   Delta = rowsum(dO * O)
//   dS = P * (dO V^T - Delta)
//   dQ = scale dS K,  dK = scale sum_g dS^T Q,  dV = sum_g P^T dO
//
// with the forward's bottom-right causal mask (key j kept for query row i
// when j <= i + Sk - Sq; Sq != Sk allowed). A row with no key has P = 0,
// so it adds nothing and its dQ is 0.
//
// f32 in and out, fp32 math on the CUDA cores, D in {16, 32, 64, 128};
// every tensor contiguous: q, o, do, dq [B, H, Sq, D], k, v, dk, dv
// [B, Hkv, Sk, D], lse [B, H, Sq]. Three launches a call:
//
// 1. bwd_delta_kernel: Delta [B, H, Sq] (a workspace the wrapper
//    allocates), one warp a row.
// 2. bwd_dkdv_kernel: grid (KV tiles of 64 keys, B * Hkv). The block keeps
//    its K and V tile in shared memory and loops over the group's G query
//    heads and, for each, over the 64-row query tiles from the first one
//    that sees the tile's first key (causal) to the last. The GQA sum over
//    the heads happens in the block's registers: no atomics, so dK and dV
//    are the same bit for bit from run to run.
// 3. bwd_dq_kernel: grid (query tiles of 64 rows, B * H). The block keeps
//    its Q and dO tile and loops over the KV tiles up to its last row's
//    diagonal.
//
// Thread layout as in the forward's f32 path: 256 threads as 16 x 16;
// thread (ty, tx) computes the scores of rows ty * 4 + a against keys
// tx + 16 c (a, c < 4), reading rows padded by 4 floats so the float4
// reads of a quarter-warp hit distinct banks. An accumulated [64, D]
// product is owned as rows ty * 4 + a by columns (tx + 16 n) * kVec + e.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kB = 64;         // query rows of a Q tile, keys of a KV tile
constexpr int kRpt = 4;        // rows (or keys) a thread: 16 * 4 = kB
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kLdP = kB + kPad;
constexpr float kLseEmpty = 1e30f;

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// rows [r0, r0 + kB) of a contiguous [n, D] matrix into shared memory with
// row stride D + kPad; rows past n are zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n) {
  constexpr int kC = D / 4;
  for (int i = threadIdx.x; i < kB * kC; i += kThreads) {
    const int r = i / kC;
    const int c = i - r * kC;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * D + c * 4);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c * 4) = val;
  }
}

// s[a][c] = Qs[row a] . Ks[key c], dp[a][c] = dOs[row a] . Vs[key c] for
// the thread's rows ty * 4 + a and keys tx + 16 c
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float (&s)[kRpt][4],
                                       float (&dp)[kRpt][4]) {
  constexpr int kLd = D + kPad;
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[a][c] = 0.f;
      dp[a][c] = 0.f;
    }
  }
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 kk[4], vv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kk[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * kLd + d);
      vv[c] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * c) * kLd + d);
    }
#pragma unroll
    for (int a = 0; a < kRpt; ++a) {
      const float4 qa =
          *reinterpret_cast<const float4*>(Qs + (ty * kRpt + a) * kLd + d);
      const float4 ga =
          *reinterpret_cast<const float4*>(dOs + (ty * kRpt + a) * kLd + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa.x, kk[c].x, s[a][c]);
        s[a][c] = fmaf(qa.y, kk[c].y, s[a][c]);
        s[a][c] = fmaf(qa.z, kk[c].z, s[a][c]);
        s[a][c] = fmaf(qa.w, kk[c].w, s[a][c]);
        dp[a][c] = fmaf(ga.x, vv[c].x, dp[a][c]);
        dp[a][c] = fmaf(ga.y, vv[c].y, dp[a][c]);
        dp[a][c] = fmaf(ga.z, vv[c].z, dp[a][c]);
        dp[a][c] = fmaf(ga.w, vv[c].w, dp[a][c]);
      }
    }
  }
}

// P and dS of the thread's (row, key) pairs: i0 / j0 are the tiles' first
// query row and key, lse_s / dl_s the tile's rows' lse and Delta
__device__ __forceinline__ void probs(float (&s)[kRpt][4],
                                      float (&dp)[kRpt][4], const float* lse_s,
                                      const float* dl_s, int ty, int tx,
                                      int i0, int j0, int Sq, int Sk,
                                      int causal, float scale) {
  const int offset = Sk - Sq;
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
    const int r = ty * kRpt + a;
    const int row = i0 + r;
    const float lse = lse_s[r];
    const float dl = dl_s[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = j0 + tx + 16 * c;
      const bool ok =
          row < Sq && key < Sk && (!causal || key <= row + offset);
      const float p = ok ? expf(fmaf(s[a][c], scale, -lse)) : 0.f;
      s[a][c] = p;
      dp[a][c] = p * (dp[a][c] - dl);
    }
  }
}

// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int D) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const float* orow = o + row * D;
  const float* grow = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(orow[d], grow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + kPad) + 2 * kB * kLdP + 2 * kB);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int H,
                int Hkv, int Sq, int Sk, int causal, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kVec = D / 16 < 4 ? D / 16 : 4;
  constexpr int kNch = D / 16 / kVec;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kB][kLd]
  float* Vs = Ks + kB * kLd;
  float* Qs = Vs + kB * kLd;
  float* dOs = Qs + kB * kLd;
  float* Ps = dOs + kB * kLd;   // [kB rows][kLdP keys]
  float* dSs = Ps + kB * kLdP;  // [kB rows][kLdP keys]
  float* lse_s = dSs + kB * kLdP;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int group = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y - b * Hkv;
  const int j0 = blockIdx.x * kB;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + kvh) * Sk;
  load_tile<D>(Ks, k + kv_base * D, j0, Sk);
  load_tile<D>(Vs, v + kv_base * D, j0, Sk);

  // the first query row that sees key j0
  const int i_first = causal ? max(0, j0 - (Sk - Sq)) : 0;
  const int i_start = (i_first / kB) * kB;

  float acc_k[kRpt][D / 16], acc_v[kRpt][D / 16];
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      acc_k[a][c] = 0.f;
      acc_v[a][c] = 0.f;
    }
  }

  for (int g = 0; g < group; ++g) {
    const int64_t row_base =
        (static_cast<int64_t>(b) * H + kvh * group + g) * Sq;
    for (int i0 = i_start; i0 < Sq; i0 += kB) {
      __syncthreads();  // the last tile's Qs, dOs, Ps, dSs are read
      load_tile<D>(Qs, q + row_base * D, i0, Sq);
      load_tile<D>(dOs, dout + row_base * D, i0, Sq);
      if (tid < kB) {
        const bool live = i0 + tid < Sq;
        lse_s[tid] = live ? lse[row_base + i0 + tid] : kLseEmpty;
        dl_s[tid] = live ? delta[row_base + i0 + tid] : 0.f;
      }
      __syncthreads();
      float s[kRpt][4], dp[kRpt][4];
      scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
      probs(s, dp, lse_s, dl_s, ty, tx, i0, j0, Sq, Sk, causal, scale);
#pragma unroll
      for (int a = 0; a < kRpt; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty * kRpt + a) * kLdP + tx + 16 * c] = s[a][c];
          dSs[(ty * kRpt + a) * kLdP + tx + 16 * c] = dp[a][c];
        }
      }
      __syncthreads();
      // dV[key] += P[row, key] dO[row], dK[key] += dS[row, key] Q[row]
      // over the tile's rows; the thread's keys ty * 4 + a
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + r * kLdP + ty * kRpt);
        const float4 d4 =
            *reinterpret_cast<const float4*>(dSs + r * kLdP + ty * kRpt);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int n = 0; n < kNch; ++n) {
          float gv[kVec], qv[kVec];
          load_vec<kVec>(dOs + r * kLd + (tx + 16 * n) * kVec, gv);
          load_vec<kVec>(Qs + r * kLd + (tx + 16 * n) * kVec, qv);
#pragma unroll
          for (int a = 0; a < kRpt; ++a) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              acc_v[a][n * kVec + e] =
                  fmaf(pa[a], gv[e], acc_v[a][n * kVec + e]);
              acc_k[a][n * kVec + e] =
                  fmaf(da[a], qv[e], acc_k[a][n * kVec + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
    const int key = j0 + ty * kRpt + a;
    if (key >= Sk) continue;
    float* krow = dk + (kv_base + key) * D;
    float* vrow = dv + (kv_base + key) * D;
#pragma unroll
    for (int n = 0; n < kNch; ++n) {
      float kv[kVec], vv[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        kv[e] = acc_k[a][n * kVec + e] * scale;
        vv[e] = acc_v[a][n * kVec + e];
      }
      store_vec<kVec>(krow + (tx + 16 * n) * kVec, kv);
      store_vec<kVec>(vrow + (tx + 16 * n) * kVec, vv);
    }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kB * (D + kPad) + kB * kLdP + 2 * kB);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
              int causal, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kVec = D / 16 < 4 ? D / 16 : 4;
  constexpr int kNch = D / 16 / kVec;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kB][kLd]
  float* dOs = Qs + kB * kLd;
  float* Ks = dOs + kB * kLd;
  float* Vs = Ks + kB * kLd;
  float* dSs = Vs + kB * kLd;  // [kB rows][kLdP keys]
  float* lse_s = dSs + kB * kLdP;
  float* dl_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int group = H / Hkv;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kvh = h / group;
  const int i0 = blockIdx.x * kB;
  const int64_t row_base = (static_cast<int64_t>(b) * H + h) * Sq;
  const int64_t kv_base = (static_cast<int64_t>(b) * Hkv + kvh) * Sk;
  load_tile<D>(Qs, q + row_base * D, i0, Sq);
  load_tile<D>(dOs, dout + row_base * D, i0, Sq);
  if (tid < kB) {
    const bool live = i0 + tid < Sq;
    lse_s[tid] = live ? lse[row_base + i0 + tid] : kLseEmpty;
    dl_s[tid] = live ? delta[row_base + i0 + tid] : 0.f;
  }
  // keys the tile's rows see: up to its last row's diagonal
  const int last = min(i0 + kB, Sq) - 1;
  const int kv_end = causal ? min(Sk, last + (Sk - Sq) + 1) : Sk;

  float acc[kRpt][D / 16];
#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[a][c] = 0.f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += kB) {
    __syncthreads();  // Qs, dOs, lse written; the last tile's Ks, dSs read
    load_tile<D>(Ks, k + kv_base * D, j0, Sk);
    load_tile<D>(Vs, v + kv_base * D, j0, Sk);
    __syncthreads();
    float s[kRpt][4], dp[kRpt][4];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs(s, dp, lse_s, dl_s, ty, tx, i0, j0, Sq, Sk, causal, scale);
#pragma unroll
    for (int a = 0; a < kRpt; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty * kRpt + a) * kLdP + tx + 16 * c] = dp[a][c];
    }
    // a row's dS is written and read by the 16 lanes of one half-warp
    __syncwarp();
    // dQ[row] += dS[row, key] K[key] over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kB; j += 4) {
      float4 d4[kRpt];
#pragma unroll
      for (int a = 0; a < kRpt; ++a)
        d4[a] = *reinterpret_cast<const float4*>(dSs + (ty * kRpt + a) * kLdP +
                                                 j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < kNch; ++n) {
          float kv[kVec];
          load_vec<kVec>(Ks + (j + u) * kLd + (tx + 16 * n) * kVec, kv);
#pragma unroll
          for (int a = 0; a < kRpt; ++a) {
            const float ds = u == 0   ? d4[a].x
                             : u == 1 ? d4[a].y
                             : u == 2 ? d4[a].z
                                      : d4[a].w;
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[a][n * kVec + e] = fmaf(ds, kv[e], acc[a][n * kVec + e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRpt; ++a) {
    const int row = i0 + ty * kRpt + a;
    if (row >= Sq) continue;
    float* qrow = dq + (row_base + row) * D;
#pragma unroll
    for (int n = 0; n < kNch; ++n) {
      float o[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = acc[a][n * kVec + e] * scale;
      store_vec<kVec>(qrow + (tx + 16 * n) * kVec, o);
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* delta, float* dq,
           float* dk, float* dv, int B, int H, int Hkv, int Sq, int Sk,
           int causal, cudaStream_t stream, int* launched) {
  const float scale = 1.0f / std::sqrt(static_cast<float>(D));
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), kThreads, 0,
                     stream>>>(o, dout, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;

  auto kv_kern = bwd_dkdv_kernel<D>;
  constexpr size_t kv_smem = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(kv_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<dim3((Sk + kB - 1) / kB, B * Hkv), kThreads, kv_smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Hkv, Sq, Sk, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++*launched;

  auto q_kern = bwd_dq_kernel<D>;
  constexpr size_t q_smem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(q_kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  q_kern<<<dim3((Sq + kB - 1) / kB, B * H), kThreads, q_smem, stream>>>(
      q, k, v, dout, lse, delta, dq, H, Hkv, Sq, Sk, causal, scale);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

}  // namespace

// Gradients of attention (see the top of this file). Every pointer is a
// contiguous f32 tensor on one device, 16-byte aligned: q, o, dout, dq
// [B, H, Sq, D]; k, v, dk, dv [B, Hkv, Sk, D]; lse and delta (a workspace
// the kernel overwrites) [B, H, Sq]. *launched (a host int) is set to the
// number of kernels launched (3 when all went). Returns cudaGetLastError()
// after the last launch, or cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int64_t B, int64_t H, int64_t Hkv,
                                   int64_t Sq, int64_t Sk, int64_t D,
                                   int causal, void* stream, int* launched) {
  bool bad = B < 1 || Hkv < 1 || H < Hkv || H % Hkv || Sq < 1 || Sk < 1 ||
             (D != 16 && D != 32 && D != 64 && D != 128) ||
             B * Hkv > 65535 || B * H > 65535 || Sq > (int64_t{1} << 30) ||
             Sk > (int64_t{1} << 30);
  for (const void* p : {q, k, v, o, dout, lse, static_cast<const void*>(delta),
                        static_cast<const void*>(dq),
                        static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    bad = bad || reinterpret_cast<uintptr_t>(p) % 16 != 0;
  *launched = 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), sq = static_cast<int>(Sq),
            sk = static_cast<int>(Sk);
  switch (D) {
    case 16:
      return launch<16>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(delta),
                        w(dq), w(dk), w(dv), b, h, hkv, sq, sk, causal, s,
                        launched);
    case 32:
      return launch<32>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(delta),
                        w(dq), w(dk), w(dv), b, h, hkv, sq, sk, causal, s,
                        launched);
    case 64:
      return launch<64>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(delta),
                        w(dq), w(dk), w(dv), b, h, hkv, sq, sk, causal, s,
                        launched);
    default:
      return launch<128>(f(q), f(k), f(v), f(o), f(dout), f(lse), w(delta),
                         w(dq), w(dk), w(dv), b, h, hkv, sq, sk, causal, s,
                         launched);
  }
}

// Blocked GQA attention with an online softmax (forward), for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py :
//           flash_attention_bhsd (Pallas body _flash_kernel).
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[b, h / G, j]
//   with G = H / Hkv query heads per KV head, fp32 math whatever the load
//   type (f32 or bf16), the output in the type of q. Causal masking keeps
//   key j for query row i when j <= i + (Sk - Sq): the bottom-right
//   diagonal, so Sq = 1 over a cache of Sk keys sees every key. Masked
//   scores are -1e30 and take no weight; a row with no key left (causal,
//   Sk < Sq) has denominator 0, taken as 1, and is written as 0.
//
// Bound on the H100 at the main path's shapes (fastwarc_lm, D = 64, f32):
//   prefill, q [8, 12, 1024, 64], k/v [8, 4, 1024, 64], causal: half of
//   4 B H Sq Sk D = 12.9 GFLOP against 67 MB, so the fp32 CUDA cores
//   (67 TFLOP/s) bound it at ~0.19 ms; decode, q [8, 12, 1, 64] over
//   Sk <= 1024 cached keys: 16.8 MB of K/V and 2 flops a byte, so device
//   memory (3.35 TB/s) bounds it at ~5 us.
//
// Design. The Pallas grid walks the KV blocks as its innermost, sequential
// grid axis and carries the running max, denominator and accumulator in
// VMEM from step to step. Blocks of a CUDA grid run in no order, so here
// one thread block owns a tile of query rows and loops over the KV tiles
// itself:
//   * GQA: a block serves query rows of one (batch, KV head) pair. Its rows
//     are taken from the group's G * Sq "virtual" rows (row g is query
//     head kvh * G + g / Sq at position g % Sq), so every K/V tile a block
//     loads from device memory serves all the group's heads that fall in
//     its tile. For decode (G * Sq <= 16) one block of 16 rows covers the
//     whole group: each K/V tile is read once per group, not once per
//     query head, and no 64-row tile is wasted on a single query row.
//   * Tiles: 64 keys of K and V per step in shared memory, converted to
//     fp32 as they are loaded (16-byte loads for f32, 8-byte for bf16,
//     all of a thread's loads of a tile in flight at once);
//     the query tile (pre-scaled by 1/sqrt(D)) stays in shared memory for
//     the whole loop. Rows are padded by 4 floats so the float4 reads of
//     a quarter-warp hit distinct banks.
//   * Registers: 256 threads as 16 x 16; thread (ty, tx) computes the
//     scores of its RPT rows (ty * RPT + a) against keys tx + 16 c
//     (c = 0..3) with float4 reads of Q and K, 16 FMAs per 8 shared loads
//     per d-step of 4. Row max and row sum reduce over the 16 lanes of a
//     half-warp with shuffles; the running max, denominator and the
//     thread's D / 16 output columns of each of its rows stay in
//     registers. P goes through shared memory to the P V product.
//   * Causal: KV tiles wholly above the diagonal of the block's last row
//     are never loaded; the diagonal tile is masked per element, as are
//     keys past Sk and rows past the group's last row (ragged Sq, Sk need
//     no padding).
//   * The output is written once, after the last tile.
// A simple kernel: no tensor cores, no TMA or cp.async pipelining, no
// split of long KV ranges across blocks; those are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBc = 64;        // keys per KV tile
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int D, int RPT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * RPT * (D + kPad) + 2 * kBc * (D + kPad) +
                          16 * RPT * (kBc + kPad));
}

// q/k/v strides are in elements (batch, head, sequence); the last axis is
// contiguous. out is a contiguous [B, H, Sq, D] tensor.
template <int D, int RPT, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H,
                 int Hkv, int Sq, int Sk, int causal, float scale,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                 int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                 int64_t v_ss) {
  constexpr int kBr = 16 * RPT;     // query rows per block
  constexpr int kLd = D + kPad;     // row stride of Qs, Ks, Vs (floats)
  constexpr int kLdP = kBc + kPad;  // row stride of Ps
  constexpr int kC = D / 4;         // float4 chunks per row
  constexpr int kNch = D / 64;      // float4 output chunks per thread
  constexpr int kLoads = kBc * kC / kThreads;  // K (and V) float4s a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBr][kLd]
  float* Ks = Qs + kBr * kLd;                   // [kBc][kLd]
  float* Vs = Ks + kBc * kLd;                   // [kBc][kLd]
  float* Ps = Vs + kBc * kLd;                   // [kBr][kLdP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int group = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y - b * Hkv;
  const int rows = group * Sq;  // virtual rows of this (batch, KV head)
  const int g0 = blockIdx.x * kBr;
  const int offset = Sk - Sq;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  // the query tile, scaled, fp32; rows past the group's last are zero
  for (int i = tid; i < kBr * kC; i += kThreads) {
    const int r = i / kC;
    const int c = i - r * kC;
    const int g = g0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < rows) {
      const int h = kvh * group + g / Sq;
      const int pos = g - (g / Sq) * Sq;
      val = load4(q + b * q_sb + h * q_sh + pos * q_ss + c * 4);
      val.x *= scale;
      val.y *= scale;
      val.z *= scale;
      val.w *= scale;
    }
    store4(Qs + r * kLd + c * 4, val);
  }

  int pos_a[RPT];
  bool live_a[RPT];
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    const int g = g0 + ty * RPT + a;
    live_a[a] = g < rows;
    pos_a[a] = live_a[a] ? g - (g / Sq) * Sq : 0;
  }
  // keys the block needs: up to the diagonal of its last position
  const int g_last = min(g0 + kBr, rows) - 1;
  const int max_pos = (g0 / Sq != g_last / Sq) ? Sq - 1 : g_last % Sq;
  const int kv_end = causal ? min(Sk, max_pos + offset + 1) : Sk;

  float m[RPT], l[RPT], acc[RPT][kNch][4];
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int n = 0; n < kNch; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][n][e] = 0.f;
    }
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBc) {
    // every load of the tile is issued before the first store, so a
    // tile costs one device-memory latency, not kLoads of them
    float4 kr[kLoads], vr[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      const int key = k0 + i / kC;
      const int c = i % kC;
      kr[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      vr[u] = kr[u];
      if (key < Sk) {
        kr[u] = load4(kb + key * k_ss + c * 4);
        vr[u] = load4(vb + key * v_ss + c * 4);
      }
    }
    __syncthreads();  // Qs written; the last tile's Ks, Vs, Ps read
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      store4(Ks + (i / kC) * kLd + (i % kC) * 4, kr[u]);
      store4(Vs + (i / kC) * kLd + (i % kC) * 4, vr[u]);
    }
    __syncthreads();

    // S = (Q scale) K^T: rows ty * RPT + a, keys tx + 16 c
    float s[RPT][4];
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 kq[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kq[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * kLd + d);
#pragma unroll
      for (int a = 0; a < RPT; ++a) {
        const float4 qa =
            *reinterpret_cast<const float4*>(Qs + (ty * RPT + a) * kLd + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qa.x, kq[c].x, s[a][c]);
          s[a][c] = fmaf(qa.y, kq[c].y, s[a][c]);
          s[a][c] = fmaf(qa.z, kq[c].z, s[a][c]);
          s[a][c] = fmaf(qa.w, kq[c].w, s[a][c]);
        }
      }
    }

    // mask, then the online softmax update of each row
#pragma unroll
    for (int a = 0; a < RPT; ++a) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        ok[c] = key < Sk && (!causal || key <= pos_a[a] + offset);
        if (!ok[c]) s[a][c] = kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
      float* prow = Ps + (ty * RPT + a) * kLdP;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[a][c] - m_new) : 0.f;
        prow[tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int n = 0; n < kNch; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] *= corr;
      }
    }
    // a row's P is written and read by the 16 lanes of one half-warp
    __syncwarp();

    // O += P V: the thread's rows, float4 columns tx + 16 n
#pragma unroll 4
    for (int j = 0; j < kBc; j += 4) {
      float4 pa[RPT];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
        pa[a] = *reinterpret_cast<const float4*>(Ps + (ty * RPT + a) * kLdP + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int n = 0; n < kNch; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (j + u) * kLd + (tx + 16 * n) * 4);
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const float p = comp(pa[a], u);
            acc[a][n][0] = fmaf(p, vv.x, acc[a][n][0]);
            acc[a][n][1] = fmaf(p, vv.y, acc[a][n][1]);
            acc[a][n][2] = fmaf(p, vv.z, acc[a][n][2]);
            acc[a][n][3] = fmaf(p, vv.w, acc[a][n][3]);
          }
        }
      }
    }
  }

  // one write of the output; a row with no key has l == 0 -> 1 -> zeros
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    if (!live_a[a]) continue;
    const int g = g0 + ty * RPT + a;
    const int h = kvh * group + g / Sq;
    const float denom = l[a] == 0.f ? 1.f : l[a];
    T* orow = out + ((static_cast<int64_t>(b) * H + h) * Sq + pos_a[a]) * D;
#pragma unroll
    for (int n = 0; n < kNch; ++n) {
      store4(orow + (tx + 16 * n) * 4,
             make_float4(acc[a][n][0] / denom, acc[a][n][1] / denom,
                         acc[a][n][2] / denom, acc[a][n][3] / denom));
    }
  }
}

template <int D, int RPT, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int Sq, int Sk, int causal, const int64_t* st,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, RPT, T>;
  constexpr size_t smem = smem_bytes<D, RPT>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (H / Hkv) * Sq;
  const dim3 grid((rows + 16 * RPT - 1) / (16 * RPT), B * Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Sq, Sk, causal,
      1.0f / std::sqrt(static_cast<float>(D)), st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int Sq, int Sk, int D, int causal,
             const int64_t* st, cudaStream_t stream) {
  // a group's rows fit one 16-row block (decode): that shape; else 64 rows
  const bool small = (H / Hkv) * Sq <= 16;
  if (D == 64) {
    return small ? launch<64, 1, T>(q, k, v, out, B, H, Hkv, Sq, Sk, causal,
                                    st, stream)
                 : launch<64, 4, T>(q, k, v, out, B, H, Hkv, Sq, Sk, causal,
                                    st, stream);
  }
  return small ? launch<128, 1, T>(q, k, v, out, B, H, Hkv, Sq, Sk, causal,
                                   st, stream)
               : launch<128, 4, T>(q, k, v, out, B, H, Hkv, Sq, Sk, causal,
                                   st, stream);
}

}  // namespace

// q [B, H, Sq, D], k/v [B, Hkv, Sk, D] with element strides (batch, head,
// sequence) in strides[0..2], [3..5], [6..8] and a contiguous last axis;
// out a contiguous [B, H, Sq, D]. dtype 0 = float32, 1 = bfloat16 (all four
// tensors alike). D is 64 or 128; H a multiple of Hkv. Every pointer is
// 16-byte aligned (f32) or 8-byte aligned (bf16) and every stride a
// multiple of 4. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int64_t B,
                                   int64_t H, int64_t Hkv, int64_t Sq,
                                   int64_t Sk, int64_t D, int dtype,
                                   int causal, const int64_t* strides,
                                   void* stream) {
  const int64_t align = dtype == 0 ? 16 : 8;
  bool bad = B < 1 || Hkv < 1 || H < Hkv || H % Hkv || Sq < 1 || Sk < 1 ||
             (D != 64 && D != 128) || (dtype != 0 && dtype != 1) ||
             B * Hkv > 65535 || (H / Hkv) * Sq > (int64_t{1} << 30) ||
             Sk > (int64_t{1} << 30);
  for (int i = 0; i < 9; ++i) bad = bad || strides[i] % 4 != 0;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    bad = bad || reinterpret_cast<uintptr_t>(p) % align != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch<float>(q, k, v, out, static_cast<int>(B),
                               static_cast<int>(H), static_cast<int>(Hkv),
                               static_cast<int>(Sq), static_cast<int>(Sk),
                               static_cast<int>(D), causal, strides, s)
             : dispatch<__nv_bfloat16>(
                   q, k, v, out, static_cast<int>(B), static_cast<int>(H),
                   static_cast<int>(Hkv), static_cast<int>(Sq),
                   static_cast<int>(Sk), static_cast<int>(D), causal, strides,
                   s);
}

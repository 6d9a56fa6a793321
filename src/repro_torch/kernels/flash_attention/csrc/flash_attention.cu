// Blocked GQA attention with an online softmax (forward), for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py :
//           flash_attention_bhsd (Pallas body _flash_kernel).
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[b, h / G, j]
//   with G = H / Hkv query heads per KV head, fp32 softmax and accumulation
//   whatever the load type (f32 or bf16), the output in the type of q, and
//   D one of 16, 32, 64, 128. Causal masking keeps key j for query row i
//   when j <= i + (Sk - Sq): the bottom-right diagonal, so Sq = 1 over a
//   cache of Sk keys sees every key. Masked scores take no weight; a row
//   with no key left (causal, Sk < Sq) has denominator 0 and is written as 0.
//
// GQA rows. Every path works on the G * Sq "virtual" query rows of one
// (batch, KV head) pair: row g is query head kvh * G + g / Sq at position
// g % Sq. So every K/V tile a block brings in serves all the group's heads
// that fall in its rows, and decode (Sq = 1) fills a tile with the group's
// G heads instead of one query row.
//
// Three paths, chosen by the C entry point from shape and type
// (pick_path). Times below: H100 80GB HBM3 at 700 W, chip_smoke.py's
// phase 4 and tools/flash_decode_splits.py (CUDA events, L2 flushed by
// zeroing).
//
// B1. Split-KV decode (G * Sq <= 16): CUDA cores in f32, tensor cores in
//   bf16.
//   Bound: device memory. Decode reads every cached key and value once
//   (fastwarc_lm, q [8, 12, 1, 64] over 1,000 keys: 16.4 MB, ~5 us at
//   3.35 TB/s). One block a (batch, KV head) left 32 blocks on 132 SMs,
//   each walking its whole cache alone. Here the key range [0, Sk) is cut
//   into n_splits chunks of whole 64-key tiles, as even as tiles allow
//   (n_splits chosen by the wrapper from the shape and type), grid
//   (n_splits, B * Hkv). Each block writes its rows' running max m,
//   denominator l and unnormalised accumulator (f32) to a workspace the
//   wrapper allocates; the kernel allocates nothing. The last block of a
//   (batch, KV head) to finish (__threadfence, then an atomicAdd on a
//   per-pair counter in a zeroed int32 workspace, which that block sets
//   back to 0) merges the partials in split order, so the output is the
//   same bit for bit from run to run; a split with no live key (l = 0)
//   adds nothing. One launch a call, strided cache views as they are.
//   f32 (flash_decode_kernel): ~2 flops a byte, and TF32 keeps too few
//   digits (see B3), so the products stay on the CUDA cores. A key row is
//   read in 16-byte chunks by neighbouring threads straight into
//   registers, the next step's rows in flight under this step's work; the
//   query rows stay in registers (padded to 4 or 16); each warp runs its
//   own online softmax over its keys, the warps' partials merged at the
//   end.
//   bf16 (flash_decode_tc_kernel): at GQA group 8 the CUDA-core loop was
//   bound by instruction issue, not bytes (16 rows a warp: every score a
//   5-step shuffle reduction; Qwen3-30B-A3B's q [8, 32, 1, 128] over
//   1,024 keys took 0.0403 ms against SDPA's 0.0203). Here the block's
//   G * Sq rows, padded to 16, are the A operand of mma.sync.m16n8k16 (Q
//   loaded once into registers); a producer warp keeps 4 K and V tiles in
//   flight by TMA (B2's tensor maps and swizzle) in a ring with full and
//   empty mbarriers; each of 4 consumer warps takes 16 keys
//   of every tile: S = Q K^T from K by ldmatrix (two accumulator chains
//   over D), the online softmax on the accumulator fragments (B2's), P
//   rounded to bf16 and reused in registers as the A operand of O += P V
//   from V by ldmatrix.trans, O in f32 registers. The splits' merge issues
//   the loads of all a thread's items and of 4 splits together (item by
//   item it took 0.0226 ms at 4 splits, against 0.0197 unsplit). Qwen3's
//   decode then reads at the rate SDPA does: 0.0197 / 0.0196 / 0.0201 ms
//   at 1 / 2 / 4 splits (SDPA 0.0199); 6 stages in place of 4: 0.0204.
//   Past 32 to 64 blocks more splits only add merges (q [8, 16, 1, 128]
//   over 2,000 keys: 0.0385 ms unsplit, 0.0397 at 2 splits; q [1, 32, 1,
//   128] over 32,768 keys: 0.0504 / 0.0448 / 0.0478 ms at 8 / 16 / 32
//   splits), so the wrapper splits bf16 to fewer than 64 blocks.
//
// B2. Tensor-core prefill (bf16, G * Sq > 16): wgmma and TMA.
//   Bound: bf16 tensor-core operations (InternLM2-1.8B, q [1, 16, 2048,
//   128], k/v [1, 8, 2048, 128], causal: 17.2 GFLOP, ~17 us at 989
//   TFLOP/s; Qwen3-30B-A3B, q [8, 32, 1024, 128], k/v [8, 4, 1024, 128]:
//   68.8 GFLOP, 0.0696 ms). One warpgroup (128 threads) owns 64 virtual
//   rows. Q is read once, straight from device memory into registers in
//   the A-operand order of wgmma (D / 16 k16 fragments a thread: 4 to 32
//   registers), so Q K^T reads only K from shared memory (a ragged Sq
//   tile can straddle two heads, which a TMA box could not gather anyway). K and V tiles of
//   64 keys come in by TMA, issued by one thread, into one K and one V
//   buffer with an mbarrier each; a buffer is refilled as soon as every
//   warp is done with it, so the next K tile lands under this tile's
//   softmax and P V and the next V tile under the next Q K^T, and a block
//   takes at most 33 KB of shared memory. The tensor maps describe the
//   strided [B, Hkv, Sk, D] views (no copy) and reach the kernel as
//   __grid_constant__ parameters. Per tile:
//     S = Q K^T   wgmma m64n64k16, Q from registers, K K-major in shared
//                 memory, D / 16 steps;
//     softmax     on the f32 accumulator fragment in registers: thread t
//                 of warp w holds rows 16 w + t / 4 (+ 8), columns
//                 8 j + 2 (t % 4) (+ 1); the causal and Sk masks are
//                 computed per register on the tiles that need them; the
//                 row max and sum reduce over the 4 lanes of a row; one
//                 FFMA and one ex2.approx an element;
//     O += P V    P rounded to bf16 in registers, in the A-operand order of
//                 wgmma (the accumulator fragment of two 8-key chunks is
//                 one 16-key A fragment), wgmma m64nDk16 with A from
//                 registers and V as the MN-major (transposed) B operand
//                 straight from the TMA tile.
//   Timed on the H100 at InternLM2-1.8B's shape while this design was
//   chosen, each of these was slower: Q in swizzled shared memory (both
//   wgmma operands there), 2-stage K/V rings (fewer blocks an SM at
//   D = 128), two warpgroups sharing each tile, and a software pipeline
//   running the next tile's Q K^T under this tile's softmax.
//   Also timed and rejected, at D = 128: a warp-specialised kernel (a
//   block of 128 virtual rows; one producer thread issuing TMA into a
//   ring of K and V tiles with full and empty mbarriers, setmaxnreg
//   giving the producer warpgroup's registers to two consumer warpgroups
//   of 64 rows that share every tile; per tile a consumer issued
//   S_j = Q K_j^T and O += P_{j-1} V_{j-1} together, waited for S_j only
//   (wgmma.wait_group 1) and ran S_j's softmax under the running P V;
//   named barriers passed the turn to issue between the two consumers,
//   ping-pong; no block barrier in the key loop; 168 registers a launch,
//   setmaxnreg 24 / 240, no spills). At Qwen3-30B-A3B's prefill (2,048
//   blocks, 15.5 waves of one block an SM) it took 0.2605 ms against
//   this kernel's 0.2124 (SDPA 0.1572); 64-key tiles in 2 / 4 stages
//   0.2831 / 0.2872, 128-key tiles in 3 stages 0.2615, no ping-pong
//   0.2693. InternLM2-1.8B's (256 blocks) 0.0513 against 0.0505. It won
//   only on one-wave grids whose keys fill several tiles (group 8,
//   q [1, 16, 1000, 128]: 0.0269 against 0.0302, a shape no model's
//   main path gives) and lost below that (Sk of 100 to 200: 0.0151 /
//   0.0164 / 0.0167 against 0.0115 / 0.0123 / 0.0136). With one block an
//   SM each block's start (Q's loads, the first tile's TMA) and end are
//   exposed, which this kernel hides under its two other blocks on the
//   SM; a persistent grid that starts a block's next row tile under the
//   last one's tail is the next design to try.
//   Shared-memory layout, by D: a K-major bf16 row of D elements is one
//   swizzle atom row of 32 (D = 16, SW32), 64 (D = 32, SW64) or 128 bytes
//   (D = 64, SW128), or two SW128 atom columns (D = 128); the TMA maps use
//   the same swizzle, and the wgmma descriptors the same layout type,
//   with SBO = 8 rows of the atom and, for V, LBO = one 64-key atom column.
//   Row tiles run heaviest first (most keys under the causal mask).
//   f32 accumulators throughout; rows with no key are written as 0.
//
// B3. CUDA-core prefill (f32, G * Sq > 16).
//   Bound: the fp32 CUDA cores (fastwarc_lm, q [8, 12, 1024, 64], k/v
//   [8, 4, 1024, 64], causal: 12.9 GFLOP, ~0.19 ms at 67 TFLOP/s). TF32
//   tensor cores keep about three decimal digits, too few for the LM's
//   2e-4 parity with the CPU forward, so f32 stays on CUDA cores. One
//   block of 256 threads (16 x 16) owns 64 virtual rows and loops over
//   64-key tiles of K and V converted to fp32 in shared memory (rows padded
//   by 4 floats so float4 reads of a quarter-warp hit distinct banks); the
//   scaled query tile stays in shared memory. Thread (ty, tx) computes the
//   scores of its RPT rows against keys tx + 16 c; row max and sum reduce
//   over a half-warp with shuffles; the running max, denominator and the
//   thread's D / 16 output columns of each row stay in registers (a float4
//   chunk for D >= 64, two or one columns for D = 32, 16); P goes through
//   shared memory to the P V product. KV tiles wholly above the diagonal
//   of the block's last row are never loaded. For training, a sibling
//   entry (flash_attention_fwd_lse) runs this path on any f32 shape and
//   also writes each row's log-sum-exp m + log l ([B, H, Sq] f32; 1e30
//   on a row with no key), which the backward in flash_attention_bwd.cu
//   recomputes the probabilities from; the serve entry passes no lse.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;  // CUDA-core paths B1, B3 (B3 as 16 x 16)
constexpr int kBc = 64;        // keys per KV tile, every path
constexpr int kPad = 4;        // floats of padding per shared-memory row
constexpr int kDecodeRows = 16;
constexpr float kNegInf = -1e30f;
constexpr float kLseEmpty = 1e30f;  // lse of a row with no key

// ---------------------------------------------------------------------------
// CUDA-core paths (B1, B3)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// N (1, 2 or 4) consecutive output values
template <int N>
__device__ __forceinline__ void store_out(float* p, const float* v) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// N consecutive floats of shared memory
template <int N>
__device__ __forceinline__ void load_smem(const float* p, float* v) {
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

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

constexpr int kRpt = 4;  // B3: rows a thread, 64 a block

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * kRpt * (D + kPad) + 2 * kBc * (D + kPad) +
                          16 * kRpt * (kBc + kPad));
}

// B3. q/k/v strides are in elements (batch, head, sequence); the last
// axis is contiguous. out is a contiguous [B, H, Sq, D] tensor, lse a
// contiguous [B, H, Sq] or null. Grid (row tiles, B * Hkv); every key up
// to the block's diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H,
                 int Hkv, int Sq, int Sk, int causal, float scale,
                 int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                 int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                 int64_t v_ss) {
  constexpr int RPT = kRpt;
  constexpr int kBr = 16 * RPT;     // query rows per block
  constexpr int kLd = D + kPad;     // row stride of Qs, Ks, Vs (floats)
  constexpr int kLdP = kBc + kPad;  // row stride of Ps
  constexpr int kC = D / 4;         // float4 chunks per row
  constexpr int kCols = D / 16;     // output columns a thread owns per row
  constexpr int kVec = kCols < 4 ? kCols : 4;  // ... in chunks of kVec
  constexpr int kNch = kCols / kVec;
  constexpr int kLoads = kBc * kC / kThreads;  // K (and V) float4s a thread
  static_assert(kLoads * kThreads == kBc * kC, "D must be 16, 32, 64, 128");
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
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  // the query tile, scaled; rows past the group's last are zero
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

  float m[RPT], l[RPT], acc[RPT][kCols];
#pragma unroll
  for (int a = 0; a < RPT; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
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
        ok[c] = key < kv_end && (!causal || key <= pos_a[a] + offset);
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
      for (int c = 0; c < kCols; ++c) acc[a][c] *= corr;
    }
    // a row's P is written and read by the 16 lanes of one half-warp
    __syncwarp();

    // O += P V: the thread's rows, columns (tx + 16 n) * kVec + e
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
          float vv[kVec];
          load_smem<kVec>(Vs + (j + u) * kLd + (tx + 16 * n) * kVec, vv);
#pragma unroll
          for (int a = 0; a < RPT; ++a) {
            const float p = comp(pa[a], u);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              acc[a][n * kVec + e] = fmaf(p, vv[e], acc[a][n * kVec + e]);
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
    const float inv = 1.f / (l[a] == 0.f ? 1.f : l[a]);
    const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + pos_a[a];
    float* orow = out + row * D;
#pragma unroll
    for (int n = 0; n < kNch; ++n) {
      float o[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = acc[a][n * kVec + e] * inv;
      store_out<kVec>(orow + (tx + 16 * n) * kVec, o);
    }
    // m and l are the same in the row's 16 lanes
    if (lse != nullptr && tx == 0)
      lse[row] = l[a] == 0.f ? kLseEmpty : m[a] + logf(l[a]);
  }
}

// ---------------------------------------------------------------------------
// B1: split-KV decode
// ---------------------------------------------------------------------------

constexpr int kDecWarps = kThreads / 32;

// Floats of one split's partial in the B1 workspace: m[16], l[16],
// acc[16][D].
template <int D>
__host__ __device__ constexpr int partial_floats() {
  return kDecodeRows * (D + 2);
}

// a 16-byte chunk of an f32 row
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[4]) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}

// four output values in the output's type
__device__ __forceinline__ void store_chunk(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

// shared memory of the decode kernel: the warps' accumulators, merged at
// the end
template <int D, int MR>
constexpr size_t dec_smem_bytes() {
  return sizeof(float) * kDecWarps * MR * D;
}

// Grid (n_splits, B * Hkv): the block owns all G * Sq <= MR rows of its
// (batch, KV head) and the 64-key tiles [split * tiles / n_splits,
// (split + 1) * tiles / n_splits) of the keys. A key row is read in
// chunks of 16 bytes (4 f32 values) by neighbouring threads, so a warp
// reads whole rows, coalesced, from device memory into registers. The
// block walks its keys in steps of 4 keys a key lane; the next step's K
// and V rows are requested before this step's are used. Each warp keeps its own online softmax over its
// keys, in registers: the scores (a chunk's dot products with the rows'
// query chunks, reduced over the key's threads by shuffles), the row max
// and sum over the warp's key lanes (shuffles), and each thread's chunk of
// P V over its key lane's keys. No block barrier until the end, where the
// 8 warps' partials (max, sum, accumulator) are merged through shared
// memory. ws and counters are the wrapper's workspace (unused when
// n_splits == 1).
template <int D, int MR>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int H,
                    int Hkv, int Sq, int Sk, int causal, float scale,
                    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                    int64_t v_ss, int tiles, float* __restrict__ ws,
                    int* __restrict__ counters) {
  constexpr int kE = 4;                    // elements a chunk
  constexpr int kTPK = D / kE;             // threads a key row
  constexpr int kLanes = kThreads / kTPK;  // key lanes of the block
  constexpr int kStep = 4 * kLanes;        // keys a step
  using Raw = uint4;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // [kDecWarps][MR][D]
  __shared__ float wm[kDecWarps][MR], wl[kDecWarps][MR];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = tid % kTPK;   // the thread's chunk: columns kE c ..
  const int kl = tid / kTPK;  // its key lane
  const int group = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y - b * Hkv;
  const int rows = group * Sq;
  const int offset = Sk - Sq;
  const float* kb = k + b * k_sb + kvh * k_sh + c * kE;
  const float* vb = v + b * v_sb + kvh * v_sh + c * kE;
  const int64_t sp = blockIdx.x, n_splits = gridDim.x;
  const int kv_lo = static_cast<int>(sp * tiles / n_splits) * kBc;
  const int kv_hi =
      min(Sk, static_cast<int>((sp + 1) * tiles / n_splits) * kBc);

  // the query chunks of every row, scaled; dead rows zero
  float qr[MR][kE];
  int pos_g[MR];
#pragma unroll
  for (int g = 0; g < MR; ++g) {
    Raw raw{};
    pos_g[g] = g < rows ? g % Sq : 0;
    if (g < rows) {
      const int h = kvh * group + g / Sq;
      raw = *reinterpret_cast<const Raw*>(q + b * q_sb + h * q_sh +
                                          pos_g[g] * q_ss + c * kE);
    }
    unpack(raw, qr[g]);
#pragma unroll
    for (int e = 0; e < kE; ++e) qr[g][e] *= scale;
  }
  // the warp's running max and sum of each row, and the thread's chunk of
  // the row's accumulator over its key lane's keys
  float m_w[MR], l_w[MR], acc[MR][kE];
#pragma unroll
  for (int g = 0; g < MR; ++g) {
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  // the thread's chunks of the step at k0: keys k0 + kl + u kLanes
  Raw kr[4], vr[4], kn[4], vn[4];
  auto fetch = [&](Raw (&kx)[4], Raw (&vx)[4], int k0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int key = k0 + kl + u * kLanes;
      kx[u] = vx[u] = Raw{};
      if (key < kv_hi) {
        kx[u] = *reinterpret_cast<const Raw*>(kb + key * k_ss);
        vx[u] = *reinterpret_cast<const Raw*>(vb + key * v_ss);
      }
    }
  };
  fetch(kr, vr, kv_lo);
  for (int k0 = kv_lo; k0 < kv_hi; k0 += kStep) {
    fetch(kn, vn, k0 + kStep);  // the next step's rows (none past kv_hi)
    // every lane reaches the shuffles: rows is the block's
#pragma unroll
    for (int g = 0; g < MR; ++g) {
      if (g >= rows) break;
      float sc[4];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kf[kE];
        unpack(kr[u], kf);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int o = 1; o < kTPK; o <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        const int key = k0 + kl + u * kLanes;
        const bool live =
            key < kv_hi && (!causal || key <= pos_g[g] + offset);
        sc[u] = live ? d : kNegInf;
        mx = fmaxf(mx, sc[u]);
      }
      // the max and sum over the warp's key lanes
#pragma unroll
      for (int o = kTPK; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_w[g], mx);
      // a row with no live key yet keeps m = -1e30: its p and corr are 0
      const float m_use = m_new == kNegInf ? 0.f : m_new;
      const float corr = expf(m_w[g] - m_use);
      m_w[g] = m_new;
      float p[4], ps = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p[u] = expf(sc[u] - m_use);
        ps += p[u];
      }
#pragma unroll
      for (int o = kTPK; o < 32; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l_w[g] = l_w[g] * corr + ps;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vf[kE];
        unpack(vr[u], vf);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[g][e] = fmaf(p[u], vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // the warp's partial: its key lanes summed by shuffles, into shared
  // memory
#pragma unroll
  for (int g = 0; g < MR; ++g) {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
#pragma unroll
      for (int o = kTPK; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  if (lane < kTPK) {
#pragma unroll
    for (int g = 0; g < MR; ++g) {
#pragma unroll
      for (int e = 0; e < kE; e += 4)
        store_out<4>(red + (warp * MR + g) * D + c * kE + e, acc[g] + e);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MR; ++g) {
      wm[warp][g] = m_w[g];
      wl[warp][g] = l_w[g];
    }
  }
  __syncthreads();
  // item i < rows * kTPK (thread i % 256) merges the warps for row
  // i / kTPK, chunk i % kTPK: the block's max, sum and accumulator
  constexpr int kItems = (MR * kTPK + kThreads - 1) / kThreads;  // 1 or 2
  float o[kItems][kE], l_it[kItems], m_it[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads;
    const int g = i / kTPK, cc = i % kTPK;
#pragma unroll
    for (int e = 0; e < kE; ++e) o[it][e] = 0.f;
    l_it[it] = 0.f;
    m_it[it] = kNegInf;
    if (i < rows * kTPK) {
      float mm = kNegInf;
      for (int w = 0; w < kDecWarps; ++w)
        if (wl[w][g] > 0.f) mm = fmaxf(mm, wm[w][g]);
      for (int w = 0; w < kDecWarps; ++w) {
        // a warp with no live key (l = 0) adds nothing
        const float ww = wl[w][g] > 0.f ? expf(wm[w][g] - mm) : 0.f;
        l_it[it] = fmaf(wl[w][g], ww, l_it[it]);
        const float* x = red + (w * MR + g) * D + cc * kE;
#pragma unroll
        for (int e = 0; e < kE; ++e) o[it][e] = fmaf(x[e], ww, o[it][e]);
      }
      m_it[it] = mm;
    }
  }

  if (n_splits > 1) {
    // this split's partial, then the last block of the pair merges all
    float* p0 = ws + static_cast<int64_t>(blockIdx.y) * n_splits *
                         partial_floats<D>();
    float* part = p0 + sp * partial_floats<D>();
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads;
      const int g = i / kTPK, cc = i % kTPK;
      if (i >= rows * kTPK) continue;
      if (cc == 0) {
        part[g] = m_it[it];
        part[kDecodeRows + g] = l_it[it];
      }
#pragma unroll
      for (int e = 0; e < kE; e += 4)
        store_out<4>(part + 2 * kDecodeRows + g * D + cc * kE + e,
                     o[it] + e);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      s_last = atomicAdd(counters + blockIdx.y, 1) == n_splits - 1;
      // every block of the pair has counted: leave the counter zeroed
      // for the next launch
      if (s_last) counters[blockIdx.y] = 0;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // every partial (L2 reads: other blocks wrote them): first the largest
    // max of the splits that saw a key, then the weighted sums in split
    // order; no load waits on another, so they are all in flight at once
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kThreads;
      const int g = i / kTPK, cc = i % kTPK;
      if (i >= rows * kTPK) continue;
      float mm = kNegInf, ll = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_splits; ++s) {
        const float* ps = p0 + s * partial_floats<D>();
        if (__ldcg(ps + kDecodeRows + g) > 0.f)
          mm = fmaxf(mm, __ldcg(ps + g));
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) o[it][e] = 0.f;
#pragma unroll 4
      for (int s = 0; s < n_splits; ++s) {
        const float* ps = p0 + s * partial_floats<D>();
        const float ls = __ldcg(ps + kDecodeRows + g);
        // a split with no live key (l = 0) adds nothing
        const float w = ls > 0.f ? expf(__ldcg(ps + g) - mm) : 0.f;
        ll = fmaf(ls, w, ll);
#pragma unroll
        for (int e = 0; e < kE; e += 4) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(
              ps + 2 * kDecodeRows + g * D + cc * kE + e));
          o[it][e] = fmaf(x.x, w, o[it][e]);
          o[it][e + 1] = fmaf(x.y, w, o[it][e + 1]);
          o[it][e + 2] = fmaf(x.z, w, o[it][e + 2]);
          o[it][e + 3] = fmaf(x.w, w, o[it][e + 3]);
        }
      }
      l_it[it] = ll;
    }
  }
  // a row with no key has l == 0 and is written as 0
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kThreads;
    const int g = i / kTPK, cc = i % kTPK;
    if (i >= rows * kTPK) continue;
    const float inv = l_it[it] == 0.f ? 0.f : 1.f / l_it[it];
    const int h = kvh * group + g / Sq;
#pragma unroll
    for (int e = 0; e < kE; ++e) o[it][e] *= inv;
    store_chunk(out + ((static_cast<int64_t>(b) * H + h) * Sq + g % Sq) * D +
                    cc * kE,
                o[it]);
  }
}

// ---------------------------------------------------------------------------
// Hopper primitives (B2): shared-memory addresses, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase `parity` has completed. A wait that never
// completes (a faulting TMA copy) traps after ~10^10 cycles (seconds), so
// the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 10000000000LL) {
      __trap();
    }
  }
}

// bring a tensor map (a __grid_constant__ parameter) into the TMA unit's
// cache ahead of its first use
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// one TMA tile of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until every committed wgmma group has finished
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// named barrier `id` over n threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; .trans delivers each transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate: thread t
// holds c rows t / 4 (c[0], c[1]) and t / 4 + 8 (c[2], c[3]), columns
// 2 (t % 4) (+ 1)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), layout type (1 = SW128, 2 = SW64, 3 = SW32)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// d[64 x 64] = a[64 x 16] b[16 x 64] (+ d when scale_d): a in registers,
// b K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 16] += a[64 x 16] b[16 x 16]: a in registers, b MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += a[64 x 16] b[16 x 32]: a in registers, b MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += a[64 x 16] b[16 x 64]: a in registers, b MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 16] b[16 x 128]: a in registers, b MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 16) {
    wgmma_rs_n16(d, a, db);
  } else if constexpr (D == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Tile geometry of the tensor-core path for head dim D.
template <int D>
struct Tc {
  static constexpr int kRows = 64;                    // rows a block
  static constexpr int kAtomElems = D < 64 ? D : 64;  // a swizzle-atom row
  static constexpr int kRowBytes = 2 * kAtomElems;    // 32, 64, 128
  static constexpr int kAtoms = D / kAtomElems;       // atom columns: 1, 2
  static constexpr uint32_t kLayout =                 // wgmma layout type
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kSbo = 8 * kRowBytes;     // 8 rows of an atom
  static constexpr uint32_t kAtomCol = kBc * kRowBytes;  // 64 rows of it
  static constexpr int kTileBytes = kBc * D * 2;  // one K (or V) tile
  // one K tile and one V tile, then their two barriers; 1024 bytes of
  // slack to align the swizzled tiles to their swizzle pattern
  static constexpr size_t kSmem = 1024 + 2 * kTileBytes + 2 * 8;
};

// K (or V) tile `tile` of (batch b, KV head kvh) into dst, completing on bar
template <int D>
__device__ __forceinline__ void issue_tile(const CUtensorMap* map,
                                           uint8_t* dst, uint64_t* bar,
                                           int tile, int kvh, int b) {
  using C = Tc<D>;
  mbar_expect_tx(bar, C::kTileBytes);
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
    tma_load_4d(dst + a * C::kAtomCol, map, bar, a * C::kAtomElems,
                tile * kBc, kvh, b);
}

// s = Q K^T for one 64-key tile (Q from registers, K K-major in shared
// memory), issued and committed
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32],
                                         const uint32_t (&qf)[D / 16][4],
                                         uint32_t k_addr) {
  using C = Tc<D>;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
    const uint32_t col = (t * 16) / C::kAtomElems * C::kAtomCol +
                         (t * 16) % C::kAtomElems * 2;
    wgmma_rs_n64_k(s, qf[t],
                   make_desc(k_addr + col, 16, C::kSbo, C::kLayout), t > 0);
  }
  wgmma_commit();
}

// o += P V for one 64-key tile (P from registers, V MN-major), committed
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t v_addr) {
  using C = Tc<D>;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kBc / 16; ++t)
    wgmma_pv<D>(o, pa[t], make_desc(v_addr + t * 16 * C::kRowBytes,
                                    C::kAtomCol, C::kSbo, C::kLayout));
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile in registers: mask (on tiles that
// need it), update the running max m (in score units) and this thread's
// share of the row sums l, turn the scores into P = 2^(s c - m c) in place
// (c = log2(e) / sqrt(D), one FFMA an element) and return the factor the
// accumulator must be rescaled by. The fragment is that of wgmma's m64n64
// accumulator (N = 32) or of two m16n8 mma.sync tiles (N = 8): thread t
// of warp w holds rows 16 w + t / 4 (+ 8) (rows t / 4 (+ 8) for mma.sync)
// and keys k0 + 8 j + 2 (t % 4) (+ 1). Keys from Sk on are masked.
template <int N>
__device__ __forceinline__ void softmax_scores(
    float (&s)[N], float (&m_r)[2], float (&l_r)[2], float (&corr)[2],
    int k0, bool masked, int Sk, int causal, const int (&pos_h)[2],
    int offset, int lane, float scale_log2) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = (i >> 1) & 1;
    if (masked) {
      const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (key >= Sk || (causal && key > pos_h[h] + offset)) s[i] = kNegInf;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
  float m_c[2];  // the max in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // a row with no live key yet keeps m = -1e30: its p and corr are 0
    m_c[h] = mx[h] == kNegInf ? 0.f : mx[h] * scale_log2;
    corr[h] = fast_exp2(fmaf(m_r[h], scale_log2, -m_c[h]));
    m_r[h] = mx[h];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int h = (i >> 1) & 1;
    s[i] = fast_exp2(fmaf(s[i], scale_log2, -m_c[h]));
    s[i + 1] = fast_exp2(fmaf(s[i + 1], scale_log2, -m_c[h]));
    sum[h] += s[i] + s[i + 1];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * corr[h] + sum[h];
}

// P rounded to bf16 as N / 8 k16 A fragments (the accumulator fragment of
// two 8-key chunks is one 16-key A fragment, for wgmma and mma.sync alike)
template <int N>
__device__ __forceinline__ void pack_p(const float (&p)[N],
                                       uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N; i += 2)
    pa[i >> 3][(i >> 1) & 3] = pack_bf16(p[i], p[i + 1]);
}

// B2: grid (B * Hkv, row tiles of 64 rows); one warpgroup of 128 threads.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tmap_k,
                    const __grid_constant__ CUtensorMap tmap_v,
                    const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ out, int H, int Hkv, int Sq,
                    int Sk, int causal, float scale_log2, int64_t q_sb,
                    int64_t q_sh, int64_t q_ss) {
  using C = Tc<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* Ks = base;  // a K tile [kAtoms][64 keys][kRowBytes], swizzled
  uint8_t* Vs = Ks + C::kTileBytes;  // a V tile, the same
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + C::kTileBytes);
  uint64_t* full_v = full_k + 1;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = H / Hkv;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x - b * Hkv;
  const int rows = group * Sq;
  const int offset = Sk - Sq;
  // the block's rows, heaviest tiles first
  const int g0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;
  const int g_last = min(g0 + C::kRows, rows) - 1;
  const bool straddle = g0 / Sq != g_last / Sq;
  const int max_pos = straddle ? Sq - 1 : g_last % Sq;
  const int min_pos = straddle ? 0 : g0 % Sq;
  const int kv_end = causal ? min(Sk, max_pos + offset + 1) : Sk;
  const int n_tiles = kv_end > 0 ? (kv_end + kBc - 1) / kBc : 0;
  // keys below this are live for every row of the block: no mask needed
  const int open_end = causal ? min(Sk, min_pos + offset + 1) : Sk;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) mbar_init(full_k + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {  // the first K and V tiles
    issue_tile<D>(&tmap_k, Ks, full_k, 0, kvh, b);
    issue_tile<D>(&tmap_v, Vs, full_v, 0, kvh, b);
  }

  // this thread's two rows of the accumulator fragments
  const int r0 = 16 * warp + (lane >> 2);
  int pos_h[2];
  bool live_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = g0 + r0 + 8 * h;
    live_h[h] = g < rows;
    pos_h[h] = live_h[h] ? g % Sq : 0;
  }
  float o_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  float s[32], corr[2];
  uint32_t pa[4][4];  // P as four k16 A fragments
  // Q as D / 16 k16 A fragments in registers: rows r0, r0 + 8, keys
  // 16 t + 2 (lane % 4) (+ 1) and + 8
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e & 1;
      const int col = 16 * t + 8 * (e >> 1) + 2 * (lane & 3);
      qf[t][e] = 0u;
      if (live_h[h]) {
        const int g = g0 + r0 + 8 * h;
        const int head = kvh * group + g / Sq;
        qf[t][e] = *reinterpret_cast<const uint32_t*>(
            q + b * q_sb + head * q_sh + pos_h[h] * q_ss + col);
      }
    }
  }
  const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);

  for (int j = 0; j < n_tiles; ++j) {
    const int ph = j & 1;
    mbar_wait(full_k, ph);
    issue_qk<D>(s, qf, k_addr);
    wgmma_wait();
    fence_regs(s);
    fence_regs(qf);
    __syncthreads();  // K tile j read by every warp: the buffer refills
    if (tid == 0 && j + 1 < n_tiles)
      issue_tile<D>(&tmap_k, Ks, full_k, j + 1, kvh, b);
    const int k0 = j * kBc;
    softmax_scores(s, m_r, l_r, corr, k0, k0 + kBc > open_end, Sk, causal,
                   pos_h, offset, lane, scale_log2);
    pack_p(s, pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] *= corr[(i >> 1) & 1];
    mbar_wait(full_v, ph);
    issue_pv<D>(o_acc, pa, v_addr);
    wgmma_wait();
    fence_regs(o_acc);
    fence_regs(pa);
    __syncthreads();  // V tile j read by every warp: the buffer refills
    if (tid == 0 && j + 1 < n_tiles)
      issue_tile<D>(&tmap_v, Vs, full_v, j + 1, kvh, b);
  }

  // the row sums over the 4 lanes of a row, then one write of the output
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live_h[h]) continue;
    const int g = g0 + r0 + 8 * h;
    const int head = kvh * group + g / Sq;
    const float inv = l_r[h] == 0.f ? 0.f : 1.f / l_r[h];
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * H + head) * Sq + pos_h[h]) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c + 2 * (lane & 3)) =
          __floats2bfloat162_rn(o_acc[4 * c + 2 * h] * inv,
                                o_acc[4 * c + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// B1, bf16: split-KV decode on tensor cores (mma.sync, TMA ring)
// ---------------------------------------------------------------------------

constexpr int kDecTcWarps = 4;  // consumer warps: 16 keys of each tile each
constexpr int kDecTcStages = 4;  // K/V tiles in flight (6 was slower)


template <int D>
struct DecTc {
  static constexpr int kConsumers = 32 * kDecTcWarps;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kStage = 2 * Tc<D>::kTileBytes;  // a K, then a V tile
  static constexpr int kRing = kDecTcStages * kStage;
  // the consumer warps' accumulators [warps][16 rows][D], merged at the end
  static constexpr int kRed = 4 * kDecTcWarps * kDecodeRows * D;
  // the ring, the accumulators, a full and an empty barrier a stage; 1024
  // bytes of slack to align the swizzled tiles
  static constexpr size_t kSmem = 1024 + kRing + kRed + 2 * kDecTcStages * 8;
};

// Shared-memory address of element (row, col) of a bf16 tile as TMA
// writes it in Tc<D>'s layout: atom columns of kAtomElems, and the 16-byte
// chunks of each 128-byte line XORed with the line's index mod 8 (SW128),
// mod 4 (SW64) or mod 2 (SW32). tile is 1024-byte aligned.
template <int D>
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int col) {
  using C = Tc<D>;
  constexpr uint32_t kMask = C::kRowBytes / 16 - 1;
  const uint32_t off = (col / C::kAtomElems) * C::kAtomCol +
                       row * C::kRowBytes + (col % C::kAtomElems) * 2;
  return tile + (off ^ (((off >> 7) & kMask) << 4));
}

// Grid (n_splits, B * Hkv), as the f32 decode: the block owns all
// G * Sq <= 16 rows of its (batch, KV head), padded to the 16 rows of an
// mma.sync A operand, and the 64-key tiles [split * tiles / n_splits,
// (split + 1) * tiles / n_splits). Warp 4 is the producer: one thread
// keeps kDecTcStages K and V tiles in flight by TMA, refilling a stage
// when the four consumer warps have released it. Consumer warp w takes
// keys 16 w .. 16 w + 15 of every tile: S = Q K^T (K by ldmatrix), the
// online softmax on the accumulator fragments, P rounded to bf16 and
// reused from registers as the A operand of O += P V (V by
// ldmatrix.trans), O in f32 registers. The four warps' partials merge
// through shared memory at the end; the splits merge in the last block of
// the pair, in split order, as in the f32 decode. ws and counters are the
// wrapper's workspace (unused when n_splits == 1). The ring leaves room
// for one or two blocks an SM; without the minimum of 1 in the launch
// bounds ptxas held D = 64 to 96 registers and spilled.
template <int D>
__global__ void __launch_bounds__(DecTc<D>::kThreads, 1)
flash_decode_tc_kernel(const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       const __nv_bfloat16* __restrict__ q,
                       __nv_bfloat16* __restrict__ out, int H, int Hkv,
                       int Sq, int Sk, int causal, float scale_log2,
                       int64_t q_sb, int64_t q_sh, int64_t q_ss, int tiles,
                       float* __restrict__ ws, int* __restrict__ counters) {
  using C = Tc<D>;
  using Dc = DecTc<D>;
  constexpr int NS = kDecTcStages;
  constexpr int kW = kDecTcWarps;
  constexpr int kCT = Dc::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  float* red = reinterpret_cast<float*>(base + Dc::kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Dc::kRing + Dc::kRed);
  uint64_t* empty = full + NS;
  __shared__ float wm[kW][kDecodeRows], wl[kW][kDecodeRows];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = H / Hkv;
  const int b = blockIdx.y / Hkv;
  const int kvh = blockIdx.y - b * Hkv;
  const int rows = group * Sq;
  const int offset = Sk - Sq;
  const int64_t sp = blockIdx.x, n_splits = gridDim.x;
  const int t_lo = static_cast<int>(sp * tiles / n_splits);
  const int n_tiles = static_cast<int>((sp + 1) * tiles / n_splits) - t_lo;
  const int kv_hi = min(Sk, (t_lo + n_tiles) * kBc);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 2);    // the K and the V tile's expect_tx
      mbar_init(empty + s, kW);  // every consumer warp done with it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kW) {  // the producer
    if (lane == 0) {
      prefetch_map(&tmap_k);
      prefetch_map(&tmap_v);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NS;
        if (j >= NS) mbar_wait(empty + s, (j / NS - 1) & 1);
        uint8_t* st = base + s * Dc::kStage;
        issue_tile<D>(&tmap_k, st, full + s, t_lo + j, kvh, b);
        issue_tile<D>(&tmap_v, st + C::kTileBytes, full + s, t_lo + j, kvh,
                      b);
      }
    }
    return;
  }

  // this thread's two rows of the fragments: t / 4 and t / 4 + 8
  const int r0 = lane >> 2;
  const int kk = 16 * warp;  // the warp's keys in each tile
  int pos_h[2];
  bool live_h[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = r0 + 8 * h;
    live_h[h] = g < rows;
    pos_h[h] = live_h[h] ? g % Sq : 0;
  }
  // Q as D / 16 k16 A fragments: rows r0 (+ 8), columns 16 t + 2 (t % 4)
  // (+ 1) and + 8; rows past the group's last are zero
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e & 1;
      const int col = 16 * t + 8 * (e >> 1) + 2 * (lane & 3);
      qf[t][e] = 0u;
      if (live_h[h]) {
        const int g = r0 + 8 * h;
        const int head = kvh * group + g / Sq;
        qf[t][e] = *reinterpret_cast<const uint32_t*>(
            q + b * q_sb + head * q_sh + pos_h[h] * q_ss + col);
      }
    }
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  float corr[2];
  // keys below this are live for every row (row 0 is at position 0)
  const int open_end = causal ? min(kv_hi, offset + 1) : kv_hi;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS;
    mbar_wait(full + s, (j / NS) & 1);
    const uint32_t kt = smem_u32(base + s * Dc::kStage);
    const uint32_t vt = kt + C::kTileBytes;
    // two m16n8 tiles (keys kk .. kk + 7, kk + 8 .. kk + 15), each summed
    // over D in two chains (even and odd k16 steps) to halve the latency
    float sc[8], sc2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = sc2[i] = 0.f;
#pragma unroll
    for (int t = 0; t < D / 16; ++t) {
      uint32_t kf[4];
      ldsm_x4(kf, swz<D>(kt, kk + (lane & 7) + ((lane >> 4) << 3),
                         16 * t + ((lane >> 3) & 1) * 8));
      float* acc = t & 1 ? sc2 : sc;
      mma_bf16(acc, qf[t], kf[0], kf[1]);
      mma_bf16(acc + 4, qf[t], kf[2], kf[3]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] += sc2[i];
    const int k0 = (t_lo + j) * kBc;
    softmax_scores(sc, m_r, l_r, corr, k0 + kk, k0 + kBc > open_end, kv_hi,
                   causal, pos_h, offset, lane, scale_log2);
    uint32_t pa[1][4];
    pack_p(sc, pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int u = 0; u < D / 16; ++u) {
      uint32_t vf[4];
      ldsm_x4_t(vf, swz<D>(vt, kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                           16 * u + (lane >> 4) * 8));
      mma_bf16(o + 8 * u, pa[0], vf[0], vf[1]);
      mma_bf16(o + 8 * u + 4, pa[0], vf[2], vf[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // the stage may refill
  }

  // the warp's partial: the row sums over the 4 lanes of a row, then the
  // max, sum and accumulator into shared memory
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(
          red + (warp * kDecodeRows + r0 + 8 * h) * D + 8 * n +
          2 * (lane & 3)) = make_float2(o[4 * n + 2 * h], o[4 * n + 2 * h + 1]);
    }
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wm[warp][r0 + 8 * h] = m_r[h];
      wl[warp][r0 + 8 * h] = l_r[h];
    }
  }
  bar_sync(1, kCT);
  // item i < rows * D / 4 (consumer thread i % kCT) merges the warps for
  // row i / (D / 4), columns 4 (i % (D / 4)) .. + 3
  constexpr int kC4 = D / 4;
  constexpr int kItems = (kDecodeRows * kC4 + kCT - 1) / kCT;
  float ob[kItems][4], l_it[kItems], m_it[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kCT;
    const int g = i / kC4, cc = i % kC4;
#pragma unroll
    for (int e = 0; e < 4; ++e) ob[it][e] = 0.f;
    l_it[it] = 0.f;
    m_it[it] = kNegInf;
    if (g < rows) {
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < kW; ++w)
        if (wl[w][g] > 0.f) mm = fmaxf(mm, wm[w][g]);
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        // a warp with no live key (l = 0) adds nothing
        const float ww = wl[w][g] > 0.f
                             ? fast_exp2((wm[w][g] - mm) * scale_log2)
                             : 0.f;
        l_it[it] = fmaf(wl[w][g], ww, l_it[it]);
        const float4 x = *reinterpret_cast<const float4*>(
            red + (w * kDecodeRows + g) * D + 4 * cc);
        ob[it][0] = fmaf(x.x, ww, ob[it][0]);
        ob[it][1] = fmaf(x.y, ww, ob[it][1]);
        ob[it][2] = fmaf(x.z, ww, ob[it][2]);
        ob[it][3] = fmaf(x.w, ww, ob[it][3]);
      }
      m_it[it] = mm;
    }
  }

  if (n_splits > 1) {
    // this split's partial, then the last block of the pair merges all
    float* p0 = ws + static_cast<int64_t>(blockIdx.y) * n_splits *
                         partial_floats<D>();
    float* part = p0 + sp * partial_floats<D>();
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int i = tid + it * kCT;
      const int g = i / kC4, cc = i % kC4;
      if (g >= rows) continue;
      if (cc == 0) {
        part[g] = m_it[it];
        part[kDecodeRows + g] = l_it[it];
      }
      store_out<4>(part + 2 * kDecodeRows + g * D + 4 * cc, ob[it]);
    }
    __threadfence();
    bar_sync(1, kCT);
    if (tid == 0) {
      s_last = atomicAdd(counters + blockIdx.y, 1) == n_splits - 1;
      // every block of the pair has counted: leave the counter zeroed
      // for the next launch
      if (s_last) counters[blockIdx.y] = 0;
    }
    bar_sync(1, kCT);
    if (!s_last) return;
    __threadfence();
    // every partial (L2 reads: other blocks wrote them): first the largest
    // max of the splits that saw a key, then the weighted sums in split
    // order. The loads of all the thread's items and of 4 splits are
    // issued together (rows past the last read row rows - 1's partial and
    // are not written), so each pass waits for the L2 a few times only.
    float mm[kItems], ll[kItems];
    int gi[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      gi[it] = min((tid + it * kCT) / kC4, rows - 1);
      mm[it] = kNegInf;
      ll[it] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) ob[it][e] = 0.f;
    }
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {
      const float* ps = p0 + s * partial_floats<D>();
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const float ls = __ldcg(ps + kDecodeRows + gi[it]);
        const float ms = __ldcg(ps + gi[it]);
        if (ls > 0.f) mm[it] = fmaxf(mm[it], ms);
      }
    }
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) {
      const float* ps = p0 + s * partial_floats<D>();
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int cc = (tid + it * kCT) % kC4;
        const float ls = __ldcg(ps + kDecodeRows + gi[it]);
        const float ms = __ldcg(ps + gi[it]);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            ps + 2 * kDecodeRows + gi[it] * D + 4 * cc));
        // a split with no live key (l = 0) adds nothing
        const float w =
            ls > 0.f ? fast_exp2((ms - mm[it]) * scale_log2) : 0.f;
        ll[it] = fmaf(ls, w, ll[it]);
        ob[it][0] = fmaf(x.x, w, ob[it][0]);
        ob[it][1] = fmaf(x.y, w, ob[it][1]);
        ob[it][2] = fmaf(x.z, w, ob[it][2]);
        ob[it][3] = fmaf(x.w, w, ob[it][3]);
      }
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) l_it[it] = ll[it];
  }
  // a row with no key has l == 0 and is written as 0
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tid + it * kCT;
    const int g = i / kC4, cc = i % kC4;
    if (g >= rows) continue;
    const float inv = l_it[it] == 0.f ? 0.f : 1.f / l_it[it];
    const int h = kvh * group + g / Sq;
#pragma unroll
    for (int e = 0; e < 4; ++e) ob[it][e] *= inv;
    store_chunk(out + ((static_cast<int64_t>(b) * H + h) * Sq + g % Sq) * D +
                    4 * cc,
                ob[it]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over the strided [B, Hkv, Sk, D] bf16 view: boxes of
// (atom columns of D) x 64 keys, swizzled as the wgmma layout expects,
// keys past Sk zero-filled.
template <int D>
bool encode_kv_map(CUtensorMap* map, const void* ptr, int B, int Hkv, int Sk,
                   const int64_t* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Sk),
                              static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {Tc<D>::kAtomElems, kBc, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Tc<D>::kRowBytes == 128
                                     ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Tc<D>::kRowBytes == 64
                                     ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int H, int Hkv, int Sq, int Sk, int causal, const int64_t* st,
              cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!encode_kv_map<D>(&tk, k, B, Hkv, Sk, st + 3) ||
      !encode_kv_map<D>(&tv, v, B, Hkv, Sk, st + 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = flash_fwd_tc_kernel<D>;
  constexpr size_t smem = Tc<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (H / Hkv) * Sq;
  const dim3 grid(B * Hkv, (rows + Tc<D>::kRows - 1) / Tc<D>::kRows);
  const float scale_log2 =
      1.4426950408889634f / std::sqrt(static_cast<float>(D));
  kern<<<grid, 128, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), H, Hkv, Sq, Sk, causal, scale_log2,
      st[0], st[1], st[2]);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_cc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
              const int64_t* st, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = (H / Hkv) * Sq;
  const dim3 grid((rows + 16 * kRpt - 1) / (16 * kRpt), B * Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, H, Hkv, Sq,
      Sk, causal, 1.0f / std::sqrt(static_cast<float>(D)), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int MR>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  int B, int H, int Hkv, int Sq, int Sk, int causal,
                  const int64_t* st, int n_splits, void* ws, void* counters,
                  cudaStream_t stream) {
  auto kern = flash_decode_kernel<D, MR>;
  constexpr size_t smem = dec_smem_bytes<D, MR>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_splits, B * Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, Sq, Sk,
      causal, 1.0f / std::sqrt(static_cast<float>(D)), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], (Sk + kBc - 1) / kBc,
      static_cast<float*>(ws), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_decode_tc(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Sk, int causal,
                     const int64_t* st, int n_splits, void* ws,
                     void* counters, cudaStream_t stream) {
  CUtensorMap tk, tv;
  if (!encode_kv_map<D>(&tk, k, B, Hkv, Sk, st + 3) ||
      !encode_kv_map<D>(&tv, v, B, Hkv, Sk, st + 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kern = flash_decode_tc_kernel<D>;
  constexpr size_t smem = DecTc<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_splits, B * Hkv);
  const float scale_log2 =
      1.4426950408889634f / std::sqrt(static_cast<float>(D));
  kern<<<grid, DecTc<D>::kThreads, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), H, Hkv, Sq, Sk, causal, scale_log2,
      st[0], st[1], st[2], (Sk + kBc - 1) / kBc, static_cast<float*>(ws),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// The paths, as the entry point numbers them (flash_attention.py's PATHS).
enum Path : int {
  kDecodeF32 = 0,  // B1, f32: CUDA cores
  kDecodeTc = 1,   // B1, bf16: mma.sync
  kPrefillTc = 2,  // B2
  kPrefillCc = 3,  // B3
};

// The path of a call, from its shape and type.
int pick_path(int64_t H, int64_t Hkv, int64_t Sq, int dtype, bool lse) {
  if (lse) return kPrefillCc;
  if ((H / Hkv) * Sq <= kDecodeRows)
    return dtype == 0 ? kDecodeF32 : kDecodeTc;
  return dtype == 0 ? kPrefillCc : kPrefillTc;
}

template <int D>
int dispatch_d(int path, const void* q, const void* k, const void* v,
               void* out, float* lse, int B, int H, int Hkv, int Sq, int Sk,
               int causal, const int64_t* st, int n_splits, void* ws,
               void* counters, cudaStream_t s) {
  switch (path) {
    case kDecodeF32:
      // rows a block owns, padded: 4 (a decode step of G <= 4 heads) or 16
      return (H / Hkv) * Sq <= 4
                 ? launch_decode<D, 4>(q, k, v, out, B, H, Hkv, Sq, Sk,
                                       causal, st, n_splits, ws, counters, s)
                 : launch_decode<D, kDecodeRows>(q, k, v, out, B, H, Hkv, Sq,
                                                 Sk, causal, st, n_splits, ws,
                                                 counters, s);
    case kDecodeTc:
      return launch_decode_tc<D>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, st,
                                 n_splits, ws, counters, s);
    case kPrefillTc:
      return launch_tc<D>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, st, s);
    default:
      return launch_cc<D>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal, st,
                          s);
  }
}

}  // namespace

// q [B, H, Sq, D], k/v [B, Hkv, Sk, D] with element strides (batch, head,
// sequence) in strides[0..2], [3..5], [6..8] and a contiguous last axis;
// out a contiguous [B, H, Sq, D]. dtype 0 = float32, 1 = bfloat16 (all four
// tensors alike). D is 16, 32, 64 or 128; H a multiple of Hkv. Pointers
// are 16-byte aligned and strides multiples of 16 bytes (4 f32 or 8 bf16
// values): every path reads rows in 16-byte chunks, the bf16 paths' K and
// V by TMA.
// On return *path holds the path launched (one of Path).
// The decode paths split the keys n_splits ways (1 <= n_splits <=
// ceil(Sk / 64)); for n_splits > 1, ws holds B * Hkv * n_splits * 16 *
// (D + 2) floats and counters B * Hkv zeroed int32s, which the launch
// leaves zeroed (launches sharing them must be stream-ordered).
// lse is null on the serve path. Non-null (f32 only) it is a contiguous
// [B, H, Sq] f32 that the f32 prefill path (B3), taken then on any shape,
// fills with each row's log-sum-exp of its scaled scores, m + log l (1e30
// on a row with no key), for the backward (flash_attention_bwd.cu).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int64_t B, int64_t H, int64_t Hkv,
                                   int64_t Sq, int64_t Sk, int64_t D,
                                   int dtype, int causal,
                                   const int64_t* strides, int64_t n_splits,
                                   void* ws, void* counters, int* path,
                                   void* stream) {
  const int64_t stride_mult = dtype == 0 ? 4 : 8;  // 16 bytes
  bool bad = B < 1 || Hkv < 1 || H < Hkv || H % Hkv || Sq < 1 || Sk < 1 ||
             (D != 16 && D != 32 && D != 64 && D != 128) ||
             (dtype != 0 && dtype != 1) || (lse != nullptr && dtype != 0) ||
             B * Hkv > 65535 || (H / Hkv) * Sq > (int64_t{1} << 30) ||
             Sk > (int64_t{1} << 30) || ((H / Hkv) * Sq + 63) / 64 > 65535 ||
             path == nullptr;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const int p = pick_path(H, Hkv, Sq, dtype, lse != nullptr);
  if (p == kDecodeF32 || p == kDecodeTc) {
    const int64_t tiles = (Sk + kBc - 1) / kBc;
    bad = n_splits < 1 || n_splits > tiles ||
          (n_splits > 1 && (ws == nullptr || counters == nullptr));
  }
  for (int i = 0; i < 9; ++i) bad = bad || strides[i] % stride_mult != 0;
  for (const void* ptr : {q, k, v, static_cast<const void*>(out)})
    bad = bad || reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  *path = p;
  auto s = static_cast<cudaStream_t>(stream);
  auto l = static_cast<float*>(lse);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), sq = static_cast<int>(Sq),
            sk = static_cast<int>(Sk), ns = static_cast<int>(n_splits);
  switch (D) {
    case 16:
      return dispatch_d<16>(p, q, k, v, out, l, b, h, hkv, sq, sk, causal,
                            strides, ns, ws, counters, s);
    case 32:
      return dispatch_d<32>(p, q, k, v, out, l, b, h, hkv, sq, sk, causal,
                            strides, ns, ws, counters, s);
    case 64:
      return dispatch_d<64>(p, q, k, v, out, l, b, h, hkv, sq, sk, causal,
                            strides, ns, ws, counters, s);
    default:
      return dispatch_d<128>(p, q, k, v, out, l, b, h, hkv, sq, sk, causal,
                             strides, ns, ws, counters, s);
  }
}

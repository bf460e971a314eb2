// Blockwise causal / sliding-window attention (prefill) for Hopper, sm_90a,
// and its backward.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at line 105).  The TPU
// kernel is forward only; the backward here replaces the gradient that the
// JAX package takes by differentiating `models/layers.py:mha`.
//
// What bounds it on the H100: at prefill lengths (S <= a few hundred) the
// work is small either way; per (batch, head) it reads S*D values of each of
// Q, K, V, writes S*D, and does ~2*S^2*D flops under the causal mask, so it
// is bytes-bound below S ~ 150 and operations-bound above (at the tensor
// cores' rate).  The backward reads Q, K, V, O, dO and the row log-sum-exp,
// writes dQ, dK, dV, and does ~5*S^2*D flops under the mask (two products
// recomputed, three of the gradient): at the round's S = 136 it is bytes-
// and latency-bound.  Forward and backward each have two routes, chosen by
// the wrapper before the launch (`flash_attention_route`,
// `flash_attention_backward_route`): "mma" for bf16 with D in {64, 128,
// 256}, "fma" for everything else (f32, D = 32).
//
// Forward, mma route, `flash_attention_kernel_mma` (FlashAttention-2):
//   * grid (query tile of 64 rows, batch * head), 4 warps of 16 query rows.
//     S = Q K^T and O += P V on mma.sync m16n8k16 (bf16 operands by
//     ldmatrix from rows padded by 8 bf16, f32 accumulators); the online
//     softmax runs in f32 on the accumulator fragments, in base 2 (one
//     multiply by log2(e) / sqrt(D)); P is rounded to bf16 as the A
//     fragment of P V.  K/V tiles (64 keys, 32 at D = 256) come in by
//     cp.async, double-buffered; Q stays in shared memory and is read by
//     ldmatrix at every k-step, so at D = 256 a thread holds O's 128 f32
//     accumulators and a 16 x 32 score tile.
//   * the same key range and masks as the FMA route; a warp skips the key
//     tiles that none of its rows can see and masks only the tiles that
//     cross a causal, window or length edge.  A row with no visible key
//     writes zeros; the log-sum-exp is written in natural-log units.
//   * shared memory (64 + 4 * keys per tile) * (D + 8) * 2 bytes: 46 KB at
//     D = 64, 87 KB at D = 128, 101 KB at D = 256; the launcher raises the
//     dynamic limit once (a static flag) and allocates nothing.
//
// Forward, fma route, `flash_attention_kernel` (f32 FMA units):
//   * grid (query tile of BQ = 64 rows, batch * head).  The block loads its
//     Q tile once into shared memory (f32) and loops over key tiles of
//     BK = 32 rows, from the window's first key to the causal edge of its
//     last query row: tiles wholly masked are never loaded.
//   * queries are aligned to the end of the keys (qpos = i + Sk - Sq); the
//     logical Sq/Sk mask the ragged tail inside the kernel, so the caller
//     pads nothing.  GQA reads KV head h / G directly (no repeat).
//   * 4 threads own one query row: each computes 8 of the tile's 32 scores
//     (Q.K^T by FMAs from shared memory), the row max and sum are shuffles
//     among the 4, the probabilities go through shared memory, and each
//     thread accumulates D/4 output channels of P.V in registers.
//   * online softmax in f32; masked keys contribute exactly 0, so a row
//     with no visible key writes zeros and never NaN.
//   * optionally writes each row's log-sum-exp (f32, (B, H, Sq)) of the
//     scaled logits, which the backward needs; serving passes a null
//     pointer and writes nothing more.
//   * shared memory is (BQ + BK)(D + 1) + BK*D + BQ(BK + 1) floats:
//     41.6 KB at D = 64 and 137 KB at D = 256 (under the 227 KB a block
//     may use; above 48 KB it is requested with cudaFuncSetAttribute).
//
// Backward: two launches on one stream, no atomics, so its sums are
// deterministic.  P = exp(s*scale - lse) is recomputed from the forward's
// log-sum-exp under exactly the forward's masks; dS = P (dO.V^T - delta)
// with delta = rowsum(dO * O) in f32.  Two routes, chosen by the wrapper
// before the launch (`flash_attention_backward_route`):
//
// mma route (bf16, D in {64, 128, 256}), `flash_attention_bwd_*_kernel_mma`:
//   * all five products (S = Q K^T, dP = dO V^T, dQ += dS K, dV += P^T dO,
//     dK += dS^T Q) on tensor cores: mma.sync m16n8k16, bf16 operands,
//     f32 accumulators.  Operands come from shared memory by ldmatrix
//     (.trans where a product reads across rows: K, dO and Q as the
//     right-hand side of dQ, dV and dK); P and dS go from the accumulator
//     layout straight into the next product's A fragment, rounded to bf16
//     as FlashAttention does.  Rows are padded by 8 bf16 so that ldmatrix
//     has no bank conflicts.  Tiles are fed by cp.async, double-buffered.
//   * dQ kernel, grid (64 query rows, batch * head), 4 warps of 16 rows:
//     forms delta for its rows (an f32 scratch the second launch reads),
//     then walks the visible key tiles (32 keys at D = 256, else 64).
//     dQ's f32 accumulators take D / 2 registers a thread.
//   * dK/dV kernel, grid (64 key rows, batch * KV head): it loops over the
//     G query heads of its KV head and the query tiles (64 rows at D = 64,
//     else 32) that can see its keys, so the GQA sum is in registers, in a
//     fixed order.  4 warps of 16 key rows; at D = 256 each key group has
//     two warps, each holding dK and dV for one half of D (a full row of
//     both would need 256 f32 registers a thread, over the 255 limit); both
//     form S^T and dP^T.  244-246 registers a thread at D = 256, no spills
//     (`-Xptxas=-v`); shared memory 136 KB a block at D = 256.
//
// fma route (f32, or D = 32), `flash_attention_bwd_{dq,dkv}_kernel`:
//   * dQ kernel, grid (query tile of 64 rows, batch * head), 4 threads per
//     query row as in the forward: it first forms delta for its rows, then
//     walks the visible key tiles of 32 rows, computing 8 scores and 8
//     dO.V^T per thread, and accumulates dS.K in D/4 registers.
//   * dK/dV kernel, grid (key tile of 32 rows, batch * KV head), 8 threads
//     per key row: it loops over the G query heads of its KV head and the
//     query tiles of 64 rows that can see its keys, and accumulates dS^T.Q
//     and P^T.dO in 2 * D/8 registers.
//   * every product on f32 FMA units from shared memory (206 KB for dQ and
//     215 KB for dK/dV at D = 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NT = 256;  // 4 threads per query row
// backward's dK/dV kernel
constexpr int BKV = 32;  // key rows per block
constexpr int BQ2 = 64;  // query rows per inner tile
constexpr int TPR = 8;   // threads per key row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Sk, int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)(BQ + BK) * (D + 1) + (size_t)BK * D + (size_t)BQ * (BK + 1);
}

__host__ __device__ constexpr size_t smem_floats_dq(int D) {
  return (size_t)(2 * BQ + 2 * BK) * (D + 1) + (size_t)BQ * (BK + 1);
}

__host__ __device__ constexpr size_t smem_floats_dkv(int D) {
  return (size_t)(2 * BKV + 2 * BQ2) * (D + 1) + (size_t)2 * BKV * (BQ2 + 1) + 2 * BQ2;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       int H, int K, int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int NS = BK / 4;  // scores per thread per tile
  constexpr int NA = D / 4;   // output channels per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int off = Sk - Sq;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int qi = q0 + r;
  const int qpos = qi + off;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int row = q0 + rr;
    Qs[rr * DP + d] = row < Sq ? to_f(q[(((size_t)b * Sq + row) * H + h) * D + d]) : 0.f;
  }

  // keys any row of this tile can see
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_q + off + 1) : Sk;
  const int kbeg = window > 0 ? (int)max(0LL, (long long)q0 + off - window + 1) : 0;

  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int kt = kbeg; kt < kend; kt += BK) {
    __syncthreads();  // Q is loaded / the previous tile is consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const int kpos = kt + c;
      float kv = 0.f, vv = 0.f;
      if (kpos < Sk) {
        const size_t idx = (((size_t)b * Sk + kpos) * K + kvh) * D + d;
        kv = to_f(k[idx]);
        vv = to_f(v[idx]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * DP + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = fmaf(qv, Ks[(sub + 4 * j) * DP + d], s[j]);
    }

    bool ok[NS];
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      ok[j] = visible(kt + sub + 4 * j, qpos, Sk, causal, window);
      s[j] = ok[j] ? s[j] * scale : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      Ps[r * PP + sub + 4 * j] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
    __syncwarp();  // a row's 4 threads share one warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = Ps[r * PP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(p, Vs[c * D + sub + 4 * i], acc[i]);
    }
  }

  if (qi < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) o[sub + 4 * i] = from_f<T>(acc[i] / denom);
    if (lse != nullptr && sub == 0) lse[((size_t)b * H + h) * Sq + qi] = m + logf(denom);
  }
}

// dQ = scale * sum_j dS_ij K_j over the visible keys; also writes
// delta_i = sum_d dO_id O_id for the dK/dV launch.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ o,
                              const T* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ delta, T* __restrict__ dq, int H, int K, int Sq,
                              int Sk, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int NS = BK / 4;
  constexpr int NA = D / 4;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * DP;
  float* Ks = dOs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ds = Vs + BK * DP;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int off = Sk - Sq;
  const int tid = threadIdx.x;
  const int r = tid >> 2, sub = tid & 3;
  const int qi = q0 + r;
  const int qpos = qi + off;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, d = i % D;
    const int row = q0 + rr;
    float qv = 0.f, gv = 0.f;
    if (row < Sq) {
      const size_t idx = (((size_t)b * Sq + row) * H + h) * D + d;
      qv = to_f(q[idx]);
      gv = to_f(dout[idx]);
    }
    Qs[rr * DP + d] = qv;
    dOs[rr * DP + d] = gv;
  }
  __syncthreads();

  // delta for this row: 4 threads, D/4 channels each, then two shuffles
  float dsum = 0.f;
  if (qi < Sq) {
    const T* orow = o + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll 8
    for (int i = 0; i < NA; ++i) dsum = fmaf(dOs[r * DP + sub + 4 * i], to_f(orow[sub + 4 * i]), dsum);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  const size_t row_id = ((size_t)b * H + h) * Sq + qi;
  const float Lr = qi < Sq ? lse[row_id] : 0.f;
  if (qi < Sq && sub == 0) delta[row_id] = dsum;

  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_q + off + 1) : Sk;
  const int kbeg = window > 0 ? (int)max(0LL, (long long)q0 + off - window + 1) : 0;

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int kt = kbeg; kt < kend; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const int kpos = kt + c;
      float kv = 0.f, vv = 0.f;
      if (kpos < Sk) {
        const size_t idx = (((size_t)b * Sk + kpos) * K + kvh) * D + d;
        kv = to_f(k[idx]);
        vv = to_f(v[idx]);
      }
      Ks[c * DP + d] = kv;
      Vs[c * DP + d] = vv;
    }
    __syncthreads();

    float s[NS], dp[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * DP + d];
      const float gv = dOs[r * DP + d];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j] = fmaf(qv, Ks[(sub + 4 * j) * DP + d], s[j]);
        dp[j] = fmaf(gv, Vs[(sub + 4 * j) * DP + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const bool ok = qi < Sq && visible(kt + sub + 4 * j, qpos, Sk, causal, window);
      const float p = ok ? expf(s[j] * scale - Lr) : 0.f;
      Ds[r * PP + sub + 4 * j] = p * (dp[j] - dsum);
    }
    __syncwarp();  // a row's 4 threads share one warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = Ds[r * PP + c];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = fmaf(ds, Ks[c * DP + sub + 4 * i], acc[i]);
    }
  }

  if (qi < Sq) {
    T* g = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) g[sub + 4 * i] = from_f<T>(acc[i] * scale);
  }
}

// dK = scale * sum dS^T Q and dV = sum P^T dO over the G query heads of one
// KV head and the query rows that can see the block's keys.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int H, int K, int Sq,
                               int Sk, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BQ2 + 1;
  constexpr int NS = BQ2 / TPR;  // scores per thread per query tile
  constexpr int NA = D / TPR;    // channels of dK and of dV per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * DP;
  float* Qs = Vs + BKV * DP;
  float* dOs = Qs + BQ2 * DP;
  float* Ps = dOs + BQ2 * DP;
  float* Ss = Ps + BKV * PP;
  float* rowL = Ss + BKV * PP;
  float* rowD = rowL + BQ2;

  const int k0 = blockIdx.x * BKV;
  const int bk = blockIdx.y;
  const int b = bk / K, kvh = bk % K;
  const int G = H / K;
  const int off = Sk - Sq;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const int kj = k0 + r;

  for (int i = tid; i < BKV * D; i += NT) {
    const int c = i / D, d = i % D;
    const int kpos = k0 + c;
    float kv = 0.f, vv = 0.f;
    if (kpos < Sk) {
      const size_t idx = (((size_t)b * Sk + kpos) * K + kvh) * D + d;
      kv = to_f(k[idx]);
      vv = to_f(v[idx]);
    }
    Ks[c * DP + d] = kv;
    Vs[c * DP + d] = vv;
  }

  // query rows any key of this tile is visible to
  const int last_k = min(k0 + BKV, Sk) - 1;
  const int qbeg = causal ? max(0, k0 - off) : 0;
  const int qend = window > 0 ? (int)min((long long)Sq, (long long)last_k - off + window) : Sq;

  float acc_k[NA], acc_v[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = qbeg; qt < qend; qt += BQ2) {
      __syncthreads();  // K/V are loaded / the previous tile is consumed
      for (int i = tid; i < BQ2 * D; i += NT) {
        const int rr = i / D, d = i % D;
        const int row = qt + rr;
        float qv = 0.f, gv = 0.f;
        if (row < Sq) {
          const size_t idx = (((size_t)b * Sq + row) * H + h) * D + d;
          qv = to_f(q[idx]);
          gv = to_f(dout[idx]);
        }
        Qs[rr * DP + d] = qv;
        dOs[rr * DP + d] = gv;
      }
      for (int i = tid; i < BQ2; i += NT) {
        const int row = qt + i;
        const size_t id = ((size_t)b * H + h) * Sq + row;
        rowL[i] = row < Sq ? lse[id] : 0.f;
        rowD[i] = row < Sq ? delta[id] : 0.f;
      }
      __syncthreads();

      float s[NS], dp[NS];
#pragma unroll
      for (int t = 0; t < NS; ++t) s[t] = dp[t] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = Ks[r * DP + d];
        const float vv = Vs[r * DP + d];
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          s[t] = fmaf(kv, Qs[(sub + TPR * t) * DP + d], s[t]);
          dp[t] = fmaf(vv, dOs[(sub + TPR * t) * DP + d], dp[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int c = sub + TPR * t;
        const int row = qt + c;
        const bool ok = row < Sq && visible(kj, row + off, Sk, causal, window);
        const float p = ok ? expf(s[t] * scale - rowL[c]) : 0.f;
        Ps[r * PP + c] = p;
        Ss[r * PP + c] = p * (dp[t] - rowD[c]);
      }
      __syncwarp();  // a key row's 8 threads share one warp

#pragma unroll 4
      for (int c = 0; c < BQ2; ++c) {
        const float p = Ps[r * PP + c];
        const float ds = Ss[r * PP + c];
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          acc_v[i] = fmaf(p, dOs[c * DP + sub + TPR * i], acc_v[i]);
          acc_k[i] = fmaf(ds, Qs[c * DP + sub + TPR * i], acc_k[i]);
        }
      }
    }
  }

  if (kj < Sk) {
    const size_t base = (((size_t)b * Sk + kj) * K + kvh) * D;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      dk[base + sub + TPR * i] = from_f<T>(acc_k[i] * scale);
      dv[base + sub + TPR * i] = from_f<T>(acc_v[i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, float* lse,
                         int B, int H, int K, int Sq, int Sk, int causal, int window,
                         cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, H, K, Sq, Sk, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_typed(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, float* delta, void* dq, void* dk,
                             void* dv, int B, int H, int K, int Sq, int Sk, int causal,
                             int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  const size_t bytes_dq = smem_floats_dq(D) * sizeof(float);
  const size_t bytes_dkv = smem_floats_dkv(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes_dkv);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dim3 grid_dq((Sq + BQ - 1) / BQ, B * H);
  flash_attention_bwd_dq_kernel<T, D><<<grid_dq, NT, bytes_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, delta, static_cast<T*>(dq), H, K, Sq, Sk,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_dkv((Sk + BKV - 1) / BKV, B * K);
  flash_attention_bwd_dkv_kernel<T, D><<<grid_dkv, NT, bytes_dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, K, Sq, Sk,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v, void* out, float* lse,
                     int B, int H, int K, int Sq, int Sk, int causal, int window,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch_typed<T, 32>(q, k, v, out, lse, B, H, K, Sq, Sk, causal, window, s);
    case 64: return launch_typed<T, 64>(q, k, v, out, lse, B, H, K, Sq, Sk, causal, window, s);
    case 128: return launch_typed<T, 128>(q, k, v, out, lse, B, H, K, Sq, Sk, causal, window, s);
    case 256: return launch_typed<T, 256>(q, k, v, out, lse, B, H, K, Sq, Sk, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_bwd_t(int D, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int B, int H, int K, int Sq, int Sk, int causal, int window,
                         cudaStream_t s) {
#define FA_BWD(DD)                                                                           \
  launch_bwd_typed<T, DD>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, H, K, Sq, Sk, causal, \
                          window, s)
  switch (D) {
    case 32: return FA_BWD(32);
    case 64: return FA_BWD(64);
    case 128: return FA_BWD(128);
    case 256: return FA_BWD(256);
    default: return cudaErrorInvalidValue;
  }
#undef FA_BWD
}

// ---------------------------------------------------------------- mma route
// The backward on tensor cores (bf16, D in {64, 128, 256}): mma.sync
// m16n8k16 with bf16 operands from padded shared-memory rows (ldmatrix,
// .trans for the operands read across rows) and f32 accumulators.

template <int D>
struct MmaBwd {
  static constexpr int DS = D + 8;                // padded row: ldmatrix without bank conflicts
  static constexpr int BQ = 64;                   // dQ kernel: query rows (4 warps x 16)
  static constexpr int BKT = D == 256 ? 32 : 64;  // dQ kernel: keys per tile
  static constexpr int BKV = 64;                  // dK/dV kernel: key rows (4 groups x 16)
  static constexpr int BQT = D == 64 ? 64 : 32;   // dK/dV kernel: queries per tile
  static constexpr int SPLIT = D == 256 ? 2 : 1;  // dK/dV kernel: warps sharing a key group
  static constexpr int NT_DKV = 128 * SPLIT;
  static constexpr size_t smem_dq = (size_t)(2 * BQ + 4 * BKT) * DS * 2 + 2 * BQ * 4;
  static constexpr size_t smem_dkv = (size_t)(2 * BKV + 4 * BQT) * DS * 2 + 4 * BQT * 4;
};

// cp.async rows first .. first + n_rows - 1 of a bf16 matrix whose row p
// starts at src + p * stride into dst (row pitch D + 8); rows >= limit
// are zero-filled.
template <int D, int NTH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int n_rows, int first, int limit, size_t stride) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < n_rows * CH; e += NTH) {
    const int rr = e / CH, ch = e % CH;
    const int p = first + rr;
    const bool ok = p < limit;
    sm90::cp_async16(dst + rr * (D + 8) + ch * 8, ok ? src + (size_t)p * stride + ch * 8 : src,
                     ok ? 16 : 0);
  }
}

__device__ __forceinline__ void frag_a_from_acc(uint32_t (&a)[4], const float (&lo)[4],
                                                const float (&hi)[4]) {
  a[0] = sm90::pack_bf16(lo[0], lo[1]);
  a[1] = sm90::pack_bf16(lo[2], lo[3]);
  a[2] = sm90::pack_bf16(hi[0], hi[1]);
  a[3] = sm90::pack_bf16(hi[2], hi[3]);
}

// dQ = scale * dS K over the visible keys, and delta = rowsum(dO * O).
// Block: 64 query rows of one (batch, head); warp w owns rows 16w..16w+15.
template <int D>
__global__ void __launch_bounds__(128)
flash_attention_bwd_dq_kernel_mma(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ o,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse, float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dq, int H, int K, int Sq, int Sk,
                                  int causal, int window, float scale) {
  using C = MmaBwd<D>;
  constexpr int DS = C::DS, BQ = C::BQ, BKT = C::BKT, NT8 = BKT / 8, ND8 = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + BQ * DS;
  __nv_bfloat16* Ks = dOs + BQ * DS;  // two buffers of BKT rows
  __nv_bfloat16* Vs = Ks + 2 * BKT * DS;
  float* Lr = reinterpret_cast<float*>(Vs + 2 * BKT * DS);
  float* Dr = Lr + BQ;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t qstride = (size_t)H * D, kstride = (size_t)K * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D, kbase = ((size_t)b * Sk * K + kvh) * D;

  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_q + off + 1) : Sk;
  const int kbeg = window > 0 ? (int)max(0LL, (long long)q0 + off - window + 1) : 0;
  const int nt = kend > kbeg ? (kend - kbeg + BKT - 1) / BKT : 0;

  load_rows<D, 128>(Qs, q + qbase, BQ, q0, Sq, qstride);
  load_rows<D, 128>(dOs, dout + qbase, BQ, q0, Sq, qstride);
  if (nt > 0) {
    load_rows<D, 128>(Ks, k + kbase, BKT, kbeg, Sk, kstride);
    load_rows<D, 128>(Vs, v + kbase, BKT, kbeg, Sk, kstride);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // delta and the log-sum-exp of the block's rows: 2 threads a row
  {
    const int row = tid / 2, half = tid % 2;
    const int qi = q0 + row;
    float sum = 0.f;
    if (qi < Sq) {
      const __nv_bfloat16* orow = o + qbase + (size_t)qi * qstride + half * (D / 2);
      const __nv_bfloat16* drow = dOs + row * DS + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]), df = __bfloat1622float2(d2[i]);
          sum = fmaf(of.x, df.x, fmaf(of.y, df.y, sum));
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      const size_t id = ((size_t)b * H + h) * Sq + qi;
      Dr[row] = sum;
      Lr[row] = qi < Sq ? lse[id] : 0.f;
      if (qi < Sq) delta[id] = sum;
    }
  }
  __syncthreads();

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  const float L_lo = Lr[r_lo], L_hi = Lr[r_hi], D_lo = Dr[r_lo], D_hi = Dr[r_hi];
  const bool in_lo = q0 + r_lo < Sq, in_hi = q0 + r_hi < Sq;
  const int qpos_lo = q0 + r_lo + off, qpos_hi = q0 + r_hi + off;

  float acc[ND8][4];
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    const int kt = kbeg + it * BKT;
    if (it + 1 < nt) {
      load_rows<D, 128>(Ks + (buf ^ 1) * BKT * DS, k + kbase, BKT, kt + BKT, Sk, kstride);
      load_rows<D, 128>(Vs + (buf ^ 1) * BKT * DS, v + kbase, BKT, kt + BKT, Sk, kstride);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BKT * DS;
    const __nv_bfloat16* Vt = Vs + buf * BKT * DS;

    float s[NT8][4], dp[NT8][4];
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t aq[4], ad[4];
      const int arow = warp * 16 + lane % 16, acol = kd * 16 + (lane / 16) * 8;
      sm90::ldmatrix_x4(aq, Qs + arow * DS + acol);
      sm90::ldmatrix_x4(ad, dOs + arow * DS + acol);
#pragma unroll
      for (int np = 0; np < NT8 / 2; ++np) {
        uint32_t bk[4], bv[4];
        const int key = np * 16 + lane % 8 + 8 * (lane / 16);
        const int col = kd * 16 + 8 * ((lane / 8) % 2);
        sm90::ldmatrix_x4(bk, Kt + key * DS + col);
        sm90::ldmatrix_x4(bv, Vt + key * DS + col);
        sm90::mma_bf16_16816(s[2 * np], aq, bk[0], bk[1]);
        sm90::mma_bf16_16816(s[2 * np + 1], aq, bk[2], bk[3]);
        sm90::mma_bf16_16816(dp[2 * np], ad, bv[0], bv[1]);
        sm90::mma_bf16_16816(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta), P recomputed from the log-sum-exp
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >= 2;
        const int kpos = kt + j * 8 + 2 * qd + (e & 1);
        const bool ok = (hi ? in_hi : in_lo) &&
                        visible(kpos, hi ? qpos_hi : qpos_lo, Sk, causal, window);
        const float p = ok ? expf(s[j][e] * scale - (hi ? L_hi : L_lo)) : 0.f;
        s[j][e] = p * (dp[j][e] - (hi ? D_hi : D_lo));
      }
    // dQ += dS K
#pragma unroll
    for (int kb = 0; kb < BKT / 16; ++kb) {
      uint32_t a[4];
      frag_a_from_acc(a, s[2 * kb], s[2 * kb + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        const int key = kb * 16 + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = dp2 * 16 + 8 * (lane / 16);
        sm90::ldmatrix_x4_trans(bk, Kt + key * DS + col);
        sm90::mma_bf16_16816(acc[2 * dp2], a, bk[0], bk[1]);
        sm90::mma_bf16_16816(acc[2 * dp2 + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the buffer is consumed before the next tile lands in it
  }

#pragma unroll
  for (int j = 0; j < ND8; ++j) {
    const int d = j * 8 + 2 * qd;
    if (in_lo)
      *reinterpret_cast<__nv_bfloat162*>(dq + qbase + (size_t)(q0 + r_lo) * qstride + d) =
          __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    if (in_hi)
      *reinterpret_cast<__nv_bfloat162*>(dq + qbase + (size_t)(q0 + r_hi) * qstride + d) =
          __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// dK = scale * dS^T Q and dV = P^T dO over the G query heads of one KV head
// and the query rows that can see the block's keys.  Block: 64 key rows;
// warp w owns key rows 16 (w % 4) .. + 15 and, at D = 256, one half of D
// (the two warps of a key group both form S^T and dP^T: 256 f32
// accumulators of dK and dV for a full row would not fit in registers).
template <int D>
__global__ void __launch_bounds__(MmaBwd<D>::NT_DKV)
flash_attention_bwd_dkv_kernel_mma(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, int H, int K, int Sq, int Sk,
                                   int causal, int window, float scale) {
  using C = MmaBwd<D>;
  constexpr int DS = C::DS, BKV = C::BKV, BQT = C::BQT, NTH = C::NT_DKV;
  constexpr int DH = D / C::SPLIT, NQ8 = BQT / 8, NH8 = DH / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BKV * DS;
  __nv_bfloat16* Qs = Vs + BKV * DS;  // two buffers of BQT rows
  __nv_bfloat16* dOs = Qs + 2 * BQT * DS;
  float* Lq = reinterpret_cast<float*>(dOs + 2 * BQT * DS);
  float* Dq = Lq + 2 * BQT;

  const int k0 = blockIdx.x * BKV;
  const int bk = blockIdx.y;
  const int b = bk / K, kvh = bk % K;
  const int G = H / K;
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int kr0 = (warp % 4) * 16, dh0 = (warp / 4) * DH;
  const size_t qstride = (size_t)H * D, kstride = (size_t)K * D;
  const size_t kbase = ((size_t)b * Sk * K + kvh) * D;

  const int last_k = min(k0 + BKV, Sk) - 1;
  const int qbeg = causal ? max(0, k0 - off) : 0;
  const int qend = window > 0 ? (int)min((long long)Sq, (long long)last_k - off + window) : Sq;
  const int nq = qend > qbeg ? (qend - qbeg + BQT - 1) / BQT : 0;
  const int total = G * nq;

  auto prefetch = [&](int it, int buf) {
    const int h = kvh * G + it / nq;
    const int qt = qbeg + (it % nq) * BQT;
    const size_t qbase = ((size_t)b * Sq * H + h) * D;
    load_rows<D, NTH>(Qs + buf * BQT * DS, q + qbase, BQT, qt, Sq, qstride);
    load_rows<D, NTH>(dOs + buf * BQT * DS, dout + qbase, BQT, qt, Sq, qstride);
    for (int i = tid; i < BQT; i += NTH) {
      const int row = qt + i;
      const size_t id = ((size_t)b * H + h) * Sq + row;
      Lq[buf * BQT + i] = row < Sq ? lse[id] : 0.f;
      Dq[buf * BQT + i] = row < Sq ? delta[id] : 0.f;
    }
  };

  load_rows<D, NTH>(Ks, k + kbase, BKV, k0, Sk, kstride);
  load_rows<D, NTH>(Vs, v + kbase, BKV, k0, Sk, kstride);
  if (total > 0) prefetch(0, 0);
  sm90::cp_async_commit();

  const int kj_lo = k0 + kr0 + g, kj_hi = kj_lo + 8;
  float akk[NH8][4], avv[NH8][4];
#pragma unroll
  for (int j = 0; j < NH8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) akk[j][e] = avv[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const int qt = qbeg + (it % nq) * BQT;
    if (it + 1 < total) {
      prefetch(it + 1, buf ^ 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Qt = Qs + buf * BQT * DS;
    const __nv_bfloat16* dOt = dOs + buf * BQT * DS;
    const float* Lt = Lq + buf * BQT;
    const float* Dt = Dq + buf * BQT;

    float s[NQ8][4], dp[NQ8][4];
#pragma unroll
    for (int j = 0; j < NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ak[4], av[4];
      const int arow = kr0 + lane % 16, acol = kd * 16 + (lane / 16) * 8;
      sm90::ldmatrix_x4(ak, Ks + arow * DS + acol);
      sm90::ldmatrix_x4(av, Vs + arow * DS + acol);
#pragma unroll
      for (int np = 0; np < NQ8 / 2; ++np) {
        uint32_t bq[4], bd[4];
        const int row = np * 16 + lane % 8 + 8 * (lane / 16);
        const int col = kd * 16 + 8 * ((lane / 8) % 2);
        sm90::ldmatrix_x4(bq, Qt + row * DS + col);
        sm90::ldmatrix_x4(bd, dOt + row * DS + col);
        sm90::mma_bf16_16816(s[2 * np], ak, bq[0], bq[1]);
        sm90::mma_bf16_16816(s[2 * np + 1], ak, bq[2], bq[3]);
        sm90::mma_bf16_16816(dp[2 * np], av, bd[0], bd[1]);
        sm90::mma_bf16_16816(dp[2 * np + 1], av, bd[2], bd[3]);
      }
    }
    // P^T and dS^T = P^T (dP^T - delta), P from the log-sum-exp
#pragma unroll
    for (int j = 0; j < NQ8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * qd + (e & 1);
        const int row = qt + c;
        const bool ok = row < Sq && visible(e >= 2 ? kj_hi : kj_lo, row + off, Sk, causal, window);
        const float p = ok ? expf(s[j][e] * scale - Lt[c]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - Dt[c]);
      }
    // dV += P^T dO and dK += dS^T Q on this warp's columns
#pragma unroll
    for (int kb = 0; kb < BQT / 16; ++kb) {
      uint32_t ap[4], ads[4];
      frag_a_from_acc(ap, s[2 * kb], s[2 * kb + 1]);
      frag_a_from_acc(ads, dp[2 * kb], dp[2 * kb + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < DH / 16; ++dp2) {
        uint32_t bo[4], bq[4];
        const int row = kb * 16 + lane % 8 + 8 * ((lane / 8) % 2);
        const int col = dh0 + dp2 * 16 + 8 * (lane / 16);
        sm90::ldmatrix_x4_trans(bo, dOt + row * DS + col);
        sm90::ldmatrix_x4_trans(bq, Qt + row * DS + col);
        sm90::mma_bf16_16816(avv[2 * dp2], ap, bo[0], bo[1]);
        sm90::mma_bf16_16816(avv[2 * dp2 + 1], ap, bo[2], bo[3]);
        sm90::mma_bf16_16816(akk[2 * dp2], ads, bq[0], bq[1]);
        sm90::mma_bf16_16816(akk[2 * dp2 + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the buffer is consumed before the next tile lands in it
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < NH8; ++j) {
    const int d = dh0 + j * 8 + 2 * qd;
    if (kj_lo < Sk) {
      const size_t at = kbase + (size_t)kj_lo * kstride + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(akk[j][0] * scale, akk[j][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(avv[j][0], avv[j][1]);
    }
    if (kj_hi < Sk) {
      const size_t at = kbase + (size_t)kj_hi * kstride + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(akk[j][2] * scale, akk[j][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(avv[j][2], avv[j][3]);
    }
  }
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int B, int H, int K, int Sq, int Sk, int causal, int window,
                           cudaStream_t stream) {
  using C = MmaBwd<D>;
  using T = __nv_bfloat16;
  const float scale = 1.0f / sqrtf((float)D);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::smem_dq);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_attention_bwd_dkv_kernel_mma<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem_dkv);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  dim3 grid_dq((Sq + C::BQ - 1) / C::BQ, B * H);
  flash_attention_bwd_dq_kernel_mma<D><<<grid_dq, 128, C::smem_dq, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, delta, static_cast<T*>(dq), H, K, Sq, Sk,
      causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid_dkv((Sk + C::BKV - 1) / C::BKV, B * K);
  flash_attention_bwd_dkv_kernel_mma<D><<<grid_dkv, C::NT_DKV, C::smem_dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, K, Sq, Sk,
      causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- mma forward
// The forward on tensor cores (bf16, D in {64, 128, 256}), FlashAttention-2
// style: S = Q K^T and O += P V on mma.sync with f32 accumulators, the
// online softmax in f32 on the accumulator fragments (base 2: the logits
// are scaled by log2(e) / sqrt(D) once), P rounded to bf16 as the A
// fragment of P V.

template <int D>
struct MmaFwd {
  static constexpr int DS = D + 8;                // padded row: ldmatrix without bank conflicts
  static constexpr int BQ = 64;                   // query rows (4 warps x 16)
  static constexpr int BKT = D == 256 ? 32 : 64;  // keys per tile
  static constexpr size_t smem = (size_t)(BQ + 4 * BKT) * DS * 2;
};

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

// Block: 64 query rows of one (batch, head); warp w owns rows 16w..16w+15
// and skips the key tiles that none of its rows can see.
template <int D>
__global__ void __launch_bounds__(128)
flash_attention_kernel_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int H, int K, int Sq, int Sk, int causal,
                           int window, float scale_log2) {
  using C = MmaFwd<D>;
  constexpr int DS = C::DS, BQ = C::BQ, BKT = C::BKT, NT8 = BKT / 8, ND8 = D / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * DS;  // two buffers of BKT rows
  __nv_bfloat16* Vs = Ks + 2 * BKT * DS;

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int off = Sk - Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t qstride = (size_t)H * D, kstride = (size_t)K * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D, kbase = ((size_t)b * Sk * K + kvh) * D;

  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_q + off + 1) : Sk;
  const int kbeg = window > 0 ? (int)max(0LL, (long long)q0 + off - window + 1) : 0;
  const int nt = kend > kbeg ? (kend - kbeg + BKT - 1) / BKT : 0;

  load_rows<D, 128>(Qs, q + qbase, BQ, q0, Sq, qstride);
  if (nt > 0) {
    load_rows<D, 128>(Ks, k + kbase, BKT, kbeg, Sk, kstride);
    load_rows<D, 128>(Vs, v + kbase, BKT, kbeg, Sk, kstride);
  }
  sm90::cp_async_commit();

  const int w0 = q0 + warp * 16;  // the warp's first query row
  const int qpos_lo = w0 + g + off, qpos_hi = qpos_lo + 8;
  float m_lo = NEG_INF, m_hi = NEG_INF;  // running row max (base-2 logits)
  float l_lo = 0.f, l_hi = 0.f;          // this thread's share of the row sums
  float acc[ND8][4];
#pragma unroll
  for (int j = 0; j < ND8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1;
    const int kt = kbeg + it * BKT;
    if (it + 1 < nt) {
      load_rows<D, 128>(Ks + (buf ^ 1) * BKT * DS, k + kbase, BKT, kt + BKT, Sk, kstride);
      load_rows<D, 128>(Vs + (buf ^ 1) * BKT * DS, v + kbase, BKT, kt + BKT, Sk, kstride);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + buf * BKT * DS;
    const __nv_bfloat16* Vt = Vs + buf * BKT * DS;
    const int klast = kt + BKT - 1;
    const bool hidden = (causal && kt > w0 + 15 + off) ||
                        (window > 0 && (long long)w0 + off - klast >= window);
    if (!hidden) {
      // S = Q K^T, 16 x BKT per warp
      float s[NT8][4];
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t aq[4];
        sm90::ldmatrix_x4(aq, Qs + (warp * 16 + lane % 16) * DS + kd * 16 + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          uint32_t bk[4];
          const int key = np * 16 + lane % 8 + 8 * (lane / 16);
          sm90::ldmatrix_x4(bk, Kt + key * DS + kd * 16 + 8 * ((lane / 8) % 2));
          sm90::mma_bf16_16816(s[2 * np], aq, bk[0], bk[1]);
          sm90::mma_bf16_16816(s[2 * np + 1], aq, bk[2], bk[3]);
        }
      }
      // the mask only where a key of the tile is hidden from a row of the warp
      const bool full = klast < Sk && (!causal || klast <= w0 + off) &&
                        (window <= 0 || (long long)w0 + 15 + off - kt < window);
      float mt_lo = NEG_INF, mt_hi = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (!full) {
            const int kpos = kt + j * 8 + 2 * qd + (e & 1);
            x = visible(kpos, e >= 2 ? qpos_hi : qpos_lo, Sk, causal, window) ? x : NEG_INF;
          }
          s[j][e] = x;
          if (e < 2)
            mt_lo = fmaxf(mt_lo, x);
          else
            mt_hi = fmaxf(mt_hi, x);
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, o));
        mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, o));
      }
      const float mn_lo = fmaxf(m_lo, mt_lo), mn_hi = fmaxf(m_hi, mt_hi);
      const float alpha_lo = exp2f(m_lo - mn_lo), alpha_hi = exp2f(m_hi - mn_hi);
      // a row with nothing visible yet keeps p = exp2(NEG_INF - 0) = 0
      const float ref_lo = mn_lo == NEG_INF ? 0.f : mn_lo;
      const float ref_hi = mn_hi == NEG_INF ? 0.f : mn_hi;
      m_lo = mn_lo;
      m_hi = mn_hi;
      float ls_lo = 0.f, ls_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        s[j][0] = exp2f(s[j][0] - ref_lo);
        s[j][1] = exp2f(s[j][1] - ref_lo);
        s[j][2] = exp2f(s[j][2] - ref_hi);
        s[j][3] = exp2f(s[j][3] - ref_hi);
        ls_lo += s[j][0] + s[j][1];
        ls_hi += s[j][2] + s[j][3];
      }
      l_lo = l_lo * alpha_lo + ls_lo;
      l_hi = l_hi * alpha_hi + ls_hi;
#pragma unroll
      for (int j = 0; j < ND8; ++j) {
        acc[j][0] *= alpha_lo;
        acc[j][1] *= alpha_lo;
        acc[j][2] *= alpha_hi;
        acc[j][3] *= alpha_hi;
      }
      // O += P V
#pragma unroll
      for (int kb = 0; kb < BKT / 16; ++kb) {
        uint32_t a[4];
        frag_a_from_acc(a, s[2 * kb], s[2 * kb + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          uint32_t bv[4];
          const int key = kb * 16 + lane % 8 + 8 * ((lane / 8) % 2);
          sm90::ldmatrix_x4_trans(bv, Vt + key * DS + dp2 * 16 + 8 * (lane / 16));
          sm90::mma_bf16_16816(acc[2 * dp2], a, bv[0], bv[1]);
          sm90::mma_bf16_16816(acc[2 * dp2 + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the buffer is consumed before the next tile lands in it
  }
  sm90::cp_async_wait<0>();

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o);
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
  const float inv_lo = 1.f / den_lo, inv_hi = 1.f / den_hi;
  const int r_lo = w0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < ND8; ++j) {
    const int d = j * 8 + 2 * qd;
    if (r_lo < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + qbase + (size_t)r_lo * qstride + d) =
          __floats2bfloat162_rn(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (r_hi < Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + qbase + (size_t)r_hi * qstride + d) =
          __floats2bfloat162_rn(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
  if (lse != nullptr && qd == 0) {
    // natural-log units, as the FMA route writes them
    const size_t row = ((size_t)b * H + h) * Sq;
    if (r_lo < Sq) lse[row + r_lo] = (m_lo == NEG_INF ? NEG_INF : m_lo * LN2) + logf(den_lo);
    if (r_hi < Sq) lse[row + r_hi] = (m_hi == NEG_INF ? NEG_INF : m_hi * LN2) + logf(den_hi);
  }
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* out, float* lse,
                           int B, int H, int K, int Sq, int Sk, int causal, int window,
                           cudaStream_t stream) {
  using C = MmaFwd<D>;
  using T = __nv_bfloat16;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Sq + C::BQ - 1) / C::BQ, B * H);
  flash_attention_kernel_mma<D><<<grid, 128, C::smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, H, K, Sq, Sk, causal, window, LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,K,D), out (B,Sq,H,D); contiguous, one dtype
// (f32 or bf16).  D must be 32, 64, 128 or 256.  window <= 0 means no
// window.  lse is null or an f32 (B,H,Sq) buffer for each row's
// log-sum-exp.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      void* lse, int B, int H, int K, int Sq, int Sk, int D,
                                      int causal, int window, int is_bf16, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err = is_bf16 ? launch_t<__nv_bfloat16>(D, q, k, v, out, l, B, H, K, Sq, Sk,
                                                      causal, window, s)
                            : launch_t<float>(D, q, k, v, out, l, B, H, K, Sq, Sk, causal,
                                              window, s);
  return (int)err;
}

// The forward's mma route: bf16 only, D in {64, 128, 256}, rows at 16-byte
// aligned addresses; the same arguments as flash_attention_launch less the
// dtype flag.
extern "C" int flash_attention_mma_launch(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int H, int K, int Sq, int Sk, int D,
                                          int causal, int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return (int)launch_fwd_mma<64>(q, k, v, out, l, B, H, K, Sq, Sk, causal, window, s);
    case 128: return (int)launch_fwd_mma<128>(q, k, v, out, l, B, H, K, Sq, Sk, causal, window, s);
    case 256: return (int)launch_fwd_mma<256>(q, k, v, out, l, B, H, K, Sq, Sk, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward: q, o, dout, dq (B,Sq,H,D); k, v, dk, dv (B,Sk,K,D); lse
// (the forward's) and delta (scratch) f32 (B,H,Sq).  Two launches on
// `stream`: dQ (and delta), then dK/dV.
extern "C" int flash_attention_backward_launch(const void* q, const void* k, const void* v,
                                               const void* o, const void* dout, const void* lse,
                                               void* delta, void* dq, void* dk, void* dv, int B,
                                               int H, int K, int Sq, int Sk, int D, int causal,
                                               int window, int is_bf16, void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;  // the caller zero-fills
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err = is_bf16 ? launch_bwd_t<__nv_bfloat16>(D, q, k, v, o, dout, l, dl, dq, dk,
                                                          dv, B, H, K, Sq, Sk, causal, window, s)
                            : launch_bwd_t<float>(D, q, k, v, o, dout, l, dl, dq, dk, dv, B, H,
                                                  K, Sq, Sk, causal, window, s);
  return (int)err;
}

// The backward's mma route: bf16 only, D in {64, 128, 256}; the same
// arguments and launches as flash_attention_backward_launch.
extern "C" int flash_attention_backward_mma_launch(const void* q, const void* k, const void* v,
                                                   const void* o, const void* dout,
                                                   const void* lse, void* delta, void* dq,
                                                   void* dk, void* dv, int B, int H, int K, int Sq,
                                                   int Sk, int D, int causal, int window,
                                                   void* stream) {
  if (B == 0 || Sq == 0 || Sk == 0) return 0;  // the caller zero-fills
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define FA_BWD_MMA(DD) \
  launch_bwd_mma<DD>(q, k, v, o, dout, l, dl, dq, dk, dv, B, H, K, Sq, Sk, causal, window, s)
  switch (D) {
    case 64: return (int)FA_BWD_MMA(64);
    case 128: return (int)FA_BWD_MMA(128);
    case 256: return (int)FA_BWD_MMA(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_BWD_MMA
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

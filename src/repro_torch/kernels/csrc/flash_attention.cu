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
// cores' rate; this first version runs its products on f32 FMA units).  The
// backward reads Q, K, V, O, dO and the row log-sum-exp, writes dQ, dK, dV,
// and does ~5*S^2*D flops under the mask (two products recomputed, three of
// the gradient).
//
// Forward design:
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
// Backward design (two launches on one stream, no atomics):
//   * P = exp(s*scale - lse) is recomputed from the forward's log-sum-exp,
//     under exactly the forward's masks; dS = P (dO.V^T - delta) with
//     delta = rowsum(dO * O) in f32.
//   * dQ kernel, grid (query tile of 64 rows, batch * head), 4 threads per
//     query row as in the forward: it first forms delta for its rows
//     (written to an f32 scratch the second launch reads), then walks the
//     visible key tiles of 32 rows, computing 8 scores and 8 dO.V^T per
//     thread, and accumulates dS.K in D/4 registers.
//   * dK/dV kernel, grid (key tile of 32 rows, batch * KV head), 8 threads
//     per key row: it loops over the G query heads of its KV head and the
//     query tiles of 64 rows that can see its keys, and accumulates dS^T.Q
//     and P^T.dO in 2 * D/8 registers.  The block owns its key rows for all
//     G heads, so the GQA sum is in registers, in a fixed order.
//   * shared memory at D = 256: 206 KB (dQ) and 215 KB (dK/dV), under the
//     227 KB a block may use; every product is on f32 FMA units.
// The products belong on wgmma with bf16 operands and TMA-fed tiles; that
// is work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

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

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blockwise causal / sliding-window attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at line 105).
//
// What bounds it on the H100: at prefill lengths (S <= a few hundred) the
// work is small either way; per (batch, head) it reads S*D values of each of
// Q, K, V, writes S*D, and does ~2*S^2*D flops under the causal mask, so it
// is bytes-bound below S ~ 150 and operations-bound above (at the tensor
// cores' rate; this first version runs its products on f32 FMA units).
//
// Design:
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
//   * shared memory is (BQ + BK)(D + 1) + BK*D + BQ(BK + 1) floats:
//     41.6 KB at D = 64 and 137 KB at D = 256 (under the 227 KB a block
//     may use; above 48 KB it is requested with cudaFuncSetAttribute).
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr size_t smem_floats(int D) {
  return (size_t)(BQ + BK) * (D + 1) + (size_t)BK * D + (size_t)BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int K, int Sq,
                       int Sk, int causal, int window, float scale) {
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
  const int kbeg = window > 0 ? max(0, q0 + off - window + 1) : 0;

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
      const int kpos = kt + sub + 4 * j;
      ok[j] = kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || qpos - kpos < window);
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
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, int B, int H,
                         int K, int Sq, int Sk, int causal, int window, cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, K, Sq, Sk, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
                     int K, int Sq, int Sk, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch_typed<T, 32>(q, k, v, out, B, H, K, Sq, Sk, causal, window, s);
    case 64: return launch_typed<T, 64>(q, k, v, out, B, H, K, Sq, Sk, causal, window, s);
    case 128: return launch_typed<T, 128>(q, k, v, out, B, H, K, Sq, Sk, causal, window, s);
    case 256: return launch_typed<T, 256>(q, k, v, out, B, H, K, Sq, Sk, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,K,D), out (B,Sq,H,D); contiguous, one dtype
// (f32 or bf16).  D must be 32, 64, 128 or 256.  window <= 0 means no
// window.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int K, int Sq, int Sk, int D, int causal,
                                      int window, int is_bf16, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch_t<__nv_bfloat16>(D, q, k, v, out, B, H, K, Sq, Sk, causal,
                                                      window, s)
                            : launch_t<float>(D, q, k, v, out, B, H, K, Sq, Sk, causal, window, s);
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

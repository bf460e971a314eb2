// Paged decode attention (one new query token per slot) for Hopper, sm_90a.
//
// Replaces the TPU kernel `paged_flash_attention` / `_paged_kernel` in
// src/repro/kernels/paged_attention.py (pallas_call at line 113).
//
// What bounds it on the H100: bytes.  Each slot reads len * K * D * 2 values
// (K and V) from the page pool and does 4 * D flops per (query head, key),
// so for the SLM (H = K = 20, D = 64, G = 1) it sits at ~1 flop per byte,
// far under the ~295 flops/byte where the tensor cores would bind.
//
// Design:
//   * grid (slot, KV head, query-head chunk): one block serves the G = H/K
//     query heads of one KV head (up to GC at a time), so each K/V row is
//     read once for the whole group; GQA is the index h / G, never a repeat.
//   * the block reads its own block-table row and length and walks only
//     the keys the mask keeps: positions [max(0, len - window), len), so no
//     page past len (and for an idle slot, len == 0, nothing) is touched.
//   * each warp takes every NW-th key; a lane holds VEC = D/32 contiguous
//     channels, loaded in one vector load, so a warp reads a whole K or V
//     row as one coalesced transaction.  The score is a warp-shuffle sum.
//   * online softmax in f32 registers per warp; the NW partial states are
//     merged through shared memory at the end.  An idle slot leaves l == 0
//     and writes zeros (acc / max(l, 1e-30)), as the TPU kernel does.
// The per-key loop is latency-bound (one dependent shuffle chain per key);
// batching keys per warp and cp.async prefetch of the next rows are the
// obvious next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int CH> struct Chunk;
template <> struct Chunk<16> { using type = uint4; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<4> { using type = unsigned int; };
template <> struct Chunk<2> { using type = unsigned short; };

// Load N contiguous elements of T into f32 registers with the widest
// aligned vector loads the byte count allows.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&f)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  constexpr int CH = BYTES % 16 == 0 ? 16 : BYTES % 8 == 0 ? 8 : BYTES % 4 == 0 ? 4 : 2;
  constexpr int PER = CH / (int)sizeof(T);
  using C = typename Chunk<CH>::type;
#pragma unroll
  for (int c = 0; c < N / PER; ++c) {
    C u = __ldg(reinterpret_cast<const C*>(p) + c);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < PER; ++i) f[c * PER + i] = to_f(e[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int warps_for(int gc, int vec) { return gc * vec <= 16 ? 8 : 4; }

template <typename T, int GC, int VEC>
__global__ void __launch_bounds__(256)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                       const int* __restrict__ lens, T* __restrict__ out, int H, int K,
                       int ps, int M, int window, float scale) {
  constexpr int NW = warps_for(GC, VEC);
  constexpr int D = VEC * 32;
  __shared__ float s_m[NW][GC];
  __shared__ float s_l[NW][GC];
  __shared__ float s_acc[NW][GC][D];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / K;
  const int g0 = blockIdx.z * GC;
  const int ng = min(GC, G - g0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = lens[b];
  const int start = window > 0 ? max(0, len - window) : 0;
  const int* bt = block_tables + (size_t)b * M;

  float qr[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
      const int h = kvh * G + g0 + g;
      load_vec<T, VEC>(q + ((size_t)b * H + h) * D + lane * VEC, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][i] = 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  for (int t = start + warp; t < len; t += NW) {
    const int page = bt[t / ps];
    const size_t row = ((size_t)page * ps + (t % ps)) * K + kvh;
    float kf[VEC], vf[VEC];
    load_vec<T, VEC>(k_pages + row * D + lane * VEC, kf);
    load_vec<T, VEC>(v_pages + row * D + lane * VEC, vf);
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < ng) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qr[g][i], kf[i], dot);
        const float s = warp_sum(dot) * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i] * alpha);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[warp][g][lane * VEC + i] = acc[g][i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ng * D; i += NW * 32) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(s_m[w][g] - mx);
      lsum = fmaf(s_l[w][g], c, lsum);
      a = fmaf(s_acc[w][g][d], c, a);
    }
    const int h = kvh * G + g0 + g;
    out[((size_t)b * H + h) * D + d] = from_f<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int GC, int VEC>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const int* bt,
                         const int* lens, void* out, int B, int H, int K, int ps, int M,
                         int window, float scale, cudaStream_t stream) {
  const int G = H / K;
  dim3 grid(B, K, (G + GC - 1) / GC);
  paged_attention_kernel<T, GC, VEC><<<grid, warps_for(GC, VEC) * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, lens,
      static_cast<T*>(out), H, K, ps, M, window, scale);
  return cudaGetLastError();
}

template <typename T, int GC>
cudaError_t launch_gc(int vec, const void* q, const void* kp, const void* vp, const int* bt,
                      const int* lens, void* out, int B, int H, int K, int ps, int M, int window,
                      float scale, cudaStream_t s) {
  switch (vec) {
    case 1: return launch_typed<T, GC, 1>(q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
    case 2: return launch_typed<T, GC, 2>(q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
    case 4: return launch_typed<T, GC, 4>(q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
    case 8: return launch_typed<T, GC, 8>(q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(int G, int vec, const void* q, const void* kp, const void* vp, const int* bt,
                     const int* lens, void* out, int B, int H, int K, int ps, int M, int window,
                     float scale, cudaStream_t s) {
  if (G <= 1) return launch_gc<T, 1>(vec, q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
  if (G <= 2) return launch_gc<T, 2>(vec, q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
  if (G <= 4) return launch_gc<T, 4>(vec, q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
  return launch_gc<T, 8>(vec, q, kp, vp, bt, lens, out, B, H, K, ps, M, window, scale, s);
}

}  // namespace

// q (B,1,H,D), k_pages/v_pages (P,ps,K,D), block_tables (B,M) int32,
// lens (B,) int32, out (B,1,H,D); all contiguous, one dtype (f32 or bf16).
// D must be 32, 64, 128 or 256.  window <= 0 means no window.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* lens, void* out,
                                      int B, int H, int K, int D, int ps, int M, int window,
                                      int is_bf16, void* stream) {
  if (B == 0) return 0;
  if (K <= 0 || H % K != 0 || D % 32 != 0) return (int)cudaErrorInvalidValue;
  const int vec = D / 32;
  const int G = H / K;
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lens);
  cudaError_t err =
      is_bf16 ? launch_t<__nv_bfloat16>(G, vec, q, k_pages, v_pages, bt, ln, out, B, H, K, ps, M,
                                        window, scale, s)
              : launch_t<float>(G, vec, q, k_pages, v_pages, bt, ln, out, B, H, K, ps, M, window,
                                scale, s);
  return (int)err;
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Batched masked Gram log-volume and its gradient for Hopper, sm_90a.
//
// Replaces the TPU kernel `gram_log_volume` / `_gram_kernel` in
// src/repro/kernels/gram_volume.py (pallas_call at line 56), held to the
// formula of src/repro/core/gram.py:log_volume (the model path):
//   v^_i = v_i * rsqrt(|v_i|^2 + 1e-12)            (k <= 8 rows of width d)
//   G~   = where(m_i & m_j, v^_i . v^_j, delta_ij) + eps * I
//   y    = sum_i log L_ii,  L = cholesky(G~)       (= 1/2 logdet G~)
// The TPU kernel is forward only; the backward here is written by hand:
//   dy/dG~ = 1/2 G~^-1,  dg = pair (.) (1/2 G~^-1 * gbar),
//   dv^_i  = 2 sum_j dg_ij v^_j,
//   dv_i   = r_i dv^_i - r_i^3 (v_i . dv^_i) v_i,  r_i = rsqrt(|v_i|^2 + 1e-12),
// which folds into dv_i = sum_j C_ij v_j with a k x k matrix C computed from
// the raw dot products, so the backward reads the rows twice and writes
// them once.
//
// What bounds it on the H100: each sample reads k*d values and does ~k^2*d
// flops plus O(k^3) scalar work, far below the ~300 flops a byte the card
// needs to be compute-bound: it is bytes-bound.
//
// Design: one warp per sample (4 warps a block, any batch size; a ragged
// last block exits its spare warps).  Lanes stride over d with coalesced
// loads of the k rows and accumulate the k(k+1)/2 raw dot products in
// registers; xor-shuffles give every lane the totals, and every lane runs
// the unrolled k x k Cholesky (k is a template parameter) redundantly, so
// no shared memory and no second synchronisation are needed.  The forward
// writes one f32 per sample.  The backward recomputes the factor (no saved
// state), inverts it in registers, and streams dv = C v over d.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Raw dot products D (symmetric, full k x k) of one sample's rows, summed
// over the warp so that every lane holds the totals.
template <typename T, int KK>
__device__ __forceinline__ void warp_dots(const T* __restrict__ v, int d, int lane,
                                          float (&D)[KK][KK]) {
#pragma unroll
  for (int i = 0; i < KK; ++i)
#pragma unroll
    for (int j = 0; j < KK; ++j) D[i][j] = 0.f;
  for (int c = lane; c < d; c += 32) {
    float x[KK];
#pragma unroll
    for (int i = 0; i < KK; ++i) x[i] = to_f(v[(size_t)i * d + c]);
#pragma unroll
    for (int i = 0; i < KK; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) D[i][j] = fmaf(x[i], x[j], D[i][j]);
  }
#pragma unroll
  for (int i = 0; i < KK; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = D[i][j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      D[i][j] = s;
      D[j][i] = s;
    }
}

// The masked, shifted Gram of the normalized rows, and its Cholesky factor.
// Returns sum_i log L_ii.
template <int KK>
__device__ __forceinline__ float gram_cholesky(const float (&D)[KK][KK], const bool (&m)[KK],
                                               float eps, float (&rr)[KK], float (&L)[KK][KK]) {
#pragma unroll
  for (int i = 0; i < KK; ++i) rr[i] = rsqrtf(D[i][i] + 1e-12f);
  float logdet = 0.f;
#pragma unroll
  for (int i = 0; i < KK; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float g = (m[i] && m[j]) ? D[i][j] * rr[i] * rr[j] : (i == j ? 1.f : 0.f);
      if (i == j) g += eps;
      float s = g;
#pragma unroll
      for (int t = 0; t < j; ++t) s -= L[i][t] * L[j][t];
      if (i == j) {
        L[i][i] = sqrtf(fmaxf(s, 1e-20f));
        logdet += logf(L[i][i]);
      } else {
        L[i][j] = s / L[j][j];
      }
    }
#pragma unroll
    for (int j = i + 1; j < KK; ++j) L[i][j] = 0.f;
  }
  return logdet;
}

template <typename T, int KK>
__global__ void __launch_bounds__(NT)
gram_log_volume_kernel(const T* __restrict__ vs, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int B, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= B) return;
  float D[KK][KK];
  warp_dots<T, KK>(vs + (size_t)s * KK * d, d, lane, D);
  bool m[KK];
#pragma unroll
  for (int i = 0; i < KK; ++i) m[i] = mask[(size_t)s * KK + i] != 0;
  float rr[KK], L[KK][KK];
  const float y = gram_cholesky<KK>(D, m, eps, rr, L);
  if (lane == 0) out[s] = y;
}

template <typename T, int KK>
__global__ void __launch_bounds__(NT)
gram_log_volume_bwd_kernel(const T* __restrict__ vs, const uint8_t* __restrict__ mask,
                           const float* __restrict__ gout, T* __restrict__ dvs, int B, int d,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= B) return;
  const T* v = vs + (size_t)s * KK * d;
  float D[KK][KK];
  warp_dots<T, KK>(v, d, lane, D);
  bool m[KK];
#pragma unroll
  for (int i = 0; i < KK; ++i) m[i] = mask[(size_t)s * KK + i] != 0;
  float rr[KK], L[KK][KK];
  gram_cholesky<KK>(D, m, eps, rr, L);

  // Li = L^-1 (lower), then G~^-1 = Li^T Li
  float Li[KK][KK];
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    const float inv = 1.f / L[i][i];
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      if (j > i) {
        Li[i][j] = 0.f;
      } else if (j == i) {
        Li[i][i] = inv;
      } else {
        float acc = 0.f;
#pragma unroll
        for (int t = j; t < i; ++t) acc += L[i][t] * Li[t][j];
        Li[i][j] = -acc * inv;
      }
    }
  }
  const float half_g = 0.5f * gout[s];
  float dg[KK][KK];
#pragma unroll
  for (int i = 0; i < KK; ++i)
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      float inv = 0.f;
#pragma unroll
      for (int t = (i > j ? i : j); t < KK; ++t) inv += Li[t][i] * Li[t][j];
      dg[i][j] = (m[i] && m[j]) ? half_g * inv : 0.f;
    }
  // dv_i = sum_j C_ij v_j
  float C[KK][KK];
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    float vdot = 0.f;  // (v_i . dv^_i) / 2
#pragma unroll
    for (int j = 0; j < KK; ++j) vdot += dg[i][j] * rr[j] * D[i][j];
    const float beta = 2.f * rr[i] * rr[i] * rr[i] * vdot;
#pragma unroll
    for (int j = 0; j < KK; ++j) C[i][j] = 2.f * rr[i] * rr[j] * dg[i][j] - (i == j ? beta : 0.f);
  }
  T* dv = dvs + (size_t)s * KK * d;
  for (int c = lane; c < d; c += 32) {
    float x[KK];
#pragma unroll
    for (int j = 0; j < KK; ++j) x[j] = to_f(v[(size_t)j * d + c]);
#pragma unroll
    for (int i = 0; i < KK; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < KK; ++j) acc = fmaf(C[i][j], x[j], acc);
      dv[(size_t)i * d + c] = from_f<T>(acc);
    }
  }
}

template <typename T, int KK>
cudaError_t launch_fwd(const void* vs, const uint8_t* mask, float* out, int B, int d, float eps,
                       cudaStream_t st) {
  gram_log_volume_kernel<T, KK><<<(B + WARPS - 1) / WARPS, NT, 0, st>>>(
      static_cast<const T*>(vs), mask, out, B, d, eps);
  return cudaGetLastError();
}

template <typename T, int KK>
cudaError_t launch_bwd(const void* vs, const uint8_t* mask, const float* gout, void* dvs, int B,
                       int d, float eps, cudaStream_t st) {
  gram_log_volume_bwd_kernel<T, KK><<<(B + WARPS - 1) / WARPS, NT, 0, st>>>(
      static_cast<const T*>(vs), mask, gout, static_cast<T*>(dvs), B, d, eps);
  return cudaGetLastError();
}

#define GRAM_SWITCH_K(k, CALL)                   \
  switch (k) {                                   \
    case 1: return CALL(1);                      \
    case 2: return CALL(2);                      \
    case 3: return CALL(3);                      \
    case 4: return CALL(4);                      \
    case 5: return CALL(5);                      \
    case 6: return CALL(6);                      \
    case 7: return CALL(7);                      \
    case 8: return CALL(8);                      \
    default: return cudaErrorInvalidValue;       \
  }

template <typename T>
cudaError_t fwd_t(int k, const void* vs, const uint8_t* mask, float* out, int B, int d, float eps,
                  cudaStream_t st) {
#define CALL(K) launch_fwd<T, K>(vs, mask, out, B, d, eps, st)
  GRAM_SWITCH_K(k, CALL)
#undef CALL
}

template <typename T>
cudaError_t bwd_t(int k, const void* vs, const uint8_t* mask, const float* gout, void* dvs, int B,
                  int d, float eps, cudaStream_t st) {
#define CALL(K) launch_bwd<T, K>(vs, mask, gout, dvs, B, d, eps, st)
  GRAM_SWITCH_K(k, CALL)
#undef CALL
}

}  // namespace

// vs (B, k, d) f32 or bf16, mask (B, k) bool (one byte each), out (B,) f32;
// contiguous; 1 <= k <= 8.  Returns the cudaError_t of the launch.
extern "C" int gram_log_volume_launch(const void* vs, const void* mask, void* out, int B, int k,
                                      int d, float eps, int is_bf16, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  return (int)(is_bf16 ? fwd_t<__nv_bfloat16>(k, vs, m, o, B, d, eps, st)
                       : fwd_t<float>(k, vs, m, o, B, d, eps, st));
}

// gout (B,) f32 is dL/dy; dvs (B, k, d) in vs's dtype receives dL/dvs.
extern "C" int gram_log_volume_bwd_launch(const void* vs, const void* mask, const void* gout,
                                          void* dvs, int B, int k, int d, float eps, int is_bf16,
                                          void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* g = static_cast<const float*>(gout);
  return (int)(is_bf16 ? bwd_t<__nv_bfloat16>(k, vs, m, g, dvs, B, d, eps, st)
                       : bwd_t<float>(k, vs, m, g, dvs, B, d, eps, st));
}

extern "C" const char* gram_log_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

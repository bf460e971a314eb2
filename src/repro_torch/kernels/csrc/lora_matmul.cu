// Fused LoRA projection y = x @ W + scale * (x @ A) @ B for Hopper, sm_90a.
//
// Replaces the TPU kernel `lora_matmul` / `_lora_kernel` in
// src/repro/kernels/lora_matmul.py (pallas_call at line 55).
//
// What bounds it on the H100: at the training shapes (M = 8 x 136 = 1088
// rows, K = N = 1280 or 4096) the dense product x@W does 2*M*K*N flops on
// M*K + K*N + M*N values, ~300-1000 flops a byte, so it is operations-bound
// at the tensor cores' rate.  The adapter adds O(r) columns of work and
// traffic (r = 8).
//
// Design (a first, simple kernel: right before fast):
//   * grid (N / 64, M / 64), 256 threads; each thread owns a 4 x 4 tile of
//     the 64 x 64 output block.  The K loop stages a 64 x 16 tile of x (kept
//     transposed in shared memory) and a 16 x 64 tile of W in f32, and the
//     products are f32 FMAs from shared memory.
//   * in the same K loop the block accumulates its 64 x r tile t = x@A in
//     registers (r <= 32, A's 16 x r tile staged beside W's).  The epilogue
//     parks t in shared memory, stages B's r x 64 tile and adds
//     scale * t@B to the f32 sum before the one rounding to the output
//     dtype: the (M, N) LoRA intermediate never reaches device memory.
//   * ragged M, N and K are masked inside the kernel (zeros are staged past
//     the edges, stores are guarded), so no shape has to divide a tile.
//   * trans_w = 1 reads W as the (N, K) row-major matrix whose transpose is
//     the K x N operand, in place.  The backward's dx = dy@W^T +
//     s*(dy@B^T)@A^T is this same function with W read that way and the
//     r-wide B^T, A^T passed as the adapter pair.
// The products belong on wgmma with bf16 operands and TMA-fed tiles; that
// is work for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int RMAX = 32;
constexpr int TPT = BM * RMAX / NT;  // t entries a thread may own

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
lora_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ a,
                   const T* __restrict__ b, T* __restrict__ y, int M, int N, int K, int r,
                   int trans_w, float scale) {
  __shared__ __align__(16) float Xs[BK][BM + 4];
  __shared__ __align__(16) float Ws[BK][BN + 4];
  __shared__ float As[BK][RMAX];
  __shared__ float Ts[BM][RMAX + 1];
  __shared__ float Bs[RMAX][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nt = BM * r;  // t entries of the block

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float tacc[TPT];
#pragma unroll
  for (int s = 0; s < TPT; ++s) tacc[s] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads read consecutive k of one row
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int e = tid + i * NT;
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      Xs[k][m] = (gm < M && gk < K) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    // W tile: read along the contiguous axis of its storage
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int e = tid + i * NT;
      int k, n;
      if (trans_w) {
        n = e / BK;
        k = e % BK;
      } else {
        k = e / BN;
        n = e % BN;
      }
      const int gk = k0 + k, gn = n0 + n;
      float val = 0.f;
      if (gk < K && gn < N) val = to_f(trans_w ? w[(size_t)gn * K + gk] : w[(size_t)gk * N + gn]);
      Ws[k][n] = val;
    }
    for (int e = tid; e < BK * r; e += NT) {
      const int k = e / r, j = e % r;
      const int gk = k0 + k;
      As[k][j] = gk < K ? to_f(a[(size_t)gk * r + j]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], wr[j], acc[i][j]);
    }
#pragma unroll
    for (int s = 0; s < TPT; ++s) {
      const int e = tid + s * NT;
      if (e < nt) {
        const int m = e / r, j = e % r;
        float t = tacc[s];
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) t = fmaf(Xs[kk][m], As[kk][j], t);
        tacc[s] = t;
      }
    }
    __syncthreads();
  }

  // epilogue: y = x@W + scale * t@B, rounded once
#pragma unroll
  for (int s = 0; s < TPT; ++s) {
    const int e = tid + s * NT;
    if (e < nt) Ts[e / r][e % r] = tacc[s];
  }
  for (int e = tid; e < r * BN; e += NT) {
    const int j = e / BN, n = e % BN;
    const int gn = n0 + n;
    Bs[j][n] = gn < N ? to_f(b[(size_t)j * N + gn]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    const int gm = m0 + m;
    if (gm >= M) continue;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = tx * 4 + jn;
      const int gn = n0 + n;
      if (gn >= N) continue;
      float lo = 0.f;
      for (int j = 0; j < r; ++j) lo = fmaf(Ts[m][j], Bs[j][n], lo);
      y[(size_t)gm * N + gn] = from_f<T>(acc[i][jn] + scale * lo);
    }
  }
}

}  // namespace

// x (M, K); W (K, N), or (N, K) when trans_w; A (K, r); B (r, N); y (M, N).
// Contiguous, one dtype (f32 or bf16), 1 <= r <= 32.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a, const void* b,
                                  void* y, int M, int N, int K, int r, int trans_w, float scale,
                                  int is_bf16, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (r < 1 || r > RMAX || K < 0) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (is_bf16) {
    using T = __nv_bfloat16;
    lora_matmul_kernel<T><<<grid, NT, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(a),
        static_cast<const T*>(b), static_cast<T*>(y), M, N, K, r, trans_w, scale);
  } else {
    lora_matmul_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(y), M,
        N, K, r, trans_w, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lora_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

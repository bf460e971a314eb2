// Mamba2 SSD intra-chunk scan (state-space duality) for Hopper, sm_90a.
//
// Replaces the TPU kernel `ssd_chunk` / `_ssd_kernel` in
// src/repro/kernels/ssd_scan.py (pallas_call at line 55).  For every
// (batch, chunk of L rows, head) it computes
//
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (L, P) f32
//   state = sum_j exp(cum_{L-1} - cum_j) dt_j x_j^T B_j              (P, N) f32
//
// where cum is the within-chunk cumulative sum of dt * A (<= 0, f32).
//
// What bounds it on the H100: per (chunk, head) it reads L*P values of x and
// L of dt and cum, per (chunk, group) L*N of each of B and C, and writes L*P
// f32 of y and P*N f32 of state; the products are L^2/2 * N per group (C.B^T
// under the causal mask) plus L^2/2 * P and L*P*N per head.  At Mamba2's
// shape (L 256, P 64, N 128, 80 heads, one group) that is ~10.7 MB against
// ~0.7 GFLOP, so at the tensor cores' rate it is bytes-bound.  This first
// version runs every product on f32 FMA units and so is operations-bound in
// practice; wgmma with bf16 operands, TMA-fed tiles and computing C.B^T once
// per group instead of once per head are work for a later change.
//
// Design:
//   * the model layout is read directly: x (B, S, H, P), B and C (B, S, G, N)
//     in the model dtype, dt and cum (B, S, H) f32; head h reads group
//     h / (H / G) (no repeat, no transpose).  S is a multiple of L (the
//     caller pads with dt = 0 rows, which add nothing and keep cum flat).
//   * grid (row tiles + 1, H, B * chunks).  A block with x < row tiles owns
//     BI = 64 query rows of y: it keeps their C rows (f32) in shared memory
//     and walks the source tiles of BJ = 64 rows up to its causal edge.  For
//     each tile it forms the 64 x 64 scores C_i . B_j (a 4 x 4 register tile
//     per thread, FMAs from shared memory), applies exp(cum_i - cum_j) dt_j
//     ONLY where j <= i (above the diagonal cum_i - cum_j is large and
//     positive, its exp is inf and inf * 0 is NaN, so exp is never evaluated
//     there), and accumulates the tile's scores times x_j into 4 x P/16
//     registers.  The last block of x computes the chunk's end state: its
//     threads own (p, n) outputs and walk all L rows with x_j pre-scaled by
//     exp(cum_{L-1} - cum_j) dt_j (argument <= 0).
//   * ragged L (< 64 or no multiple of 64) and any N are masked inside the
//     kernel; P <= 128 (4 x ceil(P/16) accumulators per thread).
//   * shared memory is 2 * 64 * (N + 1) + 64 * P + 64 * 65 + 256 floats:
//     99.8 KB at N = 128, P = 64 (requested above 48 KB with
//     cudaFuncSetAttribute), 39.9 KB at N = 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int NT = 256;   // threads per block
constexpr int BI = 64;    // query rows of y per block
constexpr int BJ = 64;    // source rows per tile
constexpr int SR = 32;    // state outputs per thread and pass
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_floats(int N, int P) {
  return 2 * (size_t)BI * (N + 1) + (size_t)BJ * P + (size_t)BI * (BJ + 1) + BI + 3 * BJ;
}

// The chunk's end state: states[bc, h] (P, N) f32.
template <typename T>
__device__ void chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ cum, const T* __restrict__ Bm,
                            float* __restrict__ states, float* smem, size_t row0, size_t bc,
                            int h, int g, int H, int G, int N, int P, int L) {
  const int tid = threadIdx.x;
  const int NS = N + 1;
  float* sB = smem;                // BJ x (N + 1)
  float* sX = sB + BJ * NS;        // BJ x P, x_j * w_j
  float* sW = sX + BJ * P;         // BJ
  const float cum_last = cum[(row0 + L - 1) * H + h];
  const int PN = P * N;
  for (int o0 = 0; o0 < PN; o0 += NT * SR) {
    float acc[SR];
    int po[SR], no[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int o = o0 + tid + NT * r;
      acc[r] = 0.f;
      po[r] = o < PN ? o / N : 0;
      no[r] = o < PN ? o % N : 0;
    }
    for (int j0 = 0; j0 < L; j0 += BJ) {
      const int nj = min(BJ, L - j0);
      __syncthreads();  // the previous tile's readers are done
      for (int r = tid; r < BJ; r += NT) {
        const size_t row = row0 + j0 + r;
        sW[r] = r < nj ? expf(cum_last - cum[row * H + h]) * dt[row * H + h] : 0.f;
      }
      for (int e = tid; e < BJ * N; e += NT) {
        const int r = e / N, n = e - r * N;
        sB[r * NS + n] = r < nj ? to_f(Bm[((row0 + j0 + r) * G + g) * N + n]) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < BJ * P; e += NT) {
        const int r = e / P, p = e - r * P;
        sX[e] = r < nj ? to_f(x[((row0 + j0 + r) * H + h) * P + p]) * sW[r] : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < nj; ++jj) {
        const float* xr = sX + jj * P;
        const float* br = sB + jj * NS;
#pragma unroll
        for (int r = 0; r < SR; ++r) acc[r] += xr[po[r]] * br[no[r]];
      }
    }
    float* st = states + (bc * H + h) * (size_t)PN;
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      const int o = o0 + tid + NT * r;
      if (o < PN) st[o] = acc[r];
    }
  }
}

template <typename T, int KP>
__global__ void __launch_bounds__(NT)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ cum, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ states, int S, int H, int G, int N, int P, int L) {
  extern __shared__ float smem[];
  const int n_row_tiles = (L + BI - 1) / BI;
  const int h = blockIdx.y;
  const size_t bc = blockIdx.z;  // b * chunks + c
  const int nc = S / L;
  const size_t b = bc / nc, c = bc % nc;
  const int g = h / (H / G);
  const size_t row0 = b * S + c * L;  // the chunk's first sequence row
  if ((int)blockIdx.x == n_row_tiles) {
    chunk_state<T>(x, dt, cum, Bm, states, smem, row0, bc, h, g, H, G, N, P, L);
    return;
  }

  const int tid = threadIdx.x;
  const int NS = N + 1;
  float* sC = smem;                 // BI x (N + 1)
  float* sB = sC + BI * NS;         // BJ x (N + 1)
  float* sX = sB + BJ * NS;         // BJ x P
  float* sS = sX + BJ * P;          // BI x (BJ + 1) masked, weighted scores
  float* sCumI = sS + BI * (BJ + 1);
  float* sCumJ = sCumI + BI;
  float* sDtJ = sCumJ + BJ;

  const int i0 = blockIdx.x * BI;
  const int ni = min(BI, L - i0);
  for (int e = tid; e < BI * N; e += NT) {
    const int r = e / N, n = e - r * N;
    sC[r * NS + n] = r < ni ? to_f(Cm[((row0 + i0 + r) * G + g) * N + n]) : 0.f;
  }
  for (int r = tid; r < BI; r += NT)
    sCumI[r] = r < ni ? cum[(row0 + i0 + r) * H + h] : 0.f;

  const int ty = tid / 16, tx = tid % 16;  // rows ty*4 + a, score cols tx + 16 b
  float acc[4][KP] = {};
  for (int j0 = 0; j0 < i0 + ni; j0 += BJ) {
    const int nj = min(BJ, L - j0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BJ * N; e += NT) {
      const int r = e / N, n = e - r * N;
      sB[r * NS + n] = r < nj ? to_f(Bm[((row0 + j0 + r) * G + g) * N + n]) : 0.f;
    }
    for (int e = tid; e < BJ * P; e += NT) {
      const int r = e / P, p = e - r * P;
      sX[e] = r < nj ? to_f(x[((row0 + j0 + r) * H + h) * P + p]) : 0.f;
    }
    for (int r = tid; r < BJ; r += NT) {
      const size_t row = row0 + j0 + r;
      sCumJ[r] = r < nj ? cum[row * H + h] : 0.f;
      sDtJ[r] = r < nj ? dt[row * H + h] : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = sC[(ty * 4 + a) * NS + n];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = sB[(tx + 16 * q) * NS + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[a][q] = fmaf(cv[a], bv[q], s[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a, i = i0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int cl = tx + 16 * q, j = j0 + cl;
        float v = 0.f;
        if (j <= i && r < ni && cl < nj)  // the mask comes before exp
          v = s[a][q] * expf(sCumI[r] - sCumJ[cl]) * sDtJ[cl];
        sS[r * (BJ + 1) + cl] = v;
      }
    }
    __syncthreads();

    for (int jj = 0; jj < nj; ++jj) {
      float xv[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int p = tx + 16 * k;
        xv[k] = p < P ? sX[jj * P + p] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float sv = sS[(ty * 4 + a) * (BJ + 1) + jj];
#pragma unroll
        for (int k = 0; k < KP; ++k) acc[a][k] = fmaf(sv, xv[k], acc[a][k]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (r >= ni) continue;
    float* yr = y + ((row0 + i0 + r) * H + h) * (size_t)P;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int p = tx + 16 * k;
      if (p < P) yr[p] = acc[a][k];
    }
  }
}

template <typename T, int KP>
cudaError_t launch_typed(const void* x, const void* dt, const void* cum, const void* Bm,
                         const void* Cm, void* y, void* states, int B, int S, int H, int G,
                         int N, int P, int L, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, P) * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T, KP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BI - 1) / BI + 1, H, B * (S / L));
  ssd_chunk_kernel<T, KP><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(cum),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), S, H, G, N, P, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const void* dt, const void* cum, const void* Bm,
                     const void* Cm, void* y, void* states, int B, int S, int H, int G, int N,
                     int P, int L, cudaStream_t s) {
#define SSD_LAUNCH(KP) \
  launch_typed<T, KP>(x, dt, cum, Bm, Cm, y, states, B, S, H, G, N, P, L, s)
  if (P <= 16) return SSD_LAUNCH(1);
  if (P <= 32) return SSD_LAUNCH(2);
  if (P <= 64) return SSD_LAUNCH(4);
  return SSD_LAUNCH(8);
#undef SSD_LAUNCH
}

}  // namespace

// x (B, S, H, P), B and C (B, S, G, N) in one dtype (f32 or bf16); dt and
// cum (B, S, H) f32; y (B, S, H, P) f32 and states (B, S / L, H, P, N) f32
// outputs.  All contiguous.  S must be a multiple of the chunk length L, H
// of G, and 1 <= P <= 128.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int ssd_chunk_launch(const void* x, const void* dt, const void* cum, const void* Bm,
                                const void* Cm, void* y, void* states, int B, int S, int H,
                                int G, int N, int P, int L, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (S % L != 0 || H % G != 0 || P < 1 || P > 128) return (int)cudaErrorInvalidValue;
  if ((long long)B * (S / L) > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch_t<__nv_bfloat16>(x, dt, cum, Bm, Cm, y, states, B, S, H, G,
                                                      N, P, L, s)
                            : launch_t<float>(x, dt, cum, Bm, Cm, y, states, B, S, H, G, N, P,
                                              L, s);
  return (int)err;
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Mamba2 SSD intra-chunk scan (state-space duality) for Hopper, sm_90a,
// forward (G: two routes, below) and backward (G': one FMA route, after the
// mma namespace).
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
// shape (L 256, P 64, N 128, 80 heads, one group) that is ~10.8 MB against
// ~0.7 GFLOP, so at the tensor cores' rate it is bytes-bound.  Two routes,
// chosen by the wrapper before the launch (`ssd_chunk_route`).
//
// mma route, `ssd_chunk_kernel_mma` (bf16 x, B, C; P and N multiples of 16,
// P <= 128, N <= 128; L a multiple of 64; 16-byte aligned rows):
//   * grid (L / 64 y tiles + ceil(P / 32) state blocks, groups x head
//     slices, batch x chunks), 128 threads (4 warps of 16 rows).  A slice
//     is 2 heads of one group (1 where P > 64, to bound the accumulators).
//     Mamba2's one-chunk launch: (4 + 2) x 40 x 1 = 240 blocks; hymba's
//     (50 heads, N 16): 150.
//   * a y block owns 64 rows i of one chunk and its slice.  For each source
//     tile j <= i (64 rows, cp.async, double-buffered: B rows, then x, cum
//     and dt of each head) it forms C_i . B_j^T ONCE for the slice on
//     mma.sync m16n8k16 (bf16 in, f32 accumulators kept in registers: the
//     products of bf16 values are exact), then for each head scales the
//     f32 scores by exp(cum_i - cum_j) dt_j, masked before exp on the
//     diagonal tile, and multiplies by x_j on mma.sync.  The scaled scores
//     are f32: each goes in as a hi + lo pair of bf16 A fragments (two
//     mma.sync per k-step), which keeps ~16 bits of each (|error| <~
//     2^-17 of the value) instead of bf16's 8, so the route holds the
//     f32 bound of the FMA route.  C . B^T is computed once per (row tile,
//     slice): heads / 2 = 40 times per group at mamba2 (80 on the FMA
//     route, 1 in the bound).
//   * a state block owns 32 columns of P for the slice's heads; warp w
//     owns 16 columns of P and 64 of N, and walks the chunk's source
//     tiles: state += (x w)^T B with w_j = exp(cum_{L-1} - cum_j) dt_j
//     (argument <= 0), (x w)^T as hi + lo bf16 A fragments, B rows by
//     ldmatrix.trans.
//   * shared memory at N 128, P 64: 91.6 KB a y block (two blocks an SM),
//     46 KB a state block; the launcher raises the dynamic limit once (a
//     static flag) and allocates nothing.
//
// fma route, `ssd_chunk_kernel` (f32 or bf16, any shape), every product on
// f32 FMA units:
//   * the model layout is read directly (by both routes): x (B, S, H, P), B and C (B, S, G, N)
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

#include "sm90.cuh"

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

// ---------------------------------------------------------------- mma route
namespace mma {

using bf16 = __nv_bfloat16;
constexpr int T = 64;      // rows of a y tile and of a source tile
constexpr int NTH = 128;   // 4 warps of 16 rows
constexpr int SP = 32;     // state blocks: columns of P per block
constexpr int SPS = SP + 8;
constexpr int MAX_N = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int P16>
struct Cfg {
  static constexpr int P = 16 * P16;
  static constexpr int HS = P16 <= 4 ? 2 : 1;  // heads per block (a slice of one group)
  static constexpr int XS = P + 8;             // padded x row (bf16): ldmatrix without conflicts
};

template <int P16>
__host__ __device__ size_t y_stage_bytes(int N) {
  using C = Cfg<P16>;
  return (size_t)T * (N + 8) * 2 + (size_t)C::HS * T * C::XS * 2 + 2 * (size_t)C::HS * T * 4;
}

__host__ __device__ inline size_t state_stage_bytes(int N) {
  return (size_t)T * SPS * 2 + (size_t)T * (N + 8) * 2 + 2 * (size_t)T * 4;
}

template <int P16>
size_t smem_bytes(int N) {
  const size_t y = (size_t)T * (N + 8) * 2 + 2 * y_stage_bytes<P16>(N) +
                   (size_t)Cfg<P16>::HS * T * 4;
  const size_t s = 2 * state_stage_bytes(N);
  return y > s ? y : s;
}

// cp.async 64 rows of `cols` bf16 (a multiple of 8) from rows src, src +
// stride, ... into dst (row pitch `pitch`)
__device__ __forceinline__ void load_tile(bf16* dst, int pitch, const bf16* src, size_t stride,
                                          int cols) {
  const int ch = cols / 8;
  for (int e = threadIdx.x; e < T * ch; e += NTH) {
    const int r = e / ch, c = e - r * ch;
    sm90::cp_async16(dst + r * pitch + c * 8, src + r * stride + c * 8, 16);
  }
}

// cp.async 64 f32 values src[0], src[stride], ... into dst
__device__ __forceinline__ void load_col(float* dst, const float* src, size_t stride) {
  for (int e = threadIdx.x; e < T; e += NTH) sm90::cp_async4(dst + e, src + e * stride);
}

// (a, b) = hi + lo, each a pair of bf16 (a in the low half): the pair
// carries about 16 bits of each f32 into an mma.sync operand
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = sm90::pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  sm90::mma_bf16_16816(d, hi, b0, b1);
  sm90::mma_bf16_16816(d, lo, b0, b1);
}

// y for rows it*64 .. it*64 + 63 of one chunk and the heads h0 .. h0 + nh - 1
// of group gi.  Warp w owns rows 16w .. 16w + 15.  Per source tile j <= i:
// CB = C_i B_j^T once (mma.sync, f32 in registers), then per head the
// weights CB * exp(cum_i - cum_j) * dt_j (masked before exp on the
// diagonal tile) as hi + lo bf16 A fragments against x_j (ldmatrix.trans).
template <int P16>
__device__ void y_tile(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ cum, const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, float* __restrict__ y, uint8_t* smem, int it,
                       size_t row0, int h0, int nh, int gi, int H, int G, int N) {
  using C = Cfg<P16>;
  constexpr int HS = C::HS, P = C::P, XS = C::XS;
  const int NS = N + 8;
  const size_t b_bytes = (size_t)T * NS * 2;
  const size_t x_off = b_bytes;  // within a stage: B rows, x rows per head, cum, dt
  const size_t cum_off = x_off + (size_t)HS * T * XS * 2;
  const size_t dt_off = cum_off + (size_t)HS * T * 4;
  const size_t stage = y_stage_bytes<P16>(N);
  bf16* Cs = reinterpret_cast<bf16*>(smem);
  uint8_t* st = smem + b_bytes;
  float* cumI = reinterpret_cast<float*>(st + 2 * stage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const size_t i0 = row0 + (size_t)it * T;
  const size_t xstride = (size_t)H * P, bstride = (size_t)G * N;

  auto load_stage = [&](int jt, int s) {
    uint8_t* base = st + s * stage;
    const size_t j0 = row0 + (size_t)jt * T;
    load_tile(reinterpret_cast<bf16*>(base), NS, Bm + (j0 * G + gi) * N, bstride, N);
    for (int hh = 0; hh < nh; ++hh) {
      const int hd = h0 + hh;
      load_tile(reinterpret_cast<bf16*>(base + x_off) + hh * T * XS, XS, x + (j0 * H + hd) * P,
                xstride, P);
      load_col(reinterpret_cast<float*>(base + cum_off) + hh * T, cum + j0 * H + hd, H);
      load_col(reinterpret_cast<float*>(base + dt_off) + hh * T, dt + j0 * H + hd, H);
    }
  };

  load_tile(Cs, NS, Cm + (i0 * G + gi) * N, bstride, N);
  for (int hh = 0; hh < nh; ++hh) load_col(cumI + hh * T, cum + i0 * H + h0 + hh, H);
  load_stage(0, 0);
  sm90::cp_async_commit();

  const int rl = warp * 16 + g;  // the thread's rows rl and rl + 8 of the tile
  float acc[HS][2 * P16][4];
#pragma unroll
  for (int hh = 0; hh < HS; ++hh)
#pragma unroll
    for (int j = 0; j < 2 * P16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][j][e] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int s = jt & 1;
    if (jt < it) {
      load_stage(jt + 1, s ^ 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* base = st + s * stage;
    const bf16* Bs = reinterpret_cast<const bf16*>(base);

    float cb[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
    for (int kn = 0; kn < N; kn += 16) {
      uint32_t a[4];
      sm90::ldmatrix_x4(a, Cs + (warp * 16 + lane % 16) * NS + kn + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        sm90::ldmatrix_x4(
            b, Bs + (np * 16 + lane % 8 + 8 * (lane / 16)) * NS + kn + 8 * ((lane / 8) % 2));
        sm90::mma_bf16_16816(cb[2 * np], a, b[0], b[1]);
        sm90::mma_bf16_16816(cb[2 * np + 1], a, b[2], b[3]);
      }
    }

    const bool diag = jt == it;
#pragma unroll
    for (int hh = 0; hh < HS; ++hh) {
      if (hh >= nh) break;
      const float* cj = reinterpret_cast<const float*>(base + cum_off) + hh * T;
      const float* dj = reinterpret_cast<const float*>(base + dt_off) + hh * T;
      const bf16* X = reinterpret_cast<const bf16*>(base + x_off) + hh * T * XS;
      const float ci[2] = {cumI[hh * T + rl], cumI[hh * T + rl + 8]};
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        float w[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = (2 * kb + t) * 8 + 2 * qd + (e & 1);
            const int row = rl + (e >> 1) * 8;
            // the mask comes before exp: above the diagonal cum_i - cum_j > 0
            w[t][e] = (!diag || col <= row)
                          ? cb[2 * kb + t][e] * exp2f((ci[e >> 1] - cj[col]) * LOG2E) * dj[col]
                          : 0.f;
          }
        uint32_t ahi[4], alo[4];
        split_bf16(w[0][0], w[0][1], ahi[0], alo[0]);
        split_bf16(w[0][2], w[0][3], ahi[1], alo[1]);
        split_bf16(w[1][0], w[1][1], ahi[2], alo[2]);
        split_bf16(w[1][2], w[1][3], ahi[3], alo[3]);
#pragma unroll
        for (int pn = 0; pn < P16; ++pn) {
          uint32_t b[4];
          const int key = kb * 16 + lane % 8 + 8 * ((lane / 8) % 2);
          sm90::ldmatrix_x4_trans(b, X + key * XS + pn * 16 + 8 * (lane / 16));
          mma_split(acc[hh][2 * pn], ahi, alo, b[0], b[1]);
          mma_split(acc[hh][2 * pn + 1], ahi, alo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next tile lands in it
  }

#pragma unroll
  for (int hh = 0; hh < HS; ++hh) {
    if (hh >= nh) break;
    float* y_lo = y + ((i0 + rl) * H + h0 + hh) * (size_t)P;
    float* y_hi = y_lo + (size_t)8 * H * P;
#pragma unroll
    for (int j = 0; j < 2 * P16; ++j) {
      const int p = j * 8 + 2 * qd;
      *reinterpret_cast<float2*>(y_lo + p) = make_float2(acc[hh][j][0], acc[hh][j][1]);
      *reinterpret_cast<float2*>(y_hi + p) = make_float2(acc[hh][j][2], acc[hh][j][3]);
    }
  }
}

// The chunk's end states of heads h0 .. h0 + nh - 1, columns sb*32 ..
// sb*32 + 31 of P: state = (x w)^T B over the chunk's L rows, with w_j =
// exp(cum_{L-1} - cum_j) dt_j.  Warp w owns 16 columns of P (w % 2) and 64
// of N (w / 2); (x w)^T goes in as hi + lo bf16 A fragments, B rows by
// ldmatrix.trans.  The (head, source tile) pairs stream through two stages.
template <int P16>
__device__ void state_tile(const bf16* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ cum, const bf16* __restrict__ Bm,
                           float* __restrict__ states, uint8_t* smem, int sb, size_t row0,
                           size_t bc, int h0, int nh, int gi, int H, int G, int N, int L) {
  constexpr int P = Cfg<P16>::P;
  const int NS = N + 8;
  const size_t b_off = (size_t)T * SPS * 2;
  const size_t cum_off = b_off + (size_t)T * NS * 2;
  const size_t dt_off = cum_off + (size_t)T * 4;
  const size_t stage = state_stage_bytes(N);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int pb = sb * SP, pcols = min(SP, P - pb);
  const int p0 = (warp & 1) * 16, n0 = (warp >> 1) * 64;
  const bool active = p0 < pcols && n0 < N;
  const int n16 = active ? min(4, (N - n0) / 16) : 0;
  const int nL = L / T, total = nh * nL;
  const size_t xstride = (size_t)H * P, bstride = (size_t)G * N;

  auto load = [&](int item, int s) {
    uint8_t* base = smem + s * stage;
    const int hd = h0 + item / nL;
    const size_t j0 = row0 + (size_t)(item % nL) * T;
    load_tile(reinterpret_cast<bf16*>(base), SPS, x + (j0 * H + hd) * P + pb, xstride, pcols);
    load_tile(reinterpret_cast<bf16*>(base + b_off), NS, Bm + (j0 * G + gi) * N, bstride, N);
    load_col(reinterpret_cast<float*>(base + cum_off), cum + j0 * H + hd, H);
    load_col(reinterpret_cast<float*>(base + dt_off), dt + j0 * H + hd, H);
  };
  load(0, 0);
  sm90::cp_async_commit();

  float acc[8][4];
  float cum_last = 0.f;
  for (int item = 0; item < total; ++item) {
    const int s = item & 1, hh = item / nL, jt = item % nL;
    if (jt == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      cum_last = cum[(row0 + L - 1) * H + h0 + hh];
    }
    if (item + 1 < total) {
      load(item + 1, s ^ 1);
      sm90::cp_async_commit();
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const uint8_t* base = smem + s * stage;
      const bf16* Xs = reinterpret_cast<const bf16*>(base);
      const bf16* Bs = reinterpret_cast<const bf16*>(base + b_off);
      const float* cj = reinterpret_cast<const float*>(base + cum_off);
      const float* dj = reinterpret_cast<const float*>(base + dt_off);
      const int pl = p0 + g, ph = pl + 8;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int ja = ks * 16 + 2 * qd;  // A's columns ja, ja + 1, ja + 8, ja + 9
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = ja + (q & 1) + (q >> 1) * 8;
          w[q] = exp2f((cum_last - cj[j]) * LOG2E) * dj[j];  // argument <= 0
        }
        auto xw = [&](int j, int p, float wj) {
          return __bfloat162float(Xs[j * SPS + p]) * wj;
        };
        uint32_t ahi[4], alo[4];
        split_bf16(xw(ja, pl, w[0]), xw(ja + 1, pl, w[1]), ahi[0], alo[0]);
        split_bf16(xw(ja, ph, w[0]), xw(ja + 1, ph, w[1]), ahi[1], alo[1]);
        split_bf16(xw(ja + 8, pl, w[2]), xw(ja + 9, pl, w[3]), ahi[2], alo[2]);
        split_bf16(xw(ja + 8, ph, w[2]), xw(ja + 9, ph, w[3]), ahi[3], alo[3]);
#pragma unroll
        for (int nq = 0; nq < 4; ++nq) {
          if (nq >= n16) break;
          uint32_t b[4];
          const int key = ks * 16 + lane % 8 + 8 * ((lane / 8) % 2);
          sm90::ldmatrix_x4_trans(b, Bs + key * NS + n0 + nq * 16 + 8 * (lane / 16));
          mma_split(acc[2 * nq], ahi, alo, b[0], b[1]);
          mma_split(acc[2 * nq + 1], ahi, alo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage is consumed before the next pair lands in it
    if (jt == nL - 1 && active) {
      float* st = states + ((bc * H + h0 + hh) * P + pb + p0) * (size_t)N + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * n16) break;
        const int n = j * 8 + 2 * qd;
        *reinterpret_cast<float2*>(st + (size_t)g * N + n) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(st + (size_t)(g + 8) * N + n) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// grid (L / 64 y tiles + ceil(P / 32) state blocks, groups * head slices,
// batch * chunks)
template <int P16>
__global__ void __launch_bounds__(NTH)
    ssd_chunk_kernel_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ cum, const bf16* __restrict__ Bm,
                         const bf16* __restrict__ Cm, float* __restrict__ y,
                         float* __restrict__ states, int S, int H, int G, int N, int L) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  constexpr int HS = Cfg<P16>::HS;
  const int R = H / G, slices = (R + HS - 1) / HS;
  const int gi = blockIdx.y / slices, sl = blockIdx.y % slices;
  const int h0 = gi * R + sl * HS, nh = min(HS, R - sl * HS);
  const size_t bc = blockIdx.z;  // b * chunks + c
  const int nc = S / L;
  const size_t row0 = (bc / nc) * S + (bc % nc) * L;
  const int n_row_tiles = L / T;
  if ((int)blockIdx.x < n_row_tiles)
    y_tile<P16>(x, dt, cum, Bm, Cm, y, smem_raw, blockIdx.x, row0, h0, nh, gi, H, G, N);
  else
    state_tile<P16>(x, dt, cum, Bm, states, smem_raw, blockIdx.x - n_row_tiles, row0, bc, h0,
                    nh, gi, H, G, N, L);
}

template <int P16>
cudaError_t launch(const void* x, const void* dt, const void* cum, const void* Bm, const void* Cm,
                   void* y, void* states, int B, int S, int H, int G, int N, int L,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(ssd_chunk_kernel_mma<P16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<P16>(MAX_N));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int slices = (H / G + Cfg<P16>::HS - 1) / Cfg<P16>::HS;
  if ((long long)G * slices > 65535) return cudaErrorInvalidValue;
  dim3 grid(L / T + (16 * P16 + SP - 1) / SP, G * slices, B * (S / L));
  ssd_chunk_kernel_mma<P16><<<grid, NTH, smem_bytes<P16>(N), stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(cum),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), S, H, G, N, L);
  return cudaGetLastError();
}

}  // namespace mma

// ------------------------------------------------------- backward, G' (fma)
// The gradient of the intra-chunk output and of the chunk end states with
// respect to x, dt, cum, B and C (TPU: `jax.grad` of the reference's
// ssd_reference).  For one chunk and head, with M_ij = (C_i . B_j)
// exp(cum_i - cum_j) for j <= i (0 above the diagonal), dAtt = dy x^T,
// w_j = exp(cum_{L-1} - cum_j) and dS the end state's gradient:
//
//   dx_j   = dt_j sum_i M_ij dy_i + dt_j w_j (dS B_j)
//   ddt_j  = sum_i dAtt_ij M_ij + w_j x_j^T dS B_j
//   dCB_ij = dAtt_ij dt_j exp(cum_i - cum_j)                 (j <= i)
//   dC_i   = sum_j dCB_ij B_j,   dB_j = sum_i dCB_ij C_i + dt_j w_j dS^T x_j
//   dcum_i = sum_j T_ij - sum_k T_ki - s_i,  T_ij = dCB_ij (C_i . B_j),
//            s_j = dt_j w_j x_j^T dS B_j;  dcum_{L-1} also gains sum_j s_j
//
// dB and dC sum over the heads of a group (all 80 at mamba2).
//
// What bounds it on the H100: per (chunk, head) it reads L*P values of x
// and of dy (f32), 2L of dt and cum and P*N of dS, per (chunk, group) L*N
// of each of B and C, and writes L*P f32 of dx, 2L of ddt and dcum and
// per group 2*L*N of dB and dC.  The products are ~L^2/2 * (2N + 2P) per
// head plus 2*L*P*N for the state term: at mamba2's training shape (batch
// 8, one chunk of 256, 80 heads, P 64, N 128) ~130 MB against ~40 GFLOP,
// so it is bound by operations at the tensor cores' rate.  This first
// kernel runs every product on f32 FMA units (67 TFLOP/s, a floor of
// ~0.6 ms there); tensor cores are later work.
//
// Design (`ssd_chunk_bwd_kernel` + two small finishing kernels, one call):
//   * grid (2 * row tiles, groups x head slices of HS = 8 heads, batch x
//     chunks), 256 threads (16 x 16, a 4 x 4 register tile of a 64 x 64
//     score tile each).  A "row" block owns 64 rows i and walks the source
//     tiles j <= i: dC_i and the row sums of T.  A "column" block owns 64
//     rows j and walks the tiles i >= j: dx_j, ddt_j, dB_j, the column sums
//     of T and the state term.  Both form C_i . B_j and dy_i . x_j for a
//     tile pair in registers (the column block transposed, so that its
//     sums over i are sums along its own rows), so the scores are formed
//     twice; nothing crosses blocks but the outputs.
//   * exp(cum_i - cum_j) is evaluated only where j <= i: above the
//     diagonal its argument is large and positive, exp gives inf and
//     0 * inf NaN.  w_j's argument is <= 0.
//   * no float atomics: a block walks its slice's heads in order and keeps
//     dB (or dC) of its rows in registers across them; each slice writes
//     its partial sums (slices x B x S x G x N f32, 10 x 1 MB at mamba2
//     against 84 MB a head), and a finishing kernel adds the slices in
//     order.  dcum's row sums, column sums and state term land in three
//     buffers that the second finishing kernel combines per (chunk, head)
//     in row order.  Two launches on the same inputs give the same bits.
//   * shared memory (floats): 2 * 64 * (N + 1) + 2 * 64 * (P + 1) + 2 * 64 *
//     65 + 320, 134 KB at N 128, P 64 (one block an SM); dS (P x (N + 1))
//     overlays the score tiles in the state step.  The caller passes every
//     output and the scratch (`ssd_chunk_bwd_workspace_floats`): the
//     launcher allocates nothing.
namespace bwd {

constexpr int NT = 256;    // 16 x 16 threads
constexpr int T = 64;      // rows of a tile
constexpr int TS = T + 1;  // padded stride of a score tile
constexpr int HS = 8;      // heads of a slice

int n_slices(int H, int G) { return (H / G + HS - 1) / HS; }

size_t work_floats(int N, int P) {
  return (size_t)T * (N + 1) + (size_t)T * (P + 1) + 2 * (size_t)T * TS;
}

size_t smem_floats(int N, int P) {
  return (size_t)T * (N + 1) + (size_t)T * (P + 1) + work_floats(N, P) + 5 * T;
}

// the sum over the 16 lanes of a half-warp, the same bits in every lane
__device__ __forceinline__ float half_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

template <typename Tp>
__device__ __forceinline__ void load_rows(float* dst, int stride, const Tp* src, size_t first,
                                          size_t step, int width, int n_rows) {
  for (int e = threadIdx.x; e < T * width; e += NT) {
    const int r = e / width, c = e - r * width;
    dst[r * stride + c] = r < n_rows ? to_f(src[(first + r * step) * width + c]) : 0.f;
  }
}

// grid (2 * ceil(L / 64), G * slices, B * chunks): x < row tiles a row
// block, else a column block
template <typename Tp, int KP, int NQ>
__global__ void __launch_bounds__(NT)
    ssd_chunk_bwd_kernel(const Tp* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ cum, const Tp* __restrict__ Bm,
                         const Tp* __restrict__ Cm, const float* __restrict__ dy,
                         const float* __restrict__ dS, float* __restrict__ dx,
                         float* __restrict__ ddt, float* __restrict__ row_t,
                         float* __restrict__ col_t, float* __restrict__ s_out,
                         float* __restrict__ dB_part, float* __restrict__ dC_part, int S, int H,
                         int G, int N, int P, int L, size_t rows) {
  extern __shared__ float smem[];
  const int n_tiles = (L + T - 1) / T;
  const bool col = (int)blockIdx.x >= n_tiles;  // block-uniform
  const int tile = (int)blockIdx.x % n_tiles, t0 = tile * T, nt = min(T, L - t0);
  const int R = H / G, ns = (R + HS - 1) / HS;
  const int gi = blockIdx.y / ns, sl = blockIdx.y % ns;
  const int h0 = gi * R + sl * HS, nh = min(HS, R - sl * HS);
  const size_t bc = blockIdx.z;  // b * chunks + c
  const int nc = S / L;
  const size_t row0 = (bc / nc) * S + (bc % nc) * L;
  const int NS = N + 1, PS = P + 1;
  float* sOwnN = smem;            // T x NS: C_i (row block) or B_j (column block)
  float* sOwnP = sOwnN + T * NS;  // T x PS: dy_i or x_j of the head
  float* sOthN = sOwnP + T * PS;  // T x NS: B_j or C_i of the other tile
  float* sOthP = sOthN + T * NS;  // T x PS: x_j or dy_i of the other tile
  float* sT1 = sOthP + T * PS;    // T x TS: dCB (row) or M^T (column)
  float* sT2 = sT1 + T * TS;      // T x TS: dCB^T (column)
  float* sDS = sOthN;             // P x NS: dS, over the work area in the state step
  float* sCumOwn = sT2 + T * TS;
  float* sDtOwn = sCumOwn + T;
  float* sCumOth = sDtOwn + T;
  float* sDtOth = sCumOth + T;
  float* sW = sDtOth + T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_rows(sOwnN, NS, col ? Bm : Cm, (row0 + t0) * G + gi, G, N, nt);
  float acc_n[4][NQ];  // dC_i or dB_j over the slice's heads
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc_n[a][q] = 0.f;
  const int o_first = col ? tile : 0, o_last = col ? n_tiles - 1 : tile;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();  // the previous head's readers are done
    if (col)
      load_rows(sOwnP, PS, x, (row0 + t0) * H + h, H, P, nt);
    else
      load_rows(sOwnP, PS, dy, (row0 + t0) * H + h, H, P, nt);
    for (int r = tid; r < T; r += NT) {
      const size_t row = row0 + t0 + r;
      sCumOwn[r] = r < nt ? cum[row * H + h] : 0.f;
      sDtOwn[r] = r < nt ? dt[row * H + h] : 0.f;
    }
    float t_sum[4] = {}, g_sum[4] = {};  // sums of T; (column) of dAtt * M
    float acc_p[4][KP] = {};             // (column) sum_i M_ij dy_i

    for (int o = o_first; o <= o_last; ++o) {
      const int o0 = o * T, no = min(T, L - o0);
      __syncthreads();  // the previous tile's readers are done
      load_rows(sOthN, NS, col ? Cm : Bm, (row0 + o0) * G + gi, G, N, no);
      if (col)
        load_rows(sOthP, PS, dy, (row0 + o0) * H + h, H, P, no);
      else
        load_rows(sOthP, PS, x, (row0 + o0) * H + h, H, P, no);
      for (int r = tid; r < T; r += NT) {
        const size_t row = row0 + o0 + r;
        sCumOth[r] = r < no ? cum[row * H + h] : 0.f;
        sDtOth[r] = r < no ? dt[row * H + h] : 0.f;
      }
      __syncthreads();

      float s[4][4] = {}, d[4][4] = {};  // C.B and dy.x of rows ty*4+a, cols tx+16q
      for (int n = 0; n < N; ++n) {
        float u[4], v[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) u[a] = sOwnN[(ty * 4 + a) * NS + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = sOthN[(tx + 16 * q) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[a][q] = fmaf(u[a], v[q], s[a][q]);
      }
      for (int p = 0; p < P; ++p) {
        float u[4], v[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) u[a] = sOwnP[(ty * 4 + a) * PS + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = sOthP[(tx + 16 * q) * PS + p];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) d[a][q] = fmaf(u[a], v[q], d[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = tx + 16 * q;
          const int i = col ? o0 + c : t0 + r, j = col ? t0 + r : o0 + c;
          float m = 0.f, dcb = 0.f;
          if (j <= i && r < nt && c < no) {  // the mask comes before exp
            const float e = expf(col ? sCumOth[c] - sCumOwn[r] : sCumOwn[r] - sCumOth[c]);
            m = s[a][q] * e;
            dcb = d[a][q] * (col ? sDtOwn[r] : sDtOth[c]) * e;
            t_sum[a] = fmaf(dcb, s[a][q], t_sum[a]);
            g_sum[a] = fmaf(d[a][q], m, g_sum[a]);
          }
          sT1[r * TS + c] = col ? m : dcb;
          sT2[r * TS + c] = dcb;
        }
      }
      __syncthreads();

      for (int cc = 0; cc < no; ++cc) {
        float dv[4], nv[NQ];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = sT2[(ty * 4 + a) * TS + cc];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = tx + 16 * q;
          nv[q] = n < N ? sOthN[cc * NS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q) acc_n[a][q] = fmaf(dv[a], nv[q], acc_n[a][q]);
        if (col) {
          float mv[4], pv[KP];
#pragma unroll
          for (int a = 0; a < 4; ++a) mv[a] = sT1[(ty * 4 + a) * TS + cc];
#pragma unroll
          for (int k = 0; k < KP; ++k) {
            const int p = tx + 16 * k;
            pv[k] = p < P ? sOthP[cc * PS + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int k = 0; k < KP; ++k) acc_p[a][k] = fmaf(mv[a], pv[k], acc_p[a][k]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      t_sum[a] = half_sum(t_sum[a]);
      g_sum[a] = half_sum(g_sum[a]);
    }
    if (!col) {
      if (tx == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ty * 4 + a;
          if (r < nt) row_t[(row0 + t0 + r) * H + h] = t_sum[a];
        }
      }
      continue;
    }

    // the column block: the chunk end state's gradient, then dx, ddt
    float s_j[4] = {};
    if (dS != nullptr) {
      __syncthreads();  // the tiles' readers are done: sDS overlays them
      const float* ds = dS + (bc * H + h) * (size_t)P * N;
      for (int e = tid; e < P * N; e += NT) {
        const int p = e / N, n = e - p * N;
        sDS[p * NS + n] = ds[e];
      }
      const float cum_last = cum[(row0 + L - 1) * H + h];
      for (int r = tid; r < T; r += NT) sW[r] = r < nt ? expf(cum_last - sCumOwn[r]) : 0.f;
      __syncthreads();
      float u[4][KP] = {};  // dS B_j
      for (int n = 0; n < N; ++n) {
        float bv[4], sv[KP];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = sOwnN[(ty * 4 + a) * NS + n];
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int p = tx + 16 * k;
          sv[k] = p < P ? sDS[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < KP; ++k) u[a][k] = fmaf(sv[k], bv[a], u[a][k]);
      }
      float v[4][NQ] = {};  // dS^T x_j
      for (int p = 0; p < P; ++p) {
        float xv[4], sv[NQ];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = sOwnP[(ty * 4 + a) * PS + p];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int n = tx + 16 * q;
          sv[q] = n < N ? sDS[p * NS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < NQ; ++q) v[a][q] = fmaf(sv[q], xv[a], v[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ty * 4 + a;
        float xu = 0.f;
#pragma unroll
        for (int k = 0; k < KP; ++k) {
          const int p = tx + 16 * k;
          if (p < P) xu = fmaf(sOwnP[r * PS + p], u[a][k], xu);
        }
        xu = half_sum(xu);
        const float w = sW[r], dtw = sDtOwn[r] * w;
#pragma unroll
        for (int k = 0; k < KP; ++k) acc_p[a][k] = fmaf(w, u[a][k], acc_p[a][k]);
        g_sum[a] = fmaf(w, xu, g_sum[a]);
        s_j[a] = dtw * xu;
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc_n[a][q] = fmaf(dtw, v[a][q], acc_n[a][q]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty * 4 + a;
      if (r >= nt) continue;
      const size_t row = row0 + t0 + r;
      const float dtj = sDtOwn[r];
      float* dxr = dx + (row * H + h) * (size_t)P;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int p = tx + 16 * k;
        if (p < P) dxr[p] = dtj * acc_p[a][k];
      }
      if (tx == 0) {
        ddt[row * H + h] = g_sum[a];
        col_t[row * H + h] = t_sum[a];
        s_out[row * H + h] = s_j[a];
      }
    }
  }
  // this slice's share of dB (column block) or dC (row block)
  float* part = (col ? dB_part : dC_part) + (size_t)sl * rows * G * N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty * 4 + a;
    if (r >= nt) continue;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = tx + 16 * q;
      if (n < N) part[((row0 + t0 + r) * G + gi) * N + n] = acc_n[a][q];
    }
  }
}

// dB and dC: the slices' partial sums added in slice order
__global__ void __launch_bounds__(NT)
    ssd_chunk_bwd_groups(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                         float* __restrict__ dB, float* __restrict__ dC, size_t count, int ns) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= count) return;
  float b = 0.f, c = 0.f;
  for (int sl = 0; sl < ns; ++sl) {
    b += dB_part[sl * count + e];
    c += dC_part[sl * count + e];
  }
  dB[e] = b;
  dC[e] = c;
}

// dcum per (batch x chunk, head), in row order: the row sums of T (already
// in dcum) less the column sums and the state term, and the state term's
// total on the chunk's last row
__global__ void __launch_bounds__(NT)
    ssd_chunk_bwd_dcum(const float* __restrict__ col_t, const float* __restrict__ s_in,
                       float* __restrict__ dcum, int S, int H, int L, size_t count) {
  const size_t e = (size_t)blockIdx.x * NT + threadIdx.x;
  if (e >= count) return;
  const size_t bc = e / H;
  const int h = (int)(e % H), nc = S / L;
  const size_t row0 = (bc / nc) * S + (bc % nc) * L;
  float total = 0.f;
  for (int i = 0; i < L; ++i) {
    const size_t o = (row0 + i) * H + h;
    total += s_in[o];
    dcum[o] = dcum[o] - col_t[o] - s_in[o];
  }
  dcum[(row0 + L - 1) * H + h] += total;
}

template <typename Tp, int KP, int NQ>
cudaError_t launch_main(const void* x, const void* dt, const void* cum, const void* Bm,
                        const void* Cm, const void* dy, const void* dS, float* dx, float* ddt,
                        float* dcum, float* col_t, float* s_buf, float* dB_part, float* dC_part,
                        int B, int S, int H, int G, int N, int P, int L, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, P) * sizeof(float);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_bwd_kernel<Tp, KP, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(2 * ((L + T - 1) / T), G * n_slices(H, G), B * (S / L));
  ssd_chunk_bwd_kernel<Tp, KP, NQ><<<grid, NT, bytes, stream>>>(
      static_cast<const Tp*>(x), static_cast<const float*>(dt), static_cast<const float*>(cum),
      static_cast<const Tp*>(Bm), static_cast<const Tp*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dS), dx, ddt, dcum, col_t, s_buf, dB_part, dC_part, S, H, G, N,
      P, L, (size_t)B * S);
  return cudaGetLastError();
}

template <typename Tp>
cudaError_t launch_t(const void* x, const void* dt, const void* cum, const void* Bm,
                     const void* Cm, const void* dy, const void* dS, float* dx, float* ddt,
                     float* dcum, float* col_t, float* s_buf, float* dB_part, float* dC_part,
                     int B, int S, int H, int G, int N, int P, int L, cudaStream_t s) {
#define SSD_BWD(KP, NQ)                                                                       \
  launch_main<Tp, KP, NQ>(x, dt, cum, Bm, Cm, dy, dS, dx, ddt, dcum, col_t, s_buf, dB_part, \
                          dC_part, B, S, H, G, N, P, L, s)
#define SSD_BWD_N(KP)              \
  (N <= 16   ? SSD_BWD(KP, 1)      \
   : N <= 32 ? SSD_BWD(KP, 2)      \
   : N <= 64 ? SSD_BWD(KP, 4)      \
             : SSD_BWD(KP, 8))
  return P <= 64 ? SSD_BWD_N(4) : SSD_BWD_N(8);
#undef SSD_BWD_N
#undef SSD_BWD
}

}  // namespace bwd

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

// The mma route: x, B, C bf16 at 16-byte aligned addresses; P and N
// multiples of 16 with P <= 128 and N <= 128; L a multiple of 64.  The
// same arguments as ssd_chunk_launch less the dtype flag.
extern "C" int ssd_chunk_mma_launch(const void* x, const void* dt, const void* cum,
                                    const void* Bm, const void* Cm, void* y, void* states, int B,
                                    int S, int H, int G, int N, int P, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (S % L != 0 || H % G != 0 || L % mma::T != 0) return (int)cudaErrorInvalidValue;
  if (P % 16 != 0 || P < 16 || P > 128 || N % 16 != 0 || N > mma::MAX_N)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * (S / L) > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_MMA(P16) (int)mma::launch<P16>(x, dt, cum, Bm, Cm, y, states, B, S, H, G, N, L, s)
  switch (P / 16) {
    case 1: return SSD_MMA(1);
    case 2: return SSD_MMA(2);
    case 3: return SSD_MMA(3);
    case 4: return SSD_MMA(4);
    case 5: return SSD_MMA(5);
    case 6: return SSD_MMA(6);
    case 7: return SSD_MMA(7);
    default: return SSD_MMA(8);
  }
#undef SSD_MMA
}

// The scratch of ssd_chunk_bwd_launch, in floats: dcum's column sums and
// state term (B * S * H each) and the head slices' partial dB and dC
// (slices * B * S * G * N each).
extern "C" long long ssd_chunk_bwd_workspace_floats(int B, int S, int H, int G, int N) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || H % G != 0) return -1;
  const long long rows = (long long)B * S;
  return 2 * rows * H + 2LL * bwd::n_slices(H, G) * rows * G * N;
}

// G', the backward of ssd_chunk_launch's y and states.  Inputs as there,
// plus dy (B, S, H, P) f32 (the gradient of y) and dstates (B, S / L, H,
// P, N) f32 or NULL (no state gradient); outputs dx (B, S, H, P), ddt and
// dcum (B, S, H), dB and dC (B, S, G, N), all f32 and contiguous; ws holds
// ssd_chunk_bwd_workspace_floats floats.  1 <= P <= 128, 1 <= N <= 128.
// Three kernels on `stream`; returns the first cudaError_t (0 = launched).
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* dt, const void* cum,
                                    const void* Bm, const void* Cm, const void* dy,
                                    const void* dstates, void* dx, void* ddt, void* dcum,
                                    void* dB, void* dC, void* ws, int B, int S, int H, int G,
                                    int N, int P, int L, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (S % L != 0 || H % G != 0 || P < 1 || P > 128 || N > 128) return (int)cudaErrorInvalidValue;
  const int ns = bwd::n_slices(H, G);
  if ((long long)B * (S / L) > 65535 || (long long)G * ns > 65535)
    return (int)cudaErrorInvalidValue;
  if ((size_t)P * (N + 1) > bwd::work_floats(N, P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = (size_t)B * S;
  float* col_t = static_cast<float*>(ws);
  float* s_buf = col_t + rows * H;
  float* dB_part = s_buf + rows * H;
  float* dC_part = dB_part + (size_t)ns * rows * G * N;
  float* dcum_f = static_cast<float*>(dcum);
  cudaError_t err =
      is_bf16 ? bwd::launch_t<__nv_bfloat16>(x, dt, cum, Bm, Cm, dy, dstates,
                                             static_cast<float*>(dx), static_cast<float*>(ddt),
                                             dcum_f, col_t, s_buf, dB_part, dC_part, B, S, H, G,
                                             N, P, L, s)
              : bwd::launch_t<float>(x, dt, cum, Bm, Cm, dy, dstates, static_cast<float*>(dx),
                                     static_cast<float*>(ddt), dcum_f, col_t, s_buf, dB_part,
                                     dC_part, B, S, H, G, N, P, L, s);
  if (err != cudaSuccess) return (int)err;
  const size_t n_group = rows * G * N, n_dcum = (size_t)B * (S / L) * H;
  bwd::ssd_chunk_bwd_groups<<<(unsigned)((n_group + bwd::NT - 1) / bwd::NT), bwd::NT, 0, s>>>(
      dB_part, dC_part, static_cast<float*>(dB), static_cast<float*>(dC), n_group, ns);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd::ssd_chunk_bwd_dcum<<<(unsigned)((n_dcum + bwd::NT - 1) / bwd::NT), bwd::NT, 0, s>>>(
      col_t, s_buf, dcum_f, S, H, L, n_dcum);
  return (int)cudaGetLastError();
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

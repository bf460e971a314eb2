// Mamba2 SSD intra-chunk scan (state-space duality) for Hopper, sm_90a,
// forward (G: two routes, below) and backward (G': two routes, after the
// forward's mma namespace).
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

// ------------------------------------------------------------ backward, G'
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
// 8, one chunk of 256, 80 heads, P 64, N 128) ~110 MB against ~16 GFLOP
// (dCB's N-wide products counted per head), 0.033 ms of bytes against
// 0.016 ms at the tensor cores' bf16 rate: bound by bytes.  On f32 FMA
// units (67 TFLOP/s) the products alone take ~0.6 ms.  Two routes, chosen
// by the wrapper before the launch (`ssd_chunk_bwd_route`).
//
// mma route, `bwd_mma::launch` (bf16 x, B, C; f32 dy and dS; P and N
// multiples of 16, P <= 128, N <= 128; L a multiple of 64; 16-byte aligned
// rows).  It answers the four limits of the FMA route below:
//   * every product on mma.sync m16n8k16, bf16 in, f32 accumulators.  C B^T
//     and x dy^T's x are exact bf16; an f32 operand goes in as a hi + lo
//     pair of bf16 (`split_bf16`): hi holds its top 8 bits, lo the next 8
//     of the remainder, so hi + lo is within ~2^-17 of the value.  dy in
//     dAtt, dS against B_j and x_j, and the head-summed dCB against C and B
//     meet an exact operand: two products (the error stays ~2^-17 of each
//     term).  dx = (dt M)^T dy has two f32 operands: hi hi + hi lo + lo hi,
//     three products; the dropped lo lo is ~2^-16 of the term.  Terms add
//     in f32, so every output stays within ~1e-5 of its row's scale,
//     under chip_smoke.py's F32_TOL (2e-4) by an order of magnitude.
//   * each tile pair's scores are formed once: a block owns source tiles j
//     and walks the query tiles i >= j; a warp holds its 16 rows j of
//     C_i B_j^T and dAtt^T in registers (as (j, i)), so dx_j, ddt_j, dB_j's
//     operand and T's sums over i are sums along its own rows.  dt M^T feeds
//     dx's product straight from the accumulators (no shared memory).  T's
//     sums over j (dcum's row term, for the rows i) cross the warps through
//     shared memory, four warps added in order, one partial a source tile.
//   * dCB is summed over the slice's heads in registers (the query tile is
//     the outer loop, the heads the inner one: C_i B_j^T once a tile pair
//     and slice) and written once a tile pair and slice; the slices are
//     added in order (`bwd_mma_sum_slices`) and a groups kernel takes dB =
//     D C and dC = D^T B once per group from the sum (1/HS of a per-head
//     product's work).  dx, ddt and T's column sums of a source row have one
//     owner, which adds each query tile's share to the output in order.
//   * balance: block x owns source tiles x and nt - 1 - x, so every block
//     walks nt + 1 tile pairs (5 at L 256); heads a slice HS from the shapes
//     (`heads_per_slice`: ~264 blocks, two an SM, 4 <= HS <= 8).  mamba2's
//     training launch: HS 5, grid 2 x 16 x 8 = 256 blocks, 25 steps each;
//     hymba's (50 heads, N 16): HS 4, 2 x 13 x 8 = 208.  128 threads; a
//     step's tiles (x_j and dy_i of the head, cum, dt) land by cp.async in
//     one of two stages while the previous step computes.  Shared memory
//     110,080 B at N 128, P 64 and 81,408 B at N 16 (two blocks an SM).
//   * the scratch (`ssd_chunk_bwd_mma_workspace_floats`): the slices' dCB
//     tiles, slices x (batch x chunks) x G x nt(nt+1)/2 x 64 x 64 f32 (21.0
//     MB at mamba2's training shape, 17.0 MB at hymba's), T's row sums per
//     source tile and its column sums and s ((nt + 2) x B x S x H f32, 3.9 /
//     2.5 MB), and with dS the slices' dB state terms (slices x B x S x G x
//     N f32): 24.9 MB at mamba2's training shape against its 110.6 MB of
//     inputs and outputs.
//   * the state terms (with dS), per source tile and head after its walk:
//     u = B_j dS^T and v = x_j dS on mma.sync (dS as hi + lo), dx, ddt and s
//     of the tile's rows added by their owner, v times dt_j w_j summed over
//     the slice's heads.  dcum's kernels add the source tiles' row sums in
//     tile order, less the column term and s; the last row gains sum_j s_j.
//   * as on the FMA route: the mask comes before exp (j <= i), w_j's
//     argument is <= 0, no float atomics (every sum in a fixed order: two
//     launches give the same bits), and the caller passes every output
//     and the scratch.
//
// fma route (`bwd::ssd_chunk_bwd_kernel` + two small finishing kernels,
// one call; f32 or bf16, any P <= 128 and N <= 128), every product on f32
// FMA units:
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

// ------------------------------------------------------- backward, G' (mma)
namespace bwd_mma {

using bf16 = __nv_bfloat16;
constexpr int T = 64;               // rows of a source tile j and of a query tile i
constexpr int NTH = 128;            // 4 warps of 16 source rows
constexpr int MAX_N = 128;
constexpr int MIN_HS = 4;           // heads of a slice, at least (where the group has them)
constexpr int MAX_HS = 8;           // heads of a slice, at most
constexpr int TARGET_BLOCKS = 264;  // two blocks on each of the H100's 132 SMs
constexpr int DS = T + 8;           // bf16 pitch of a dCB tile in the groups kernel
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int n_pairs(int nt) { return nt * (nt + 1) / 2; }

// the place of tile pair (jt, it), jt <= it, among a chunk's n_pairs(nt)
__host__ __device__ inline int pair_index(int jt, int it, int nt) {
  return jt * nt - jt * (jt - 1) / 2 + (it - jt);
}

// heads of a slice: enough slices that the grid holds about TARGET_BLOCKS
// blocks, between MIN_HS (which bounds the slices' scratch) and MAX_HS
// heads a slice.  A function of the shapes only, so that the caller can
// size the scratch.
int heads_per_slice(long long bc, int H, int G, int L) {
  const int R = H / G, lo = R < MIN_HS ? R : MIN_HS;
  const long long base = (long long)((L / T + 1) / 2) * G * bc;
  const long long want = base >= TARGET_BLOCKS ? 1 : TARGET_BLOCKS / base;
  const long long hs = (R + want - 1) / want;
  return (int)(hs < lo ? lo : hs > MAX_HS ? MAX_HS : hs);
}

int n_slices(long long bc, int H, int G, int L) {
  const int hs = heads_per_slice(bc, H, G, L);
  return (H / G + hs - 1) / hs;
}

// the main kernel's shared memory: B_j and C_i (bf16, pitch N + 8), two
// stages of a step's tiles, dy_i as hi and lo bf16 tiles, and the column
// sums of T of two steps
template <int P16>
struct Main {
  static constexpr int P = 16 * P16;
  static constexpr int XS = P + 8;  // bf16 pitch of x_j and of dy's hi / lo rows
  static constexpr int FS = P + 4;  // f32 pitch of dy as it lands
  // a stage: x_j of the head (bf16), dy_i of the head (f32), cum_i, cum_j, dt_j
  static constexpr size_t X_OFF = 0;
  static constexpr size_t DY_OFF = X_OFF + (size_t)T * XS * 2;
  static constexpr size_t CUMI_OFF = DY_OFF + (size_t)T * FS * 4;
  static constexpr size_t CUMJ_OFF = CUMI_OFF + T * 4;
  static constexpr size_t DTJ_OFF = CUMJ_OFF + T * 4;
  static constexpr size_t STAGE = DTJ_OFF + T * 4;
  static size_t bytes(int N) {
    return 2 * (size_t)T * (N + 8) * 2 + 2 * STAGE + 2 * (size_t)T * XS * 2 + 2 * 4 * T * 4;
  }
};

inline size_t groups_bytes(int N) { return 2 * (size_t)T * DS * 2 + (size_t)T * (N + 8) * 2; }

// cp.async 64 rows of `bytes` (a multiple of 16) from src, src + stride, ...
// (strides in bytes) into dst (row pitch in bytes)
__device__ __forceinline__ void load_rows(void* dst, size_t pitch, const void* src, size_t stride,
                                          int bytes) {
  const int ch = bytes / 16;
  for (int e = threadIdx.x; e < T * ch; e += NTH) {
    const int r = e / ch, c = e - r * ch;
    sm90::cp_async16(static_cast<uint8_t*>(dst) + r * pitch + c * 16,
                     static_cast<const uint8_t*>(src) + r * stride + c * 16, 16);
  }
}

// n_rows x cols f32 (cols a multiple of 4; source pitch `stride` floats)
// into hi and lo bf16 tiles of pitch `pitch`
__device__ __forceinline__ void split_rows(bf16* hi, bf16* lo, int pitch, const float* src,
                                           size_t stride, int n_rows, int cols) {
  const int c4 = cols / 4;
  for (int e = threadIdx.x; e < n_rows * c4; e += NTH) {
    const int r = e / c4, c = (e - r * c4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + r * stride + c);
    uint32_t h01, l01, h23, l23;
    mma::split_bf16(v.x, v.y, h01, l01);
    mma::split_bf16(v.z, v.w, h23, l23);
    *reinterpret_cast<uint2*>(hi + r * pitch + c) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(lo + r * pitch + c) = make_uint2(l01, l23);
  }
}

// d += a (bh + bl): an exact bf16 A against an f32 B as hi + lo
__device__ __forceinline__ void mma2(float (&d)[4], const uint32_t (&a)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  sm90::mma_bf16_16816(d, a, bl0, bl1);
  sm90::mma_bf16_16816(d, a, bh0, bh1);
}

// d += (ahi + alo) (bh + bl) less the lo * lo term: both operands f32
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  sm90::mma_bf16_16816(d, alo, bh0, bh1);
  sm90::mma_bf16_16816(d, ahi, bl0, bl1);
  sm90::mma_bf16_16816(d, ahi, bh0, bh1);
}

// grid (ceil(nt / 2), G * slices, batch * chunks): block x owns the source
// tiles x and nt - 1 - x and walks, for each, the query tiles i >= j; a step
// is one (query tile, head of the slice).  Warp w owns source rows 16w ..
// 16w + 15 of the tile; every score tile is held as (rows j, columns i).
template <int P16>
__global__ void __launch_bounds__(NTH)
    bwd_mma_main(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ cum, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ dy,
                 const float* __restrict__ dS, float* __restrict__ dx, float* __restrict__ ddt,
                 float* __restrict__ colT, float* __restrict__ s_out, float* __restrict__ rowT,
                 float* __restrict__ Dpart, float* __restrict__ dBs, int S, int H, int G, int N,
                 int L, int HS) {
  using M = Main<P16>;
  constexpr int P = M::P, XS = M::XS, FS = M::FS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int NS = N + 8, nt = L / T, R = H / G, ns = (R + HS - 1) / HS;
  const int gi = blockIdx.y / ns, sl = blockIdx.y % ns;
  const int h0 = gi * R + sl * HS, nh = min(HS, R - sl * HS);
  const size_t bc = blockIdx.z, nbc = gridDim.z;
  const int nc = S / L;
  const size_t row0 = (bc / nc) * S + (bc % nc) * L;  // the chunk's first sequence row
  const size_t rows = nbc * L;                         // B * S
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int rl = warp * 16 + g;  // the thread's source rows rl and rl + 8 of a tile

  bf16* Bj = reinterpret_cast<bf16*>(smem);
  bf16* Ci = Bj + T * NS;
  uint8_t* stg = reinterpret_cast<uint8_t*>(Ci + T * NS);
  bf16* Dyh = reinterpret_cast<bf16*>(stg + 2 * M::STAGE);
  bf16* Dyl = Dyh + T * XS;
  float* red = reinterpret_cast<float*>(Dyl + T * XS);  // [2 steps][4 warps][T columns]
  const size_t xstride = (size_t)H * P * 2, dystride = (size_t)H * P * 4;
  const size_t bstride = (size_t)G * N * 2;

  // a step's tiles into stage sb; C_i at the first head of a query tile, B_j
  // at the first step of a source tile
  auto load_step = [&](int jt, int it, int hh, int sb, bool ci, bool bj) {
    uint8_t* base = stg + sb * M::STAGE;
    const int h = h0 + hh;
    const size_t j0 = row0 + (size_t)jt * T, i0 = row0 + (size_t)it * T;
    load_rows(base + M::X_OFF, XS * 2, x + (j0 * H + h) * P, xstride, P * 2);
    load_rows(base + M::DY_OFF, FS * 4, dy + (i0 * H + h) * P, dystride, P * 4);
    mma::load_col(reinterpret_cast<float*>(base + M::CUMI_OFF), cum + i0 * H + h, H);
    mma::load_col(reinterpret_cast<float*>(base + M::CUMJ_OFF), cum + j0 * H + h, H);
    mma::load_col(reinterpret_cast<float*>(base + M::DTJ_OFF), dt + j0 * H + h, H);
    if (ci) load_rows(Ci, NS * 2, Cm + (i0 * G + gi) * N, bstride, N * 2);
    if (bj) load_rows(Bj, NS * 2, Bm + (j0 * G + gi) * N, bstride, N * 2);
  };
  // step kk's column sums of T (each query row's sum over this tile's
  // sources), the four warps' sums added in order
  auto flush_rowT = [&](int jt, int kk) {
    if (tid < T) {
      const int it = jt + kk / nh, h = h0 + kk % nh;
      const float* rw = red + (kk & 1) * 4 * T;
      const float v = ((rw[tid] + rw[T + tid]) + rw[2 * T + tid]) + rw[3 * T + tid];
      rowT[((size_t)jt * rows + row0 + (size_t)it * T + tid) * H + h] = v;
    }
  };

  for (int o = 0; o < 2; ++o) {
    const int jt = o == 0 ? (int)blockIdx.x : nt - 1 - (int)blockIdx.x;
    if (o == 1 && jt == (int)blockIdx.x) break;
    const int steps = (nt - jt) * nh;
    const size_t j0 = row0 + (size_t)jt * T;
    const size_t rj[2] = {j0 + rl, j0 + rl + 8};
    __syncthreads();  // the previous source tile's readers are done
    load_step(jt, jt, 0, 0, true, true);
    sm90::cp_async_commit();

    float cb[8][4], dsum[8][4];  // C_i . B_j^T as (j, i); dCB summed over the slice's heads
    for (int k = 0; k < steps; ++k) {
      const int it = jt + k / nh, hh = k % nh, sb = k & 1, h = h0 + hh;
      sm90::cp_async_wait<0>();
      __syncthreads();  // this step's tiles landed; the previous step is done everywhere
      if (k > 0) flush_rowT(jt, k - 1);
      const uint8_t* base = stg + sb * M::STAGE;
      if (hh == 0) {  // a new query tile: C_i . B_j^T once for the slice
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[t8][e] = dsum[t8][e] = 0.f;
        for (int kn = 0; kn < N; kn += 16) {
          uint32_t a[4];
          sm90::ldmatrix_x4(a, Bj + (warp * 16 + lane % 16) * NS + kn + (lane / 16) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            sm90::ldmatrix_x4(
                b, Ci + (np * 16 + lane % 8 + 8 * (lane / 16)) * NS + kn + 8 * ((lane / 8) % 2));
            sm90::mma_bf16_16816(cb[2 * np], a, b[0], b[1]);
            sm90::mma_bf16_16816(cb[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
      split_rows(Dyh, Dyl, XS, reinterpret_cast<const float*>(base + M::DY_OFF), FS, T, P);
      __syncthreads();  // dy's hi / lo visible; C_i read by everyone
      if (k + 1 < steps) {
        const int k2 = k + 1;
        load_step(jt, jt + k2 / nh, k2 % nh, sb ^ 1, k2 % nh == 0, false);
        sm90::cp_async_commit();
      }

      const bf16* Xj = reinterpret_cast<const bf16*>(base + M::X_OFF);
      const float* cumI = reinterpret_cast<const float*>(base + M::CUMI_OFF);
      const float* cumJ = reinterpret_cast<const float*>(base + M::CUMJ_OFF);
      const float* dtJ = reinterpret_cast<const float*>(base + M::DTJ_OFF);
      const bool diag = it == jt;  // also the first visit of these rows for head h
      // ddt, T's row sums and dx of the source rows so far (read early: this
      // step adds to them)
      float ddt_old[2] = {0.f, 0.f}, col_old[2] = {0.f, 0.f};
      if (!diag && qd == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          ddt_old[r] = ddt[rj[r] * H + h];
          col_old[r] = colT[rj[r] * H + h];
        }
      }
      float acc[2 * P16][4];
      float* dxr[2] = {dx + (rj[0] * H + h) * (size_t)P, dx + (rj[1] * H + h) * (size_t)P};
#pragma unroll
      for (int n8 = 0; n8 < 2 * P16; ++n8) {
        const int p = n8 * 8 + 2 * qd;
        const float2 zero = make_float2(0.f, 0.f);
        const float2 u = diag ? zero : *reinterpret_cast<const float2*>(dxr[0] + p);
        const float2 v = diag ? zero : *reinterpret_cast<const float2*>(dxr[1] + p);
        acc[n8][0] = u.x;
        acc[n8][1] = u.y;
        acc[n8][2] = v.x;
        acc[n8][3] = v.y;
      }

      // dAtt^T = x_j . dy_i^T (rows j, columns i): x exact, dy as hi + lo
      float da[8][4];
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
        for (int e = 0; e < 4; ++e) da[t8][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < P; kp += 16) {
        uint32_t a[4];
        sm90::ldmatrix_x4(a, Xj + (warp * 16 + lane % 16) * XS + kp + (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const int off = (np * 16 + lane % 8 + 8 * (lane / 16)) * XS + kp + 8 * ((lane / 8) % 2);
          uint32_t bh[4], bl[4];
          sm90::ldmatrix_x4(bh, Dyh + off);
          sm90::ldmatrix_x4(bl, Dyl + off);
          mma2(da[2 * np], a, bh[0], bh[1], bl[0], bl[1]);
          mma2(da[2 * np + 1], a, bh[2], bh[3], bl[2], bl[3]);
        }
      }

      // per element (row j, column i): the decay, M, dCB and T; the row sums
      // of dAtt M (ddt) and of T (dcum's column term), T's column sums
      const float cj[2] = {cumJ[rl], cumJ[rl + 8]}, dj[2] = {dtJ[rl], dtJ[rl + 8]};
      float g_sum[2] = {0.f, 0.f}, t_row[2] = {0.f, 0.f}, t_col[8][2];
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) {
        t_col[t8][0] = t_col[t8][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t8 * 8 + 2 * qd + (e & 1), row = rl + (e >> 1) * 8;
          // the mask comes before exp: where i < j, cum_i - cum_j > 0
          const float ex =
              (!diag || col >= row) ? exp2f((cumI[col] - cj[e >> 1]) * LOG2E) : 0.f;
          const float m = cb[t8][e] * ex;
          const float dcb = da[t8][e] * (dj[e >> 1] * ex);
          const float t = dcb * cb[t8][e];
          g_sum[e >> 1] = fmaf(da[t8][e], m, g_sum[e >> 1]);
          t_row[e >> 1] += t;
          t_col[t8][e & 1] += t;
          dsum[t8][e] += dcb;
          da[t8][e] = m * dj[e >> 1];  // dt_j M_ij: the A operand of dx
        }
      }
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8)
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // over the 8 row groups of the warp
          float v = t_col[t8][c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          t_col[t8][c] = v;
        }
      if (g == 0) {
        float* rw = red + (sb * 4 + warp) * T;
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8)
          *reinterpret_cast<float2*>(rw + t8 * 8 + 2 * qd) = make_float2(t_col[t8][0], t_col[t8][1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // over the quad
        g_sum[r] += __shfl_xor_sync(0xffffffffu, g_sum[r], 1);
        g_sum[r] += __shfl_xor_sync(0xffffffffu, g_sum[r], 2);
        t_row[r] += __shfl_xor_sync(0xffffffffu, t_row[r], 1);
        t_row[r] += __shfl_xor_sync(0xffffffffu, t_row[r], 2);
      }
      if (qd == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t o2 = rj[r] * H + h;
          ddt[o2] = diag ? g_sum[r] : ddt_old[r] + g_sum[r];
          colT[o2] = diag ? t_row[r] : col_old[r] + t_row[r];
        }
      }

      // dx_j += (dt_j M)^T dy_i: both f32, three products; A from registers
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t ahi[4], alo[4];
        mma::split_bf16(da[2 * kb][0], da[2 * kb][1], ahi[0], alo[0]);
        mma::split_bf16(da[2 * kb][2], da[2 * kb][3], ahi[1], alo[1]);
        mma::split_bf16(da[2 * kb + 1][0], da[2 * kb + 1][1], ahi[2], alo[2]);
        mma::split_bf16(da[2 * kb + 1][2], da[2 * kb + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int pn = 0; pn < P16; ++pn) {
          const int off = (kb * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * XS + pn * 16 + 8 * (lane / 16);
          uint32_t bh[4], bl[4];
          sm90::ldmatrix_x4_trans(bh, Dyh + off);
          sm90::ldmatrix_x4_trans(bl, Dyl + off);
          mma3(acc[2 * pn], ahi, alo, bh[0], bh[1], bl[0], bl[1]);
          mma3(acc[2 * pn + 1], ahi, alo, bh[2], bh[3], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int n8 = 0; n8 < 2 * P16; ++n8) {
        const int p = n8 * 8 + 2 * qd;
        *reinterpret_cast<float2*>(dxr[0] + p) = make_float2(acc[n8][0], acc[n8][1]);
        *reinterpret_cast<float2*>(dxr[1] + p) = make_float2(acc[n8][2], acc[n8][3]);
      }

      if (hh == nh - 1) {  // the slice's dCB of this tile pair, for the groups kernel
        float* dp = Dpart + ((((size_t)sl * nbc + bc) * G + gi) * n_pairs(nt) +
                             pair_index(jt, it, nt)) * (T * T);
#pragma unroll
        for (int t8 = 0; t8 < 8; ++t8) {
          const int c = t8 * 8 + 2 * qd;
          *reinterpret_cast<float2*>(dp + rl * T + c) = make_float2(dsum[t8][0], dsum[t8][1]);
          *reinterpret_cast<float2*>(dp + (rl + 8) * T + c) = make_float2(dsum[t8][2], dsum[t8][3]);
        }
      }
    }
    __syncthreads();
    flush_rowT(jt, steps - 1);
    if (dS == nullptr) continue;

    // the chunk end state's gradient, head by head: u = dS B_j (dx, ddt, s)
    // and v = dS^T x_j (dB's state term, summed over the slice's heads).
    // dS's hi / lo tiles lie over the stages, x_j over dy's hi tile.
    bf16* Sh = reinterpret_cast<bf16*>(stg);
    bf16* Sl = Sh + P * NS;
    bf16* Xs = Dyh;
    for (int hh = 0; hh < nh; ++hh) {
      const int h = h0 + hh;
      __syncthreads();  // the previous readers of these buffers are done
      load_rows(Xs, XS * 2, x + (j0 * H + h) * P, xstride, P * 2);
      sm90::cp_async_commit();
      split_rows(Sh, Sl, NS, dS + (bc * H + h) * (size_t)P * N, N, P, N);
      sm90::cp_async_wait<0>();
      __syncthreads();
      float u[2 * P16][4];
#pragma unroll
      for (int n8 = 0; n8 < 2 * P16; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[n8][e] = 0.f;
      for (int kn = 0; kn < N; kn += 16) {
        uint32_t a[4];
        sm90::ldmatrix_x4(a, Bj + (warp * 16 + lane % 16) * NS + kn + (lane / 16) * 8);
#pragma unroll
        for (int pn = 0; pn < P16; ++pn) {
          const int off = (pn * 16 + lane % 8 + 8 * (lane / 16)) * NS + kn + 8 * ((lane / 8) % 2);
          uint32_t bh[4], bl[4];
          sm90::ldmatrix_x4(bh, Sh + off);
          sm90::ldmatrix_x4(bl, Sl + off);
          mma2(u[2 * pn], a, bh[0], bh[1], bl[0], bl[1]);
          mma2(u[2 * pn + 1], a, bh[2], bh[3], bl[2], bl[3]);
        }
      }
      const float cum_last = cum[(row0 + L - 1) * H + h];
      float cr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const size_t o2 = rj[r] * H + h;
        const float w = exp2f((cum_last - cum[o2]) * LOG2E);  // argument <= 0
        cr[r] = dt[o2] * w;
        float xu = 0.f;
        float* dxo = dx + o2 * P;
#pragma unroll
        for (int n8 = 0; n8 < 2 * P16; ++n8) {
          const int p = n8 * 8 + 2 * qd;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(Xs + (rl + 8 * r) * XS + p));
          xu = fmaf(xv.x, u[n8][2 * r], xu);
          xu = fmaf(xv.y, u[n8][2 * r + 1], xu);
          float2 d = *reinterpret_cast<const float2*>(dxo + p);
          d.x = fmaf(cr[r], u[n8][2 * r], d.x);
          d.y = fmaf(cr[r], u[n8][2 * r + 1], d.y);
          *reinterpret_cast<float2*>(dxo + p) = d;
        }
        xu += __shfl_xor_sync(0xffffffffu, xu, 1);
        xu += __shfl_xor_sync(0xffffffffu, xu, 2);
        if (qd == 0) {
          ddt[o2] = fmaf(w, xu, ddt[o2]);
          s_out[o2] = cr[r] * xu;
        }
      }
      for (int n0 = 0; n0 < N; n0 += 64) {
        const int nq = min(4, (N - n0) / 16);
        float v[8][4];
#pragma unroll
        for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[j8][e] = 0.f;
#pragma unroll
        for (int kp = 0; kp < P; kp += 16) {
          uint32_t a[4];
          sm90::ldmatrix_x4(a, Xs + (warp * 16 + lane % 16) * XS + kp + (lane / 16) * 8);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= nq) break;
            const int off = (kp + lane % 8 + 8 * ((lane / 8) % 2)) * NS + n0 + q * 16 + 8 * (lane / 16);
            uint32_t bh[4], bl[4];
            sm90::ldmatrix_x4_trans(bh, Sh + off);
            sm90::ldmatrix_x4_trans(bl, Sl + off);
            mma2(v[2 * q], a, bh[0], bh[1], bl[0], bl[1]);
            mma2(v[2 * q + 1], a, bh[2], bh[3], bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* db = dBs + (((size_t)sl * rows + rj[r]) * G + gi) * N + n0;
#pragma unroll
          for (int j8 = 0; j8 < 8; ++j8) {
            if (j8 >= 2 * nq) break;
            const int n = j8 * 8 + 2 * qd;
            float2 d = hh == 0 ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(db + n);
            d.x = fmaf(cr[r], v[j8][2 * r], d.x);
            d.y = fmaf(cr[r], v[j8][2 * r + 1], d.y);
            *reinterpret_cast<float2*>(db + n) = d;
          }
        }
      }
    }
  }
}

// a[e] = a[e] + a[count + e] + ... over ns slices of `count` floats (a
// multiple of 4), in slice order
__global__ void __launch_bounds__(NTH)
    bwd_mma_sum_slices(float* __restrict__ a, size_t count, int ns) {
  const size_t n4 = count / 4;
  for (size_t e = (size_t)blockIdx.x * NTH + threadIdx.x; e < n4; e += (size_t)gridDim.x * NTH) {
    float4 v = reinterpret_cast<const float4*>(a)[e];
    for (int s = 1; s < ns; ++s) {
      const float4 w = reinterpret_cast<const float4*>(a + (size_t)s * count)[e];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    reinterpret_cast<float4*>(a)[e] = v;
  }
}

// grid (2 * nt, G, batch * chunks): block x < nt takes dB of tile t = x of
// a group, the others dC of tile t = x - nt, from the head-summed dCB
// tiles D (rows j, columns i): dB_t = sum_{i >= t} D(t, i) C_i (plus the
// state term dBs) and dC_t = sum_{j <= t} D(j, t)^T B_j, D as hi + lo
// bf16 pairs (two products), C and B exact.  Warp w owns rows 16w .. 16w +
// 15 of the tile and all N columns.
__global__ void __launch_bounds__(NTH)
    bwd_mma_groups(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   const float* __restrict__ D, const float* __restrict__ dBs,
                   float* __restrict__ dB, float* __restrict__ dC, int S, int G, int N, int L) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int NS = N + 8, nt = L / T, gi = blockIdx.y;
  const bool dc = (int)blockIdx.x >= nt;  // block-uniform
  const int t = (int)blockIdx.x - (dc ? nt : 0);
  const size_t bc = blockIdx.z;
  const int nc = S / L;
  const size_t row0 = (bc / nc) * S + (bc % nc) * L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4, rl = warp * 16 + g;
  bf16* Dh = reinterpret_cast<bf16*>(smem);
  bf16* Dl = Dh + T * DS;
  bf16* Ts = Dl + T * DS;  // C_i (dB) or B_j (dC)
  const float* Dg = D + (bc * G + gi) * (size_t)n_pairs(nt) * T * T;
  const size_t bstride = (size_t)G * N * 2;

  float acc[16][4];
#pragma unroll
  for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j8][e] = 0.f;
  const int first = dc ? 0 : t, last = dc ? t : nt - 1;
  for (int o = first; o <= last; ++o) {
    __syncthreads();  // the previous tile's readers are done
    const size_t r0 = row0 + (size_t)o * T;
    load_rows(Ts, NS * 2, (dc ? Bm : Cm) + (r0 * G + gi) * N, bstride, N * 2);
    sm90::cp_async_commit();
    const int pidx = dc ? pair_index(o, t, nt) : pair_index(t, o, nt);
    const float4* src = reinterpret_cast<const float4*>(Dg + (size_t)pidx * T * T);
    float4 v[T * T / 4 / NTH];  // the tile's loads issued together
#pragma unroll
    for (int q = 0; q < T * T / 4 / NTH; ++q) v[q] = src[tid + q * NTH];
#pragma unroll
    for (int q = 0; q < T * T / 4 / NTH; ++q) {
      const int e = tid + q * NTH, r = e / (T / 4), c = (e % (T / 4)) * 4;
      uint32_t h01, l01, h23, l23;
      mma::split_bf16(v[q].x, v[q].y, h01, l01);
      mma::split_bf16(v[q].z, v[q].w, h23, l23);
      *reinterpret_cast<uint2*>(Dh + r * DS + c) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(Dl + r * DS + c) = make_uint2(l01, l23);
    }
    sm90::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      uint32_t ah[4], al[4];
      if (!dc) {  // A = D rows t (j), k = i
        const int off = (warp * 16 + lane % 16) * DS + kb * 16 + (lane / 16) * 8;
        sm90::ldmatrix_x4(ah, Dh + off);
        sm90::ldmatrix_x4(al, Dl + off);
      } else {    // A = D^T: rows t (i), k = j, from the (j, i) tile
        const int off = (kb * 16 + 8 * (lane / 16) + lane % 8) * DS + warp * 16 + 8 * ((lane / 8) % 2);
        sm90::ldmatrix_x4_trans(ah, Dh + off);
        sm90::ldmatrix_x4_trans(al, Dl + off);
      }
#pragma unroll
      for (int nq = 0; nq < 8; ++nq) {
        if (nq >= N / 16) break;
        const int off = (kb * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * NS + nq * 16 + 8 * (lane / 16);
        uint32_t b[4];
        sm90::ldmatrix_x4_trans(b, Ts + off);
        sm90::mma_bf16_16816(acc[2 * nq], al, b[0], b[1]);
        sm90::mma_bf16_16816(acc[2 * nq], ah, b[0], b[1]);
        sm90::mma_bf16_16816(acc[2 * nq + 1], al, b[2], b[3]);
        sm90::mma_bf16_16816(acc[2 * nq + 1], ah, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t o2 = ((row0 + (size_t)t * T + rl + 8 * r) * G + gi) * N;
    float* out = (dc ? dC : dB) + o2;
#pragma unroll
    for (int j8 = 0; j8 < 16; ++j8) {
      if (j8 >= N / 8) break;
      const int n = j8 * 8 + 2 * qd;
      float2 d = make_float2(acc[j8][2 * r], acc[j8][2 * r + 1]);
      if (!dc && dBs != nullptr) {
        const float2 s = *reinterpret_cast<const float2*>(dBs + o2 + n);
        d.x += s.x;
        d.y += s.y;
      }
      *reinterpret_cast<float2*>(out + n) = d;
    }
  }
}

// dcum per (row, head): the query row's sums of T over the source tiles
// j <= i (added in tile order), less its column term and state term
__global__ void __launch_bounds__(NTH)
    bwd_mma_dcum(const float* __restrict__ rowT, const float* __restrict__ colT,
                 const float* __restrict__ s_in, float* __restrict__ dcum, int H, int L,
                 size_t rows) {
  const size_t e = (size_t)blockIdx.x * NTH + threadIdx.x;
  if (e >= rows * H) return;
  const int i = (int)((e / H) % L);
  float v = 0.f;
  for (int jt = 0; jt <= i / T; ++jt) v += rowT[(size_t)jt * rows * H + e];
  v -= colT[e];
  if (s_in != nullptr) v -= s_in[e];
  dcum[e] = v;
}

// the chunk's last row gains the state term's total, per (batch x chunk,
// head), summed in row order
__global__ void __launch_bounds__(NTH)
    bwd_mma_dcum_last(const float* __restrict__ s_in, float* __restrict__ dcum, int S, int H,
                      int L, size_t count) {
  const size_t e = (size_t)blockIdx.x * NTH + threadIdx.x;
  if (e >= count) return;
  const size_t bc = e / H;
  const int h = (int)(e % H), nc = S / L;
  const size_t row0 = (bc / nc) * S + (bc % nc) * L;
  float total = 0.f;
#pragma unroll 8
  for (int i = 0; i < L; ++i) total += s_in[(row0 + i) * H + h];
  dcum[(row0 + L - 1) * H + h] += total;
}

// the scratch, in floats: the slices' dCB tiles, T's row sums per source
// tile, T's column sums, the state term s and (with dS) the slices' dB
// state terms
size_t workspace_floats(long long B, int S, int H, int G, int N, int L, bool states) {
  const long long bc = B * (S / L), rows = B * S;
  const int nt = L / T, ns = n_slices(bc, H, G, L);
  return (size_t)ns * bc * G * n_pairs(nt) * T * T + (size_t)(nt + 2) * rows * H +
         (states ? (size_t)ns * rows * G * N : 0);
}

template <int P16>
cudaError_t launch(const void* x, const void* dt, const void* cum, const void* Bm, const void* Cm,
                   const void* dy, const void* dS, float* dx, float* ddt, float* dcum, float* dB,
                   float* dC, float* ws, int B, int S, int H, int G, int N, int L,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_mma_main<P16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Main<P16>::bytes(MAX_N));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long bc = (long long)B * (S / L);
  const size_t rows = (size_t)B * S;
  const int nt = L / T, hs = heads_per_slice(bc, H, G, L), ns = (H / G + hs - 1) / hs;
  if ((long long)G * ns > 65535 || bc > 65535) return cudaErrorInvalidValue;
  const size_t d_count = (size_t)bc * G * n_pairs(nt) * T * T;
  float* Dp = ws;
  float* rowT = Dp + ns * d_count;
  float* colT = rowT + (size_t)nt * rows * H;
  float* s_buf = colT + rows * H;
  float* dBs = s_buf + rows * H;
  const bool states = dS != nullptr;
  bwd_mma_main<P16><<<dim3((nt + 1) / 2, G * ns, (unsigned)bc), NTH, Main<P16>::bytes(N),
                      stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(cum),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const float*>(dy),
      static_cast<const float*>(dS), dx, ddt, colT, s_buf, rowT, Dp, dBs, S, H, G, N, L, hs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto sum = [&](float* a, size_t count) {
    const size_t blocks = (count / 4 + NTH - 1) / NTH;
    bwd_mma_sum_slices<<<(unsigned)(blocks < 4096 ? blocks : 4096), NTH, 0, stream>>>(a, count,
                                                                                      ns);
    return cudaGetLastError();
  };
  if (ns > 1) {
    if ((err = sum(Dp, d_count)) != cudaSuccess) return err;
    if (states && (err = sum(dBs, rows * G * N)) != cudaSuccess) return err;
  }
  bwd_mma_groups<<<dim3(2 * nt, G, (unsigned)bc), NTH, groups_bytes(N), stream>>>(
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), Dp, states ? dBs : nullptr,
      dB, dC, S, G, N, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t n_rows = rows * H, n_dcum = (size_t)bc * H;
  bwd_mma_dcum<<<(unsigned)((n_rows + NTH - 1) / NTH), NTH, 0, stream>>>(
      rowT, colT, states ? s_buf : nullptr, dcum, H, L, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (states) {
    bwd_mma_dcum_last<<<(unsigned)((n_dcum + NTH - 1) / NTH), NTH, 0, stream>>>(s_buf, dcum, S,
                                                                               H, L, n_dcum);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace bwd_mma

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

// The scratch of ssd_chunk_bwd_mma_launch, in floats: the head slices'
// summed dCB tiles, T's row sums per source tile, T's column sums and the
// state term (B * S * H each), and with_states the slices' dB state terms.
// -1 on shapes the mma route does not take.
extern "C" long long ssd_chunk_bwd_mma_workspace_floats(int B, int S, int H, int G, int N, int L,
                                                         int with_states) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || L <= 0) return -1;
  if (S % L != 0 || H % G != 0 || L % bwd_mma::T != 0) return -1;
  return (long long)bwd_mma::workspace_floats(B, S, H, G, N, L, with_states != 0);
}

// G' on the mma route: x, B, C bf16, dy and dstates f32, all at 16-byte
// aligned addresses; P and N multiples of 16 with P <= 128 and N <= 128; L
// a multiple of 64.  The same arguments as ssd_chunk_bwd_launch less the
// dtype flag; ws holds ssd_chunk_bwd_mma_workspace_floats floats.  Five
// kernels on `stream` (three without dstates... see the note above); returns
// the first cudaError_t (0 = launched).
extern "C" int ssd_chunk_bwd_mma_launch(const void* x, const void* dt, const void* cum,
                                        const void* Bm, const void* Cm, const void* dy,
                                        const void* dstates, void* dx, void* ddt, void* dcum,
                                        void* dB, void* dC, void* ws, int B, int S, int H, int G,
                                        int N, int P, int L, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || N <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (S % L != 0 || H % G != 0 || L % bwd_mma::T != 0) return (int)cudaErrorInvalidValue;
  if (P % 16 != 0 || P < 16 || P > 128 || N % 16 != 0 || N > bwd_mma::MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_BWD_MMA(P16)                                                                       \
  (int)bwd_mma::launch<P16>(x, dt, cum, Bm, Cm, dy, dstates, static_cast<float*>(dx),          \
                            static_cast<float*>(ddt), static_cast<float*>(dcum),               \
                            static_cast<float*>(dB), static_cast<float*>(dC),                  \
                            static_cast<float*>(ws), B, S, H, G, N, L, s)
  switch (P / 16) {
    case 1: return SSD_BWD_MMA(1);
    case 2: return SSD_BWD_MMA(2);
    case 3: return SSD_BWD_MMA(3);
    case 4: return SSD_BWD_MMA(4);
    case 5: return SSD_BWD_MMA(5);
    case 6: return SSD_BWD_MMA(6);
    case 7: return SSD_BWD_MMA(7);
    default: return SSD_BWD_MMA(8);
  }
#undef SSD_BWD_MMA
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

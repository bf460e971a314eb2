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

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

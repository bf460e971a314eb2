// Fused LoRA projection y = x @ W + scale * (x @ A) @ B for Hopper, sm_90a.
//
// Replaces the TPU kernel `lora_matmul` / `_lora_kernel` in
// src/repro/kernels/lora_matmul.py (pallas_call at line 55).
//
// What bounds it on the H100: at the training shapes (M = 8 x 136 = 1088
// rows, K = N = 1280 or 4096) the dense product x@W does 2*M*K*N flops on
// M*K + K*N + M*N values, ~300-1000 flops a byte, so it is operations-bound
// at the tensor cores' rate (989 TFLOP/s bf16).  The adapter adds O(r)
// columns of work and traffic (r = 8).
//
// Two routes, chosen by the wrapper before the launch
// (`lora_matmul_route`):
//
// wgmma route (bf16; K, N and r multiples of 8, r <= 32; 16-byte aligned
// operands), `lora_matmul_kernel_wgmma`:
//   * warp-specialised blocks: one producer warpgroup whose first thread
//     keeps TMA loads in flight into a ring of 4 stages, and consumer
//     warpgroups that each own 64 rows of the output tile.  A stage holds
//     the tile's rows of x and columns of W for 64 of K, and A^T's r x 64;
//     `full` and `empty` mbarriers per stage hand them between the roles.
//     A consumer keeps one stage's wgmmas in flight while it starts the
//     next stage's, and frees a stage once its products are done.
//   * two tile shapes, by problem (`big_tile`).  192 x 192 (3 consumers,
//     512 threads) at the LLM's N = 4096: 6 x 22 = 132 tiles, one wave on
//     132 SMs, loading 415 MB of tiles from L2 where 128 x 96 tiles load
//     710 MB and 128 x 128 ones 604 MB (those two ran at one speed: L2,
//     not the waves, held them).  128 x 96 (2 consumers, 384
//     threads) at the SLM's N = 1280: 14 x 9 = 126 tiles, one wave, where
//     192 x 192 would leave 42 tiles of 2.25 times the work; and at every
//     rank above 8.
//   * W (K, N) of the forward is N-contiguous: the MN-major B operand of
//     wgmma (transpose bit set), loaded as three 32-column boxes with the
//     64-byte swizzle.  W (N, K) of the backward's dx is K-major, the
//     canonical layout, with the 128-byte swizzle like x and A^T.
//   * t = x@A rides in the same K loop: a second wgmma with N = 8 per 8
//     columns of A^T (r x K, K-major, like W in the dx mode) reads the x
//     tile already in shared memory.  A thread's rows of t are its rows of
//     the output, so a shuffle among the 4 lanes of a row gathers all r
//     columns; the epilogue adds scale * t@B from B's r x columns tile (in
//     shared memory) with r f32 FMAs per output, rounds once to bf16 and
//     stores.  The (M, N) LoRA intermediate never reaches device memory.
//   * TMA zero-fills loads past M, N and K, and the epilogue's stores are
//     guarded, so M = 1088 (8.5 tiles) needs no padding.
//   * the tensor maps are encoded on the host at every launch (three
//     cuTensorMapEncodeTiled calls, found through cudaGetDriverEntryPoint
//     so that the library needs no -lcuda) and passed as
//     __grid_constant__ parameters.
//
// fma route (f32, or shapes TMA cannot take), `lora_matmul_kernel`:
//   * grid (N / 64, M / 64), 256 threads; each thread owns a 4 x 4 tile of
//     the 64 x 64 output block.  The K loop stages a 64 x 16 tile of x (kept
//     transposed in shared memory) and a 16 x 64 tile of W in f32, and the
//     products are f32 FMAs from shared memory.
//   * in the same K loop the block accumulates its 64 x r tile t = x@A in
//     registers (r <= 32, A's 16 x r tile staged beside W's); the epilogue
//     adds scale * t@B before the one rounding to the output dtype.
//   * ragged M, N and K are masked inside the kernel, and trans_w = 1 reads
//     W as the (N, K) row-major matrix whose transpose is the K x N operand.
// The backward's dx = dy@W^T + s*(dy@B^T)@A^T is this same function with W
// read transposed and the r-wide B^T, A^T passed as the adapter pair.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------- wgmma route

constexpr int WK = 64;     // K per stage: one 128-byte swizzle row of bf16
constexpr int WST = 4;     // stages in the ring
constexpr int WBOX_N = 32; // the forward's W arrives in 32-column boxes (64-byte swizzle)

// A tile shape: NC consumer warpgroups of 64 rows each, BN columns.
template <int NC, int BN>
struct WTile {
  static constexpr int BM = 64 * NC;
  static constexpr int NT = 128 * (NC + 1);  // a producer warpgroup and NC consumers
  static constexpr int X_BYTES = BM * WK * 2;
  static constexpr int W_BYTES = WK * BN * 2;
  static constexpr int AT_BYTES = RMAX * WK * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES + AT_BYTES;
  static constexpr int SMEM = 1024 + WST * STAGE_BYTES + RMAX * BN * 2 + 2 * WST * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "stages must keep the swizzle atoms aligned");
};

// TRANS_W: W is (N, K), K-major (the backward's dx); else (K, N), MN-major.
// RC = r / 8.  at: A^T (r, K) row-major; b: B (r, N) with element strides
// (sbj, sbn).
template <int NC, int BN, int TRANS_W, int RC>
__global__ void __launch_bounds__(WTile<NC, BN>::NT, 1)
lora_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap tmx,
                         const __grid_constant__ CUtensorMap tmw,
                         const __grid_constant__ CUtensorMap tma, const __nv_bfloat16* __restrict__ b,
                         long long sbj, long long sbn, __nv_bfloat16* __restrict__ y, int M, int N,
                         int K, float scale) {
  using T = WTile<NC, BN>;
  constexpr int R = RC * 8;
  constexpr int NACC = BN / 2;  // accumulators a thread: 64 rows x BN over 128 threads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + WST * T::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + RMAX * BN);
  uint64_t* empty = full + WST;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int nk = (K + WK - 1) / WK;

  for (int e = tid; e < R * BN; e += T::NT) {
    const int j = e / BN, n = e % BN;
    const int gn = n0 + n;
    Bs[j * BN + n] = gn < N ? b[j * sbj + gn * sbn] : __float2bfloat16(0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < WST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NC);  // one arrival per consumer warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // producer: one thread starts every load
    if (tid == 0) {
      constexpr uint32_t bytes = T::X_BYTES + T::W_BYTES + R * WK * 2;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WST;
        if (kt >= WST) sm90::mbar_wait(&empty[s], ((kt / WST) + 1) & 1);
        uint8_t* st = smem + s * T::STAGE_BYTES;
        sm90::mbar_arrive_expect_tx(&full[s], bytes);
        sm90::tma_load_2d(st, &tmx, &full[s], kt * WK, m0);
        if (TRANS_W) {
          sm90::tma_load_2d(st + T::X_BYTES, &tmw, &full[s], kt * WK, n0);
        } else {
#pragma unroll
          for (int i = 0; i < BN / WBOX_N; ++i)
            sm90::tma_load_2d(st + T::X_BYTES + i * WBOX_N * WK * 2, &tmw, &full[s],
                              n0 + i * WBOX_N, kt * WK);
        }
        sm90::tma_load_2d(st + T::X_BYTES + T::W_BYTES, &tma, &full[s], kt * WK, 0);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows m0 + 64c .. m0 + 64c + 63
  const int c = wg - 1;
  float acc[NACC];
  float tacc[RC][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) tacc[i][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WST;
    sm90::mbar_wait(&full[s], (kt / WST) & 1);
    const uint8_t* st = smem + s * T::STAGE_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      // K-major tiles advance 32 bytes along a swizzled row per 16 of K;
      // the MN-major W tile advances 16 rows of 64 bytes
      const uint64_t da = sm90::wgmma_desc<1>(st + c * (64 * 128) + kk * 32, 16, 1024);
      const uint64_t dw =
          TRANS_W ? sm90::wgmma_desc<1>(st + T::X_BYTES + kk * 32, 16, 1024)
                  : sm90::wgmma_desc<2>(st + T::X_BYTES + kk * 16 * 64, WBOX_N * WK * 2, 8 * 64);
      sm90::wgmma_m64k16<BN, TRANS_W ? 0 : 1>(acc, da, dw);
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const uint64_t dt = sm90::wgmma_desc<1>(
            st + T::X_BYTES + T::W_BYTES + j * 1024 + kk * 32, 16, 1024);
        sm90::wgmma_m64n8k16(tacc[j], da, dt);
      }
    }
    sm90::wgmma_commit();
    // keep this stage's products in flight; the previous stage's are done
    sm90::wgmma_wait<1>();
    if (kt > 0 && tid % 128 == 0) sm90::mbar_arrive(&empty[(kt - 1) % WST]);
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NACC; ++i) sm90::fence_reg(acc[i]);
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::fence_reg(tacc[i][e]);

  // epilogue: gather the r columns of t for the thread's two rows from the
  // 4 lanes that share them, then y = acc + scale * t@B, rounded once
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int q = lane % 4;
  float t0[R], t8[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int src = (lane & ~3) | ((j & 7) >> 1);
    t0[j] = __shfl_sync(0xffffffffu, tacc[j >> 3][j & 1], src);
    t8[j] = __shfl_sync(0xffffffffu, tacc[j >> 3][2 + (j & 1)], src);
  }
  const int gm0 = m0 + c * 64 + warp * 16 + lane / 4;
  const int gm8 = gm0 + 8;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int n = i * 8 + 2 * q;
    const int gn = n0 + n;
    if (gn >= N) continue;  // N is a multiple of 8: both columns or neither
    float l00 = 0.f, l01 = 0.f, l80 = 0.f, l81 = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Bs + j * BN + n));
      l00 = fmaf(t0[j], bb.x, l00);
      l01 = fmaf(t0[j], bb.y, l01);
      l80 = fmaf(t8[j], bb.x, l80);
      l81 = fmaf(t8[j], bb.y, l81);
    }
    if (gm0 < M)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)gm0 * N + gn) =
          __floats2bfloat162_rn(acc[4 * i] + scale * l00, acc[4 * i + 1] + scale * l01);
    if (gm8 < M)
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)gm8 * N + gn) =
          __floats2bfloat162_rn(acc[4 * i + 2] + scale * l80, acc[4 * i + 3] + scale * l81);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix read in (box_rows, box_cols) tiles
// with the given swizzle; zeros past its edges.
bool encode_2d(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int rows, int cols,
               int box_rows, int box_cols,
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BN, int TRANS_W, int RC>
cudaError_t launch_wgmma_typed(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& ma,
                               const __nv_bfloat16* b, long long sbj, long long sbn,
                               __nv_bfloat16* y, int M, int N, int K, float scale,
                               cudaStream_t stream) {
  using T = WTile<NC, BN>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(lora_matmul_kernel_wgmma<NC, BN, TRANS_W, RC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM);
  lora_matmul_kernel_wgmma<NC, BN, TRANS_W, RC><<<grid, T::NT, T::SMEM, stream>>>(
      mx, mw, ma, b, sbj, sbn, y, M, N, K, scale);
  return cudaGetLastError();
}

// the 128 x 96 tile at any rank
template <int TRANS_W>
cudaError_t launch_wgmma_rank(int r, const CUtensorMap& mx, const CUtensorMap& mw,
                              const CUtensorMap& ma, const __nv_bfloat16* b, long long sbj,
                              long long sbn, __nv_bfloat16* y, int M, int N, int K, float scale,
                              cudaStream_t s) {
#define LORA_RANK(RC) \
  launch_wgmma_typed<2, 96, TRANS_W, RC>(mx, mw, ma, b, sbj, sbn, y, M, N, K, scale, s)
  switch (r) {
    case 8: return LORA_RANK(1);
    case 16: return LORA_RANK(2);
    case 24: return LORA_RANK(3);
    case 32: return LORA_RANK(4);
    default: return cudaErrorInvalidValue;
  }
#undef LORA_RANK
}

// The tile for an (M, N) output of rank r: 192 x 192 when such tiles fill
// at least three quarters of the 132 SMs (fewer bytes from L2 per output)
// and r = 8 (its 512 threads get 128 registers each: 96 accumulators and
// t's 2r gathered values fit only at r = 8), else 128 x 96.
bool big_tile(int M, int N, int r) {
  const int tiles = ((M + 191) / 192) * ((N + 191) / 192);
  return r == 8 && tiles >= 99;
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

// The wgmma route, bf16 only: x (M, K); W (K, N), or (N, K) when trans_w;
// at = A^T (r, K) row-major; B (r, N) at element strides (sbj, sbn); y (M,
// N).  K, N and r multiples of 8, r <= 32, K > 0; x, W and at 16-byte
// aligned.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int lora_matmul_wgmma_launch(const void* x, const void* w, const void* at,
                                        const void* b, long long sbj, long long sbn, void* y,
                                        int M, int N, int K, int r, int trans_w, float scale,
                                        void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 8 || N % 8 || r % 8 || r < 8 || r > RMAX) return (int)cudaErrorInvalidValue;
  if ((M + 127) / 128 > 65535) return (int)cudaErrorInvalidConfiguration;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const bool big = big_tile(M, N, r);
  const int bm = big ? 192 : 128, bn = big ? 192 : 96;
  CUtensorMap mx, mw, ma;
  const bool ok = encode_2d(enc, &mx, x, M, K, bm, WK) &&
                  (trans_w ? encode_2d(enc, &mw, w, N, K, bn, WK)
                           : encode_2d(enc, &mw, w, K, N, WK, WBOX_N,
                                       CU_TENSOR_MAP_SWIZZLE_64B)) &&
                  encode_2d(enc, &ma, at, r, K, r, WK);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  auto* yy = static_cast<__nv_bfloat16*>(y);
  if (big) {  // r = 8
#define LORA_BIG(TW) \
  launch_wgmma_typed<3, 192, TW, 1>(mx, mw, ma, bb, sbj, sbn, yy, M, N, K, scale, s)
    return (int)(trans_w ? LORA_BIG(1) : LORA_BIG(0));
#undef LORA_BIG
  }
  return (int)(trans_w ? launch_wgmma_rank<1>(r, mx, mw, ma, bb, sbj, sbn, yy, M, N, K, scale, s)
                       : launch_wgmma_rank<0>(r, mx, mw, ma, bb, sbj, sbn, yy, M, N, K, scale, s));
}

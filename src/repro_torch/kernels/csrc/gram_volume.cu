// Batched masked Gram log-volume and its gradient for Hopper, sm_90a.
//
// Replaces the TPU kernel `gram_log_volume` / `_gram_kernel` in
// src/repro/kernels/gram_volume.py (pallas_call at line 56), held to the
// formula of src/repro/core/gram.py:log_volume (the model path):
//   v^_i = v_i * rsqrt(|v_i|^2 + 1e-12)            (k <= 8 rows of width d)
//   G~   = where(m_i & m_j, v^_i . v^_j, delta_ij) + eps * I
//   y    = sum_i log L_ii,  L = cholesky(G~)       (= 1/2 logdet G~)
// Everything after the raw dot products D_ij = v_i . v_j is k x k work.
// The TPU kernel is forward only; the backward here is written by hand:
//   dy/dG~ = 1/2 G~^-1,  dg = pair (.) (1/2 G~^-1 * gbar),
//   dv^_i  = 2 sum_j dg_ij v^_j,
//   dv_i   = r_i dv^_i - r_i^3 (v_i . dv^_i) v_i,  r_i = rsqrt(|v_i|^2 + 1e-12),
// which folds into dv_i = sum_j C_ij v_j with a k x k matrix C computed from
// the raw dot products alone.
//
// What bounds it on the H100: bytes, and below them the launch.  A sample
// reads k*d values and does k(k+1)/2 dot products of length d (10 at k = 4,
// 36 at k = 8) plus O(k^3) scalar work: far below the ~300 flops a byte the
// card needs to be compute-bound, and too few and too thin for the tensor
// cores.  At the round's shape (80 samples, k = 4, d = 1280, bf16) the
// whole input is 800 KB, a quarter of a microsecond at 3.35 TB/s, under
// what one launch costs; so the design keeps every SM busy for that short
// time and hides the launch.
//
// Design.  The forward runs a sample on a thread-block cluster of S blocks
// (S in {1, 2, 4, 8}, from shapes alone: gram_volume.py's
// gram_log_volume_splits), a grid of S * B blocks along x (b = block / S),
// so that any batch the host can index launches.  Rank r takes a
// contiguous share of d; its 128 threads stride over that share with
// 16-byte loads (8 bf16 or 4 f32 of each of the k rows; single elements
// where d is no multiple of 8 (4) or a row is not 16-byte aligned), two
// column steps in flight per thread, and sum the k(k+1)/2 raw dot products
// in registers.  Shuffles and shared memory reduce them once per block;
// each rank stores its partial into its slot in rank 0's shared memory
// (distributed shared memory), and after one cluster.sync() rank 0 sums
// the S slots in rank order, writes the raw dots (B, k, k) f32 and runs the
// unrolled Cholesky on one thread for y (B,) f32.  No atomics, no scratch:
// the result does not change from run to run.
// The backward reads the saved dots, not the rows: each block of an S * B
// grid builds C from its sample's dots, mask, eps and dL/dy (one warp, into
// shared memory, while the block's first loads are in flight), then
// streams dv = C v over its share of d with 16-byte loads and stores: one
// read of vs and one write of dvs in all.
// Both launches allow programmatic dependent launch (cudaLaunchKernelEx,
// programmatic stream serialization): a launch may start during the
// previous kernel's tail, and griddepcontrol.wait holds every read and
// write until that kernel has finished.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int BNT = 128;  // threads per block
constexpr int BNW = BNT / 32;
constexpr int MAX_SPLITS = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes as floats (4 f32 or 8 bf16; the low half of a word is the
// earlier bf16), and back (bf16 rounded to nearest, as from_f)
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pair(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16;
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

// The masked, shifted Gram of the normalized rows, and its Cholesky factor.
// Returns sum_i log L_ii.  Each diagonal comes from one rsqrt, inv[i] =
// 1 / L_ii, and the column divides are multiplies by it, which shortens the
// dependent chain.
template <int KK>
__device__ __forceinline__ float gram_cholesky(const float (&D)[KK][KK], const bool (&m)[KK],
                                               float eps, float (&rr)[KK], float (&L)[KK][KK],
                                               float (&inv)[KK]) {
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
        const float c = fmaxf(s, 1e-20f);
        inv[i] = rsqrtf(c);
        L[i][i] = c * inv[i];
        logdet += logf(L[i][i]);
      } else {
        L[i][j] = s * inv[j];
      }
    }
#pragma unroll
    for (int j = i + 1; j < KK; ++j) L[i][j] = 0.f;
  }
  return logdet;
}

// The backward's k x k matrix C (dL/dv_i = sum_j C_ij v_j) from the raw
// dots D, the mask, eps and gy = dL/dy.
template <int KK>
__device__ __forceinline__ void grad_matrix(const float (&D)[KK][KK], const bool (&m)[KK],
                                            float eps, float gy, float (&C)[KK][KK]) {
  float rr[KK], L[KK][KK], invd[KK];
  gram_cholesky<KK>(D, m, eps, rr, L, invd);

  // Li = L^-1 (lower), then G~^-1 = Li^T Li
  float Li[KK][KK];
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    const float inv = invd[i];
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
  const float half_g = 0.5f * gy;
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
#pragma unroll
  for (int i = 0; i < KK; ++i) {
    float vdot = 0.f;  // (v_i . dv^_i) / 2
#pragma unroll
    for (int j = 0; j < KK; ++j) vdot += dg[i][j] * rr[j] * D[i][j];
    const float beta = 2.f * rr[i] * rr[i] * rr[i] * vdot;
#pragma unroll
    for (int j = 0; j < KK; ++j) C[i][j] = 2.f * rr[i] * rr[j] * dg[i][j] - (i == j ? beta : 0.f);
  }
}

// ---------------------------------------------------------------------------
// a sample per cluster of S blocks (forward), per S blocks (backward)

// W values of a row at column step c: one 16-byte vector (VEC) or one
// element, loaded raw (so that the loads of two steps can be in flight in
// few registers) and unpacked where they are used
template <typename T, bool VEC> struct Step {
  static constexpr int W = VEC ? Vec<T>::N : 1;
  using Raw = std::conditional_t<VEC, uint4, T>;
  __device__ static Raw load(const T* __restrict__ row, int c) {
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const uint4*>(row) + c);
    } else {
      return row[c];
    }
  }
  __device__ static void unpack(const Raw& raw, float* f) {
    if constexpr (VEC) {
      Vec<T>::unpack(raw, f);
    } else {
      f[0] = to_f(raw);
    }
  }
  __device__ static void store(T* __restrict__ row, int c, const float* f) {
    if constexpr (VEC) {
      reinterpret_cast<uint4*>(row)[c] = Vec<T>::pack(f);
    } else {
      row[c] = from_f<T>(f[0]);
    }
  }
};

// the k rows' raw values at column step c, where c < c1
template <typename T, bool VEC, int KK>
__device__ __forceinline__ void load_rows(const T* __restrict__ v, int d, int c, int c1,
                                          typename Step<T, VEC>::Raw (&raw)[KK]) {
  if (c < c1) {
#pragma unroll
    for (int i = 0; i < KK; ++i) raw[i] = Step<T, VEC>::load(v + (size_t)i * d, c);
  }
}

// index of the pair (i, j), j <= i, among the k(k+1)/2 dot products
__host__ __device__ constexpr int pair_index(int i, int j) { return i * (i + 1) / 2 + j; }

// rank r's share [c0, c1) of the n column steps (contiguous, in rank order)
__device__ __forceinline__ void share(int n, int rank, int S, int& c0, int& c1) {
  c0 = (int)((long long)n * rank / S);
  c1 = (int)((long long)n * (rank + 1) / S);
}

template <typename T, int KK, bool VEC>
__global__ void __launch_bounds__(BNT)
gram_kernel(const T* __restrict__ vs, const uint8_t* __restrict__ mask, float* __restrict__ out,
            float* __restrict__ dots, int d, float eps) {
  constexpr int P = KK * (KK + 1) / 2;
  using St = Step<T, VEC>;
  constexpr int W = St::W;
  __shared__ float red[BNW][P];          // the warps' partials
  __shared__ float slot[MAX_SPLITS][P];  // rank 0: each rank's partial
  __shared__ float tot[P];               // rank 0: the sums

  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  // first phase of the cluster barrier: a rank stores into rank 0's shared
  // memory only once every block of the cluster has started
  if (S > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* v = vs + (size_t)b * KK * d;
  int c0, c1;
  share(d / W, rank, S, c0, c1);
  // the mask goes out with the rows: rank 0's thread 0 needs it last
  bool m[KK];
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < KK; ++i) m[i] = mask[(size_t)b * KK + i] != 0;
  }

  // two column steps in flight: step c's sums run while step c + BNT loads
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.f;
  typename St::Raw cur[KK], nxt[KK];
  int c = c0 + tid;
  load_rows<T, VEC, KK>(v, d, c, c1, cur);
  load_rows<T, VEC, KK>(v, d, c + BNT, c1, nxt);
  for (; c < c1; c += BNT) {
    float x[KK][W];
#pragma unroll
    for (int i = 0; i < KK; ++i) {
      St::unpack(cur[i], x[i]);
      cur[i] = nxt[i];
    }
    load_rows<T, VEC, KK>(v, d, c + 2 * BNT, c1, nxt);
#pragma unroll
    for (int i = 0; i < KK; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[pair_index(i, j)] = fmaf(x[i][e], x[j][e], acc[pair_index(i, j)]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) red[warp][p] = acc[p];
  }
  __syncthreads();

  // the block's partial (the warps' in order) into its slot in rank 0
  float* to = (S > 1 ? cluster.map_shared_rank(&slot[0][0], 0) : &slot[0][0]) + rank * P;
  if (S > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < P) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < BNW; ++w) s += red[w][tid];
    to[tid] = s;
  }
  if (S > 1) {
    cluster.sync();  // every rank's partial has landed in rank 0's slots
  } else {
    __syncthreads();
  }

  if (rank == 0) {
    if (tid < P) {
      float s = 0.f;
      for (int r = 0; r < S; ++r) s += slot[r][tid];
      tot[tid] = s;
    }
    __syncthreads();
    float* db = dots + (size_t)b * KK * KK;
    for (int t = tid; t < KK * KK; t += BNT) {
      const int i = t / KK, j = t % KK;
      db[t] = tot[i >= j ? pair_index(i, j) : pair_index(j, i)];
    }
    if (tid == 0) {
      float D[KK][KK];
#pragma unroll
      for (int i = 0; i < KK; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) D[i][j] = D[j][i] = tot[pair_index(i, j)];
      float rr[KK], L[KK][KK], inv[KK];
      out[b] = gram_cholesky<KK>(D, m, eps, rr, L, inv);
    }
  }
}

template <typename T, int KK, bool VEC>
__global__ void __launch_bounds__(BNT)
gram_bwd_kernel(const T* __restrict__ vs, const uint8_t* __restrict__ mask,
                const float* __restrict__ dots, const float* __restrict__ gout,
                T* __restrict__ dvs, int d, int S, float eps) {
  using St = Step<T, VEC>;
  constexpr int W = St::W;
  __shared__ float Cs[KK][KK];

  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x / S;
  const int tid = threadIdx.x;
  const T* v = vs + (size_t)b * KK * d;
  T* dv = dvs + (size_t)b * KK * d;
  int c0, c1;
  share(d / W, blockIdx.x % S, S, c0, c1);

  // the first two steps' rows go out before the k x k work; then two
  // steps stay in flight: step c's products run while c + BNT loads
  typename St::Raw cur[KK], nxt[KK];
  int c = c0 + tid;
  load_rows<T, VEC, KK>(v, d, c, c1, cur);
  load_rows<T, VEC, KK>(v, d, c + BNT, c1, nxt);
  if (tid < 32) {
    float D[KK][KK], C[KK][KK];
    bool m[KK];
    const float* db = dots + (size_t)b * KK * KK;
#pragma unroll
    for (int i = 0; i < KK; ++i) {
      m[i] = mask[(size_t)b * KK + i] != 0;
#pragma unroll
      for (int j = 0; j < KK; ++j) D[i][j] = db[i * KK + j];
    }
    grad_matrix<KK>(D, m, eps, gout[b], C);
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < KK; ++i)
#pragma unroll
        for (int j = 0; j < KK; ++j) Cs[i][j] = C[i][j];
    }
  }
  __syncthreads();

  for (; c < c1; c += BNT) {
    float x[KK][W];
#pragma unroll
    for (int j = 0; j < KK; ++j) {
      St::unpack(cur[j], x[j]);
      cur[j] = nxt[j];
    }
    load_rows<T, VEC, KK>(v, d, c + 2 * BNT, c1, nxt);
#pragma unroll
    for (int i = 0; i < KK; ++i) {
      float o[W];
#pragma unroll
      for (int e = 0; e < W; ++e) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < KK; ++j) a = fmaf(Cs[i][j], x[j][e], a);
        o[e] = a;
      }
      St::store(dv + (size_t)i * d, c, o);
    }
  }
}

__global__ void empty_kernel(int) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// A launch of `grid` blocks along x that allows programmatic dependent
// launch, as clusters of `cluster` blocks when cluster > 0.  Returns the
// launch's error.
template <typename... KArgs, typename... Args>
cudaError_t launch_pdl(void (*kernel)(KArgs...), int grid, int threads, int cluster,
                       cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[n].val.programmaticStreamSerializationAllowed = 1;
  ++n;
  if (cluster > 0) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int KK>
cudaError_t launch_fwd(const void* vs, const uint8_t* mask, float* out, float* dots, int B, int d,
                       int splits, float eps, cudaStream_t st) {
  const T* v = static_cast<const T*>(vs);
  const int grid = splits * B;
  if (d % Vec<T>::N == 0 && aligned16(vs))
    return launch_pdl(gram_kernel<T, KK, true>, grid, BNT, splits, st, v, mask, out, dots, d, eps);
  return launch_pdl(gram_kernel<T, KK, false>, grid, BNT, splits, st, v, mask, out, dots, d, eps);
}

template <typename T, int KK>
cudaError_t launch_bwd(const void* vs, const uint8_t* mask, const float* dots, const float* gout,
                       void* dvs, int B, int d, int splits, float eps, cudaStream_t st) {
  const T* v = static_cast<const T*>(vs);
  T* dv = static_cast<T*>(dvs);
  const int grid = splits * B;
  if (d % Vec<T>::N == 0 && aligned16(vs) && aligned16(dvs))
    return launch_pdl(gram_bwd_kernel<T, KK, true>, grid, BNT, 0, st, v, mask, dots, gout,
                      dv, d, splits, eps);
  return launch_pdl(gram_bwd_kernel<T, KK, false>, grid, BNT, 0, st, v, mask, dots, gout, dv,
                    d, splits, eps);
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
cudaError_t fwd_t(int k, const void* vs, const uint8_t* mask, float* out, float* dots, int B,
                  int d, int splits, float eps, cudaStream_t st) {
#define CALL(K) launch_fwd<T, K>(vs, mask, out, dots, B, d, splits, eps, st)
  GRAM_SWITCH_K(k, CALL)
#undef CALL
}

template <typename T>
cudaError_t bwd_t(int k, const void* vs, const uint8_t* mask, const float* dots, const float* gout,
                  void* dvs, int B, int d, int splits, float eps, cudaStream_t st) {
#define CALL(K) launch_bwd<T, K>(vs, mask, dots, gout, dvs, B, d, splits, eps, st)
  GRAM_SWITCH_K(k, CALL)
#undef CALL
}

// splits (the cluster size) is 1, 2, 4 or 8, and the S * B blocks fit a
// grid's x (2^31 - 1)
bool shape_ok(int B, int d, int s) {
  return (s == 1 || s == 2 || s == 4 || s == 8) && d >= 0 && B <= 0x7fffffff / s;
}

}  // namespace

// Forward.  vs (B, k, d) f32 or bf16, mask (B, k) bool (one byte each),
// out (B,) f32, dots (B, k, k) f32 (the raw dot products v_i . v_j);
// contiguous; 1 <= k <= 8; splits blocks (1, 2, 4 or 8) a sample, as one
// cluster.  Returns the cudaError_t of the launch.
extern "C" int gram_log_volume_launch(const void* vs, const void* mask, void* out, void* dots,
                                      int B, int k, int d, int splits, float eps, int is_bf16,
                                      void* stream) {
  if (B == 0) return 0;
  if (!shape_ok(B, d, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  float* o = static_cast<float*>(out);
  float* dt = static_cast<float*>(dots);
  return (int)(is_bf16 ? fwd_t<__nv_bfloat16>(k, vs, m, o, dt, B, d, splits, eps, st)
                       : fwd_t<float>(k, vs, m, o, dt, B, d, splits, eps, st));
}

// Backward from the forward's dots (B, k, k) f32: gout (B,) f32 is dL/dy;
// dvs (B, k, d) in vs's dtype receives dL/dvs.  splits blocks (1, 2, 4 or
// 8) share each sample's d.
extern "C" int gram_log_volume_bwd_launch(const void* vs, const void* mask, const void* dots,
                                          const void* gout, void* dvs, int B, int k, int d,
                                          int splits, float eps, int is_bf16, void* stream) {
  if (B == 0) return 0;
  if (!shape_ok(B, d, splits)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* dt = static_cast<const float*>(dots);
  const float* g = static_cast<const float*>(gout);
  return (int)(is_bf16 ? bwd_t<__nv_bfloat16>(k, vs, m, dt, g, dvs, B, d, splits, eps, st)
                       : bwd_t<float>(k, vs, m, dt, g, dvs, B, d, splits, eps, st));
}

// An empty kernel launched as the kernels launch (`blocks` blocks of
// `threads` along x, clusters of `cluster` when cluster > 0, programmatic
// dependent launch): the launch's own cost.
extern "C" int gram_log_volume_empty_launch(int blocks, int threads, int cluster, void* stream) {
  return (int)launch_pdl(empty_kernel, blocks, threads, cluster,
                         static_cast<cudaStream_t>(stream), 0);
}

extern "C" const char* gram_log_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

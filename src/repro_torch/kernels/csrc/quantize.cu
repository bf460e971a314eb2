// Per-row symmetric abs-max quantization and its inverse (the int8/int4 wire
// codec's tiles) for Hopper, sm_90a.
//
// Replaces the TPU kernels `quantize_rows` / `_quant_kernel` (pallas_call at
// src/repro/kernels/quantize.py:49) and `dequantize_rows` / `_dequant_kernel`
// (pallas_call at line 71).
//
// What bounds them on the H100: bytes, and at the wire's sizes the launch.
// Quantize reads each value once (f32 or bf16) and writes one int8 code and
// one f32 scale per row; dequantize reads the codes and scales and writes
// f32.  Both do a few operations per byte, far below the card's ~300
// operations per byte of device memory, and neither has a product for the
// tensor cores to take.  An uplink leaf (8,640 rows of 128 f32) is 4.4 MB
// in and 1.1 MB out, 1.7 us at 3.35 TB/s.
//
// Quantize is a grid-stride loop over rows on at most one wave of resident
// blocks: WAVE_WARPS warps each, launch-bounded to WAVE_BLOCKS blocks an SM
// (the SM's 64 warps, so at most 32 registers a thread); the wrapper sizes
// the grid from that constant (quantize.py:quantize_rows_grid): one row
// per warp where the rows fit one wave, else two.  Where a row is a whole
// number of 16-byte vectors and at most 32 of them (the wire's tile of 128
// f32 is 32), a warp takes its RPW rows of a step (rows w and w + n of the
// grid's n warps, so that every SM gets an even share) with their 16-byte
// loads issued at once, keeps them in registers through the abs-max
// reduction (the rows' shuffles interleaved), and codes them from those
// registers.  Longer rows, and rows that are no whole number of vectors or
// not 16-byte aligned, go one row per warp through quantize_row, which
// reads the row twice (the second time from L1); there lanes stride over
// single elements where the row is no whole number of vectors or a pointer
// is not 16-byte aligned.  The TPU kernel asserts R % 128 == 0 and its
// wrapper pads rows; here every row is independent and nothing is padded.
// The launch allows programmatic dependent launch (cudaLaunchKernelEx,
// programmatic stream serialization): it may start during the previous
// kernel's tail, and griddepcontrol.wait holds every read and write until
// that kernel has finished.
//
// The arithmetic is the reference's, bit for bit
// (src/repro/kernels/ref.py:quantize_ref): scale = absmax * f32(1/qmax)
// (one multiply, never a divide), code = clamp(rint(x / safe), +-qmax) with
// safe = scale > 0 ? scale : 1, the division IEEE round-to-nearest
// (__fdiv_rn) and rint rounding half to even.  An all-zero row gets scale 0
// and codes 0.  Do not build with --use_fast_math.
//
// Dequantize is code * scale in f32, one multiply per element, one warp
// per row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;                       // dequantize: rows a block
constexpr int NT = 32 * WARPS;
constexpr int WAVE_WARPS = 8;                  // quantize: warps a block
constexpr int WAVE_NT = 32 * WAVE_WARPS;
constexpr int WAVE_BLOCKS = 64 / WAVE_WARPS;   // blocks an SM holds: its 64 warps
constexpr int WAVE_ROWS = 2;                   // rows a warp holds at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of input as floats: 4 f32 or 8 bf16
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the low half is the earlier element
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ int8_t code(float x, float safe, float qmax) {
  return (int8_t)fminf(fmaxf(rintf(__fdiv_rn(x, safe)), -qmax), qmax);
}

// four codes as one little-endian word (the first code in the low byte)
__device__ __forceinline__ uint32_t pack4(const float* f, float safe, float qmax) {
  return (uint32_t)(uint8_t)code(f[0], safe, qmax) |
         (uint32_t)(uint8_t)code(f[1], safe, qmax) << 8 |
         (uint32_t)(uint8_t)code(f[2], safe, qmax) << 16 |
         (uint32_t)(uint8_t)code(f[3], safe, qmax) << 24;
}

// the codes of one 16-byte vector of input, stored as one word (f32) or two
template <typename T>
__device__ __forceinline__ void store_codes(int8_t* qr, int i, const float* f, float safe,
                                            float qmax) {
  if constexpr (Vec<T>::N == 4) {
    reinterpret_cast<uint32_t*>(qr)[i] = pack4(f, safe, qmax);
  } else {
    reinterpret_cast<uint2*>(qr)[i] = make_uint2(pack4(f, safe, qmax), pack4(f + 4, safe, qmax));
  }
}

// One row by one warp: the abs-max by shuffles, then the codes (the row
// read twice; vectors where VEC, single elements otherwise).
template <typename T, bool VEC>
__device__ __forceinline__ void quantize_row(const T* __restrict__ xr, int8_t* __restrict__ qr,
                                             float* __restrict__ scale, int L, float qmax,
                                             float inv_qmax, int lane) {
  constexpr int N = Vec<T>::N;
  const int nv = L / N;
  float amax = 0.f;
  if constexpr (VEC) {
    for (int i = lane; i < nv; i += 32) {
      float f[N];
      Vec<T>::unpack(reinterpret_cast<const uint4*>(xr)[i], f);
#pragma unroll
      for (int e = 0; e < N; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  } else {
    for (int i = lane; i < L; i += 32) amax = fmaxf(amax, fabsf(to_f(xr[i])));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = amax * inv_qmax;
  const float safe = s > 0.f ? s : 1.f;
  if (lane == 0) *scale = s;

  if constexpr (VEC) {
    for (int i = lane; i < nv; i += 32) {
      float f[N];
      Vec<T>::unpack(reinterpret_cast<const uint4*>(xr)[i], f);
      store_codes<T>(qr, i, f, safe, qmax);
    }
  } else {
    for (int i = lane; i < L; i += 32) qr[i] = code(to_f(xr[i]), safe, qmax);
  }
}

// Quantize.  VEC_ROWS: a warp holds RPW rows of at most 32 16-byte
// vectors in registers per step (one vector a lane), rows w, w + n, ...,
// w + (RPW - 1) n of the grid's n warps, so that every warp of the grid
// has work; else one row per warp per step through quantize_row (VEC: as
// vectors).
template <typename T, int RPW, bool VEC_ROWS, bool VEC>
__global__ void __launch_bounds__(WAVE_NT, WAVE_BLOCKS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     int R, int L, float qmax, float inv_qmax) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * WAVE_WARPS + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * WAVE_WARPS;
  if constexpr (!VEC_ROWS) {
    for (long long row = warp; row < R; row += n_warps)
      quantize_row<T, VEC>(x + row * L, q + row * L, scale + row, L, qmax, inv_qmax, lane);
  } else {
    constexpr int N = Vec<T>::N;
    const bool mine = lane < L / N;  // this lane's vector lies in the row
    for (long long r0 = warp; r0 < R; r0 += n_warps * RPW) {
      uint4 raw[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const long long row = r0 + r * n_warps;
        raw[r] = (row < R && mine) ? __ldg(reinterpret_cast<const uint4*>(x + row * L) + lane)
                                   : make_uint4(0u, 0u, 0u, 0u);
      }
      float amax[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float f[N];
        Vec<T>::unpack(raw[r], f);
        amax[r] = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) amax[r] = fmaxf(amax[r], fabsf(f[e]));
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], o));
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const long long row = r0 + r * n_warps;
        if (row >= R) break;  // the whole warp together
        const float s = amax[r] * inv_qmax;
        const float safe = s > 0.f ? s : 1.f;
        if (lane == 0) scale[row] = s;
        if (mine) {
          float f[N];
          Vec<T>::unpack(raw[r], f);
          store_codes<T>(q + row * L, lane, f, safe, qmax);
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
dequantize_rows_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       float* __restrict__ out, int R, int L) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const int8_t* qr = q + row * L;
  float* orow = out + row * L;
  const float s = scale[row];
  if constexpr (VEC) {
    for (int i = lane; i < L / 4; i += 32) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(qr)[i];
      float4 o;
      o.x = (float)(int8_t)(uint8_t)w * s;
      o.y = (float)(int8_t)(uint8_t)(w >> 8) * s;
      o.z = (float)(int8_t)(uint8_t)(w >> 16) * s;
      o.w = (float)(int8_t)(uint8_t)(w >> 24) * s;
      reinterpret_cast<float4*>(orow)[i] = o;
    }
  } else {
    for (int i = lane; i < L; i += 32) orow[i] = (float)qr[i] * s;
  }
}

__global__ void empty_kernel(int) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// f32(1/qmax): the double quotient rounded once, as numpy's float32(1.0 / qmax)
float inverse(int qmax) { return (float)(1.0 / (double)qmax); }

template <typename T>
bool takes_vectors(const void* x, const void* q, int L) {
  constexpr int N = Vec<T>::N;
  return L % N == 0 && aligned(x, 16) && aligned(q, N);
}

// the instance for rows held in registers (a whole number of 16-byte
// vectors, at most one a lane; RPW of them) or not (and then, as vectors or
// not); nullptr for a pair it has no instance of
template <typename T>
auto quant_kernel(int L, bool vec, int rpw) {
  decltype(&quantize_rows_kernel<T, 1, true, true>) k = nullptr;
  const bool in_registers = vec && L / Vec<T>::N <= 32;
  if (in_registers && rpw == 1) k = quantize_rows_kernel<T, 1, true, true>;
  if (in_registers && rpw == WAVE_ROWS) k = quantize_rows_kernel<T, WAVE_ROWS, true, true>;
  if (!in_registers && rpw == 1)
    k = vec ? quantize_rows_kernel<T, 1, false, true>
            : quantize_rows_kernel<T, 1, false, false>;
  return k;
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* scale, int R, int L, int qmax, int grid,
                         int rows_per_warp, cudaStream_t stream) {
  const auto kernel = quant_kernel<T>(L, takes_vectors<T>(x, q, L), rows_per_warp);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WAVE_NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<int8_t*>(q),
                         static_cast<float*>(scale), R, L, (float)qmax, inverse(qmax));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x (R, L) f32 or bf16, q (R, L) int8, scale (R,) f32; contiguous.  qmax
// in [1, 127].  `grid` blocks of WAVE_NT threads (>= 1; any grid is
// correct, one wave of resident blocks is what it is sized for), each warp
// holding `rows_per_warp` rows at a step: 1, or 2 where a row is at most 32
// 16-byte vectors read as vectors (else cudaErrorInvalidValue).  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int quantize_rows_launch(const void* x, void* q, void* scale, int R, int L, int qmax,
                                    int is_bf16, int grid, int rows_per_warp, void* stream) {
  if (R == 0) return 0;
  if (qmax < 1 || qmax > 127 || L < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_quant<__nv_bfloat16>(x, q, scale, R, L, qmax, grid,
                                                     rows_per_warp, s)
                       : launch_quant<float>(x, q, scale, R, L, qmax, grid, rows_per_warp, s));
}

// q (R, L) int8, scale (R,) f32, out (R, L) f32; contiguous.
extern "C" int dequantize_rows_launch(const void* q, const void* scale, void* out, int R, int L,
                                      void* stream) {
  if (R == 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + WARPS - 1) / WARPS);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* st = static_cast<const float*>(scale);
  float* ot = static_cast<float*>(out);
  if (L % 4 == 0 && aligned(q, 4) && aligned(out, 16)) {
    dequantize_rows_kernel<true><<<grid, NT, 0, s>>>(qt, st, ot, R, L);
  } else {
    dequantize_rows_kernel<false><<<grid, NT, 0, s>>>(qt, st, ot, R, L);
  }
  return (int)cudaGetLastError();
}

// An empty kernel launched as quantize launches (`blocks` of `threads`,
// programmatic dependent launch): the launch's own cost.
extern "C" int quantize_empty_launch(int blocks, int threads, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel, 0);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

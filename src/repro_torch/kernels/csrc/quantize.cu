// Per-row symmetric abs-max quantization and its inverse (the int8/int4 wire
// codec's tiles) for Hopper, sm_90a.
//
// Replaces the TPU kernels `quantize_rows` / `_quant_kernel` (pallas_call at
// src/repro/kernels/quantize.py:49) and `dequantize_rows` / `_dequant_kernel`
// (pallas_call at line 71).
//
// What bounds them on the H100: bytes.  Quantize reads each value once (f32
// or bf16) and writes one int8 code and one f32 scale per row; dequantize
// reads the codes and scales and writes f32.  Both do a few operations per
// byte, far below the card's ~300 operations per byte of device memory.
//
// Design:
//   * one warp per row, 8 rows per block of 256 threads; a row is a wire
//     tile (128 wide on the main path), so a warp reads it with one 16-byte
//     load per lane (4 f32 or 8 bf16), reduces the abs-max with shuffles,
//     and stores 4 (or 8) codes per lane as one 32-bit (or 64-bit) word.
//     The second pass over the row re-reads it from L1.
//   * rows of any length: where the length is no multiple of the vector or
//     a pointer is not 16-byte aligned, lanes stride over single elements.
//     The TPU kernel asserts R % 128 == 0 and its wrapper pads rows; here
//     every row is independent and nothing is padded.
//   * the arithmetic is the reference's, bit for bit
//     (src/repro/kernels/ref.py:quantize_ref): scale = absmax * f32(1/qmax)
//     (one multiply, never a divide), code = clamp(rint(x / safe), +-qmax)
//     with safe = scale > 0 ? scale : 1, the division IEEE round-to-nearest
//     (__fdiv_rn) and rint rounding half to even.  An all-zero row gets
//     scale 0 and codes 0.  Do not build with --use_fast_math.
//   * dequantize is code * scale in f32, one multiply per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int R, int L, float qmax, float inv_qmax) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp leaves together
  const T* xr = x + row * L;
  int8_t* qr = q + row * L;
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
  if (lane == 0) scale[row] = s;

  if constexpr (VEC) {
    for (int i = lane; i < nv; i += 32) {
      float f[N];
      Vec<T>::unpack(reinterpret_cast<const uint4*>(xr)[i], f);
      if constexpr (N == 4) {
        reinterpret_cast<uint32_t*>(qr)[i] = pack4(f, safe, qmax);
      } else {
        reinterpret_cast<uint2*>(qr)[i] = make_uint2(pack4(f, safe, qmax),
                                                     pack4(f + 4, safe, qmax));
      }
    }
  } else {
    for (int i = lane; i < L; i += 32) qr[i] = code(to_f(xr[i]), safe, qmax);
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

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <typename T>
cudaError_t launch_quant(const void* x, void* q, void* scale, int R, int L, int qmax,
                         cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  // f32(1/qmax): the double quotient rounded once, as numpy's float32(1.0 / qmax)
  const float inv = (float)(1.0 / (double)qmax);
  const bool vec = L % N == 0 && aligned(x, 16) && aligned(q, N);
  const dim3 grid((R + WARPS - 1) / WARPS);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scale);
  if (vec) {
    quantize_rows_kernel<T, true><<<grid, NT, 0, stream>>>(xt, qt, st, R, L, (float)qmax, inv);
  } else {
    quantize_rows_kernel<T, false><<<grid, NT, 0, stream>>>(xt, qt, st, R, L, (float)qmax, inv);
  }
  return cudaGetLastError();
}

}  // namespace

// x (R, L) f32 or bf16, q (R, L) int8, scale (R,) f32; contiguous.
// qmax in [1, 127].  Returns the cudaError_t of the launch (0 = launched).
extern "C" int quantize_rows_launch(const void* x, void* q, void* scale, int R, int L, int qmax,
                                    int is_bf16, void* stream) {
  if (R == 0) return 0;
  if (qmax < 1 || qmax > 127 || L < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_quant<__nv_bfloat16>(x, q, scale, R, L, qmax, s)
                       : launch_quant<float>(x, q, scale, R, L, qmax, s));
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

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

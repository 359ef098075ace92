// LayerNorm over the last dim for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel of sdwebui_tpu/ops/pallas_norms.py:27-35
// (`_ln_kernel`, reached through `layer_norm_pallas` :65):
//   mean = sum(x)/C, var = sum(x*x)/C - mean^2   (fp32, one pass, not Welford)
//   out  = (x - mean) * rsqrt(var + eps) * w + b  (fp32, cast once to x's dtype)
// with w = 1 and b = 0 when absent.  The TPU kernel's row blocks padded to
// block_rows have no counterpart: each warp owns one row and masks nothing.
//
// What bounds it on the H100: 8 flops per element over 2 bytes read and 2
// written (bf16), far below the card's ~295 flops/byte balance point, so
// it is bound by device-memory bytes: one read of x, one write of out.
// The design keeps it to that:
//   - one warp per row (C <= a few thousand: the SD/SDXL widths 320-1536
//     and the CLIP widths 768/1280), 8 rows per 256-thread block;
//   - pass 1 reads the row with 16-byte vector loads when the row is
//     aligned (scalar loads otherwise), sums x and x*x in fp32 per lane and
//     combines the lanes with xor shuffles;
//   - pass 2 reads the row again (a few KB, from L1/L2, not device memory),
//     applies the fp32 affine and writes the row once;
//   - rows are addressed through an explicit row stride, so a column slice
//     of a wider tensor needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                      const WT* __restrict__ b, T* __restrict__ out, int64_t rows, int c,
                      int64_t x_stride, int64_t out_stride, float eps, int vec) {
  constexpr int N = 16 / sizeof(T);   // elements per 16-byte access
  const int lane = threadIdx.x % 32;
  const int64_t row = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * x_stride;
  T* orow = out + row * out_stride;

  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    for (int i = lane * N; i < c; i += 32 * N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float v = to_f(in[e]);
        s1 += v;
        s2 += v * v;
      }
    }
  } else {
    for (int i = lane; i < c; i += 32) {
      const float v = to_f(xr[i]);
      s1 += v;
      s2 += v * v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mean = s1 / c;
  const float var = s2 / c - mean * mean;
  const float rstd = rsqrtf(var + eps);

  if (vec) {
    for (int i = lane * N; i < c; i += 32 * N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* in = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float wv = w ? to_f(w[i + e]) : 1.f;
        const float bv = b ? to_f(b[i + e]) : 0.f;
        res[e] = from_f<T>((to_f(in[e]) - mean) * rstd * wv + bv);
      }
      *reinterpret_cast<uint4*>(orow + i) = packed;
    }
  } else {
    for (int i = lane; i < c; i += 32) {
      const float wv = w ? to_f(w[i]) : 1.f;
      const float bv = b ? to_f(b[i]) : 0.f;
      orow[i] = from_f<T>((to_f(xr[i]) - mean) * rstd * wv + bv);
    }
  }
}

template <typename T, typename WT>
int launch(const void* x, const void* w, const void* b, void* out, int64_t rows, int c,
           int64_t x_stride, int64_t out_stride, float eps, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);   // elements per 16-byte access
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && c % N == 0 &&
                   x_stride % N == 0 && out_stride % N == 0;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return int(cudaErrorInvalidValue);
  layer_norm_kernel<T, WT><<<unsigned(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w), static_cast<const WT*>(b),
      static_cast<T*>(out), rows, c, x_stride, out_stride, eps, vec ? 1 : 0);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  dtype / w_dtype: 0 = bf16,
// 1 = f32 (w_dtype is the type of weight and bias, either may be null).
// Strides are in elements; each row is contiguous.
int sdtpu_layer_norm(const void* x, const void* w, const void* b, void* out, int dtype,
                     int w_dtype, int64_t rows, int c, int64_t x_stride, int64_t out_stride,
                     float eps, void* stream) {
  if (rows <= 0 || c <= 0 || (dtype != 0 && dtype != 1) || (w_dtype != 0 && w_dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return w_dtype == 0
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, rows, c, x_stride,
                                                      out_stride, eps, s)
               : launch<__nv_bfloat16, float>(x, w, b, out, rows, c, x_stride, out_stride,
                                              eps, s);
  }
  return w_dtype == 0 ? launch<float, __nv_bfloat16>(x, w, b, out, rows, c, x_stride,
                                                     out_stride, eps, s)
                      : launch<float, float>(x, w, b, out, rows, c, x_stride, out_stride,
                                             eps, s);
}

}  // extern "C"

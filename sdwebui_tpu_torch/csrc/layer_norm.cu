// LayerNorm over the last dim for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel of sdwebui_tpu/ops/pallas_norms.py:27-35
// (`_ln_kernel`, reached through `layer_norm_pallas` :65):
//   mean = sum(x)/C, var = sum(x*x)/C - mean^2   (fp32, one pass, not Welford)
//   out  = (x - mean) * rstd(var + eps) * w + b  (fp32, cast once to x's dtype)
// with w = 1 and b = 0 when absent.  The TPU kernel's row blocks padded to
// block_rows have no counterpart: rows past the end are masked.
//
// What bounds it on the H100: 8 flops per element over 2 bytes read and 2
// written (bf16), far below the card's ~295 flops/byte balance point, so
// it is bound by device-memory bytes: one read of x, one write of out.
// Two kernels, picked by the wrapper (ops/layer_norm.ln_plan):
//   - `layer_norm_reg_kernel` (every path width: C <= 2048, rows and bases
//     16-byte aligned): a row belongs to a sub-warp of LANES = 8, 16 or 32
//     lanes, each holding CHUNKS <= 8 16-byte chunks (bf16 C = 320: 8 x 5,
//     640: 16 x 5, 768: 16 x 6, 1280: 32 x 5, 1536: 32 x 6; f32 rows past
//     1024 take 10, 12 or 16 chunks: 64 values a lane, as bf16's 8),
//     so a warp holds 4, 2 or 1 rows and every lane issues all its loads
//     (unrolled, compile-time count) before the first add.  The sums combine
//     by shuffles inside the sub-warp, and the row is normalised from the
//     registers: x is read once and out written once.  w and b are loaded
//     once per lane as 16-byte vectors and kept in fp32 registers while the
//     block walks its rows in a grid-stride loop, the grid sized to the card.
//   - `layer_norm_kernel` (other widths: C > 2048, or rows or bases not
//     16-byte aligned): one warp per row, 8 rows per 256-thread block; pass
//     1 sums the row (16-byte loads where aligned, scalar otherwise), pass 2
//     reads it again (from L1/L2) and writes it.
// Rows are addressed through an explicit row stride, so a column slice of a
// wider tensor needs no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "host.cuh"

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

// the E values of a weight or bias vector under one chunk of x, as fp32
// (one or two 16-byte loads; `fill` where the vector is absent)
template <typename WT, int E>
__device__ __forceinline__ void load_param(const WT* p, int col, float fill, float (&out)[E]) {
  if (p == nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = fill;
    return;
  }
  if constexpr (E * sizeof(WT) < 16) {   // 4 bf16 weights of 4 f32 values: one 8-byte load
    const uint2 raw = *reinterpret_cast<const uint2*>(p + col);
    const WT* v = reinterpret_cast<const WT*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_f(v[e]);
  } else {
    constexpr int PER = 16 / sizeof(WT);   // values per 16-byte load
#pragma unroll
    for (int k = 0; k < E / PER; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + col + k * PER);
      const WT* v = reinterpret_cast<const WT*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) out[k * PER + e] = to_f(v[e]);
    }
  }
}

template <typename T, typename WT, int LANES, int CHUNKS>
__global__ void __launch_bounds__(kWarps * 32)
    layer_norm_reg_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                          const WT* __restrict__ b, T* __restrict__ out, int64_t rows, int c,
                          int64_t x_stride, int64_t out_stride, float eps) {
  constexpr int E = 16 / sizeof(T);              // elements per 16-byte chunk
  constexpr int ROWS = kWarps * 32 / LANES;      // rows per block and pass
  const int sl = threadIdx.x % LANES;            // lane within the row's sub-warp
  const int slot = threadIdx.x / LANES;          // the block's row slot

  float wf[CHUNKS][E], bf[CHUNKS][E];
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int col = (sl + j * LANES) * E;
    if (col < c) {
      load_param<WT, E>(w, col, 1.f, wf[j]);
      load_param<WT, E>(b, col, 0.f, bf[j]);
    }
  }

  // the loop bound is the block's, so every lane meets every shuffle
  for (int64_t base = int64_t(blockIdx.x) * ROWS; base < rows; base += int64_t(gridDim.x) * ROWS) {
    const int64_t row = base + slot;
    const bool valid = row < rows;
    const T* xr = x + row * x_stride;
    uint4 v[CHUNKS];
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int col = (sl + j * LANES) * E;
      v[j] = valid && col < c ? *reinterpret_cast<const uint4*>(xr + col) : make_uint4(0, 0, 0, 0);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {   // Σx and Σx² of the lane's chunks (zeros past C)
      const T* in = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float f = to_f(in[e]);
        s1 += f;
        s2 += f * f;
      }
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / c;
    const float var = s2 / c - mean * mean;
    const float rstd = rsqrtf(var + eps);
    if (!valid) continue;
    T* orow = out + row * out_stride;
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int col = (sl + j * LANES) * E;
      if (col >= c) continue;
      const T* in = reinterpret_cast<const T*>(&v[j]);
      uint4 packed;
      T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < E; ++e) res[e] = from_f<T>((to_f(in[e]) - mean) * rstd * wf[j][e] + bf[j][e]);
      *reinterpret_cast<uint4*>(orow + col) = packed;
    }
  }
}

template <typename T, typename WT>
int launch_loop(const void* x, const void* w, const void* b, void* out, int64_t rows, int c,
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

template <typename T, typename WT, int LANES, int CHUNKS>
int launch_reg(const void* x, const void* w, const void* b, void* out, int64_t rows, int c,
               int64_t x_stride, int64_t out_stride, float eps, cudaStream_t stream) {
  constexpr int ROWS = kWarps * 32 / LANES;
  auto kernel = layer_norm_reg_kernel<T, WT, LANES, CHUNKS>;
  static const int per_sm = [&] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWarps * 32, 0);
    return n > 0 ? n : 1;
  }();
  const int64_t blocks = std::min<int64_t>((rows + ROWS - 1) / ROWS, int64_t(per_sm) * sm_count());
  kernel<<<unsigned(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w), static_cast<const WT*>(b),
      static_cast<T*>(out), rows, c, x_stride, out_stride, eps);
  return int(cudaGetLastError());
}

template <typename T, typename WT, int LANES>
int launch_lanes(int chunks, const void* x, const void* w, const void* b, void* out,
                 int64_t rows, int c, int64_t x_stride, int64_t out_stride, float eps,
                 cudaStream_t s) {
  switch (chunks) {
    case 1: return launch_reg<T, WT, LANES, 1>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 2: return launch_reg<T, WT, LANES, 2>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 3: return launch_reg<T, WT, LANES, 3>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 4: return launch_reg<T, WT, LANES, 4>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 5: return launch_reg<T, WT, LANES, 5>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 6: return launch_reg<T, WT, LANES, 6>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 7: return launch_reg<T, WT, LANES, 7>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 8: return launch_reg<T, WT, LANES, 8>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    default: break;
  }
  if constexpr (sizeof(T) == 4 && LANES == 32) {   // f32 rows of 1280-2048: 64 values a lane
    switch (chunks) {
      case 10: return launch_reg<T, WT, 32, 10>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
      case 12: return launch_reg<T, WT, 32, 12>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
      case 16: return launch_reg<T, WT, 32, 16>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
      default: break;
    }
  }
  return int(cudaErrorInvalidValue);
}

// lanes = 0: the loop kernel; else the register kernel at (lanes, chunks),
// whose conditions are checked here
template <typename T, typename WT>
int launch(const void* x, const void* w, const void* b, void* out, int64_t rows, int c,
           int64_t x_stride, int64_t out_stride, float eps, int lanes, int chunks,
           cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  if (lanes == 0) return launch_loop<T, WT>(x, w, b, out, rows, c, x_stride, out_stride, eps, s);
  const bool fits = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) % 16 == 0 &&
                    c % N == 0 && x_stride % N == 0 && out_stride % N == 0 &&
                    int64_t(lanes) * chunks * N >= c;
  if (!fits) return int(cudaErrorInvalidValue);
  switch (lanes) {
    case 8: return launch_lanes<T, WT, 8>(chunks, x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 16: return launch_lanes<T, WT, 16>(chunks, x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    case 32: return launch_lanes<T, WT, 32>(chunks, x, w, b, out, rows, c, x_stride, out_stride, eps, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  dtype / w_dtype: 0 = bf16,
// 1 = f32 (w_dtype is the type of weight and bias, either may be null).
// Strides are in elements; each row is contiguous.  lanes / chunks: the
// wrapper's plan (ops/layer_norm.ln_plan); lanes = 0 takes the loop kernel.
int sdtpu_layer_norm(const void* x, const void* w, const void* b, void* out, int dtype,
                     int w_dtype, int64_t rows, int c, int64_t x_stride, int64_t out_stride,
                     float eps, int lanes, int chunks, void* stream) {
  if (rows <= 0 || c <= 0 || (dtype != 0 && dtype != 1) || (w_dtype != 0 && w_dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == 0)
    return w_dtype == 0 ? launch<bf16, bf16>(x, w, b, out, rows, c, x_stride, out_stride, eps,
                                             lanes, chunks, s)
                        : launch<bf16, float>(x, w, b, out, rows, c, x_stride, out_stride, eps,
                                              lanes, chunks, s);
  return w_dtype == 0 ? launch<float, bf16>(x, w, b, out, rows, c, x_stride, out_stride, eps,
                                            lanes, chunks, s)
                      : launch<float, float>(x, w, b, out, rows, c, x_stride, out_stride, eps,
                                             lanes, chunks, s);
}

}  // extern "C"

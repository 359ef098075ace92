// 3x3, stride 1, pad 1 convolution for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel of sdwebui_tpu/ops/conv.py:43-56 (`_kernel`,
// reached through `conv3x3` :75-121): out = sum over the 9 taps (dy, dx) of
// x[.., h+dy-1, w+dx-1, :] @ w[dy, dx] in fp32, + bias, cast once to x's
// dtype.  The TPU version builds overlapping padded row windows outside the
// kernel so that BlockSpec can pipeline them (conv.py:86-94); here each
// block computes its own input addresses and zero-fills the border, so
// nothing is padded or copied in device memory.
//
// Layout: x channels-last (B, H, W, Cin); weight (Cout, 3, 3, Cin), the
// channels-last form of OIHW; out channels-last (B, H, W, Cout).
//
// What bounds it on the H100: 2*B*H*W*9*Cin*Cout flops over ~2 bytes per
// input/weight/output element: at the UNet's shapes (Cin = 320..1280) that
// is hundreds of flops per byte, so it is bound by tensor-core issue.  The
// design is an implicit GEMM (M = output pixels, N = Cout, K = 9 taps x Cin):
//   - bf16: one block of 8 warps per 128-pixel x 128-channel output tile;
//     a loop over the 9 taps and over Cin in 32-wide chunks; the A tile
//     (pixels x channels of one tap, zero outside the image) and the B tile
//     (output channels x channels of one tap) stream into shared memory with
//     cp.async, double-buffered, and leave it through ldmatrix into
//     mma.m16n8k16 (bf16 in, fp32 accumulate).  Rows whose channels are not
//     16-byte aligned take scalar loads instead of cp.async.
//   - f32: the same tiling on the CUDA cores with exact fp32 FMAs (no TF32).
// No wgmma/TMA yet: this first version is right and simple, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

struct Params {
  const void* x;
  const void* w;
  const void* bias;   // may be null
  void* out;
  int batch, h, w_, cin, cout;
  int64_t m;          // output pixels = batch * h * w_
};

// ---------------------------------------------------------------------------
// bf16: mma.sync implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kBM = 128;             // output pixels per block
constexpr int kBN = 128;             // output channels per block
constexpr int kBK = 32;              // input channels per k step
constexpr int kLd = kBK + 8;         // smem row stride: conflict-free ldmatrix
constexpr int kThreads = 256;        // 8 warps: 2 along M (64 rows) x 4 along N (32 cols)

// Fill one stage: A = 128 pixels x 32 channels of tap (dy, dx), B = 128
// output channels x the same 32 channels.  Each thread copies 2 + 2
// 16-byte chunks; out-of-image pixels and channels past Cin read as 0.
template <bool VEC>
__device__ __forceinline__ void load_stage(const Params& p, __nv_bfloat16* as,
                                           __nv_bfloat16* bs, int tap, int c0,
                                           const int (&pb)[2], const int (&ph)[2],
                                           const int (&pw)[2], int n0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + j * kThreads;
    const int r = idx / 4;
    const int col = (idx % 4) * 8;
    const int ch = c0 + col;
    // A: pixel r of this block
    {
      const int hh = ph[j] + dy, ww = pw[j] + dx;
      const bool inside = pb[j] >= 0 && hh >= 0 && hh < p.h && ww >= 0 && ww < p.w_;
      const int64_t pix = (int64_t(pb[j]) * p.h + hh) * p.w_ + ww;
      const __nv_bfloat16* src = x + pix * p.cin + ch;
      __nv_bfloat16* dst = as + r * kLd + col;
      if (VEC) {
        const bool ok = inside && ch < p.cin;
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = inside && ch + e < p.cin ? src[e] : __float2bfloat16(0.f);
      }
    }
    // B: output channel n0 + r
    {
      const int n = n0 + r;
      const __nv_bfloat16* src = w + (int64_t(n) * 9 + tap) * p.cin + ch;
      __nv_bfloat16* dst = bs + r * kLd + col;
      if (VEC) {
        const bool ok = n < p.cout && ch < p.cin;
        cp_async16(dst, ok ? src : w, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = n < p.cout && ch + e < p.cin ? src[e] : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) conv3x3_bf16_kernel(Params p) {
  __shared__ __align__(128) __nv_bfloat16 as[2][kBM * kLd];
  __shared__ __align__(128) __nv_bfloat16 bs[2][kBN * kLd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tq = lane % 4;
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // the two A rows this thread loads: image, row and column of each pixel
  int pb[2], ph[2], pw[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t m = m0 + (threadIdx.x + j * kThreads) / 4;
    if (m < p.m) {
      const int64_t hw = int64_t(p.h) * p.w_;
      pb[j] = int(m / hw);
      const int rem = int(m - int64_t(pb[j]) * hw);
      ph[j] = rem / p.w_;
      pw[j] = rem - ph[j] * p.w_;
    } else {
      pb[j] = -1;
      ph[j] = pw[j] = 0;
    }
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int chunks = (p.cin + kBK - 1) / kBK;
  const int iters = 9 * chunks;
  load_stage<VEC>(p, as[0], bs[0], 0, 0, pb, ph, pw, n0);
  cp_async_commit();
  for (int it = 0; it < iters; ++it) {
    const int s = it & 1;
    if (it + 1 < iters) {
      const int nt = (it + 1) / chunks, nc = ((it + 1) % chunks) * kBK;
      load_stage<VEC>(p, as[s ^ 1], bs[s ^ 1], nt, nc, pb, ph, pw, n0);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldsm_x4(af[mi], as[s] + r * kLd + ks * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int r = wn * 32 + jn * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(bf[jn], bs[s] + r * kLd + ks * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          mma_bf16(acc[mi][2 * jn], af[mi], bf[jn][0], bf[jn][1]);
          mma_bf16(acc[mi][2 * jn + 1], af[mi], bf[jn][2], bf[jn][3]);
        }
    }
    __syncthreads();   // this stage may be refilled
  }

  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const bool pairs = p.cout % 2 == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
    if (col >= p.cout) continue;
    const bool two = col + 1 < p.cout;
    const float b0 = bias ? __bfloat162float(bias[col]) : 0.f;
    const float b1 = bias && two ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t m = m0 + wm * 64 + mi * 16 + g + 8 * i;
        if (m >= p.m) continue;
        __nv_bfloat16* o = out + m * p.cout + col;
        const float v0 = acc[mi][ni][2 * i] + b0, v1 = acc[mi][ni][2 * i + 1] + b1;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (two) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// f32: exact fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------
// 64 pixels x 64 output channels per block, 16 channels per k step; each of
// the 256 threads accumulates a 4 x 4 patch of the output.

constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(256) conv3x3_f32_kernel(Params p) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t m0 = int64_t(blockIdx.x) * kFM;
  const int n0 = blockIdx.y * kFN;
  const int64_t hw = int64_t(p.h) * p.w_;

  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < p.cin; c0 += kFK) {
      __syncthreads();   // the previous step's tiles are no longer read
      for (int idx = threadIdx.x; idx < kFK * kFM; idx += 256) {
        const int r = idx / kFK, k = idx % kFK;   // consecutive threads: consecutive channels
        const int64_t m = m0 + r;
        float v = 0.f;
        if (m < p.m && c0 + k < p.cin) {
          const int b = int(m / hw);
          const int rem = int(m - int64_t(b) * hw);
          const int hh = rem / p.w_ + dy, ww = rem % p.w_ + dx;
          if (hh >= 0 && hh < p.h && ww >= 0 && ww < p.w_)
            v = x[((int64_t(b) * p.h + hh) * p.w_ + ww) * p.cin + c0 + k];
        }
        as[k][r] = v;
        const int n = n0 + r;
        bs[k][r] = n < p.cout && c0 + k < p.cin ? w[(int64_t(n) * 9 + tap) * p.cin + c0 + k]
                                                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  const float* bias = static_cast<const float*>(p.bias);
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < p.cout) out[m * p.cout + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  dtype: 0 = bf16, 1 = f32
// (x, weight, bias and out share it; bias may be null).  All tensors are
// contiguous in the layouts named at the top of this file.
int sdtpu_conv3x3(const void* x, const void* w, const void* bias, void* out, int dtype,
                  int batch, int h, int width, int cin, int cout, void* stream) {
  if (batch <= 0 || h <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Params p = {x, w, bias, out, batch, h, width, cin, cout, int64_t(batch) * h * width};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dim3 grid(unsigned((p.m + kFM - 1) / kFM), unsigned((cout + kFN - 1) / kFN));
    conv3x3_f32_kernel<<<grid, 256, 0, s>>>(p);
    return int(cudaGetLastError());
  }
  dim3 grid(unsigned((p.m + kBM - 1) / kBM), unsigned((cout + kBN - 1) / kBN));
  const bool vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    conv3x3_bf16_kernel<true><<<grid, kThreads, 0, s>>>(p);
  else
    conv3x3_bf16_kernel<false><<<grid, kThreads, 0, s>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"

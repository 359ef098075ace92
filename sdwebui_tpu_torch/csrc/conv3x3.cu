// 3x3, stride 1, pad 1 convolution for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel of sdwebui_tpu/ops/conv.py:43-56 (`_kernel`,
// reached through `conv3x3` :75-121): out = sum over the 9 taps (dy, dx) of
// x[.., h+dy-1, w+dx-1, :] @ w[dy, dx] in fp32, + bias, cast once to x's
// dtype.  The TPU version builds overlapping padded row windows outside the
// kernel so that BlockSpec can pipeline them (conv.py:86-94); here nothing
// is padded or copied in device memory.
//
// Layout: x channels-last (B, H, W, Cin); weight (Cout, 3, 3, Cin), the
// channels-last form of OIHW; out channels-last (B, H, W, Cout).
//
// What bounds it on the H100: 2*B*H*W*9*Cin*Cout flops over ~2 bytes per
// input/weight/output element: at the UNet's shapes (Cin = 320..1280) that
// is hundreds of flops per byte, so it is bound by the tensor cores.  The
// design is an implicit GEMM (M = output pixels, N = Cout, K = 9 taps x Cin):
//
// bf16: `conv_wgmma_kernel`, warp-specialised, wgmma fed by TMA.
//   - The M tile is a rectangle of TW x TH = 128 output pixels of one image
//     (64x2, 32x4 or 16x8, picked by the wrapper from W); the N tile is BN
//     output channels (160 for Cout = 320, 640, 1280: no tile is wasted).
//   - A: one 4-D tensor map over x as (C, W, H, B), box (64, TW, TH, 1),
//     128-byte swizzle.  For tap (dy, dx) the box at (c0, w0+dx-1, h0+dy-1,
//     b) is loaded; TMA fills every element outside the tensor (negative
//     coordinates too) with zeros, so the border needs no code.  The box
//     lands as 128 pixel rows x 128 bytes: the K-major, 128-byte swizzled
//     layout of wgmma's A descriptor.
//   - B: a 3-D map over the weight as (Cin, 9, Cout), box (64, 1, BN): past
//     Cin it reads zeros, never the next tap's weights.
//   - One producer warp keeps a ring of up to 5 stages (A + B) in flight,
//     each with full/empty mbarriers; two consumer warpgroups of 64 pixel
//     rows each issue wgmma m64nBNk16 from shared memory, keeping one group
//     in flight, so no __syncthreads sits in the loop.
//   - Few output tiles (the 32² and 16² levels at B = 2) leave SMs idle, so
//     the wrapper splits the 9 * ceil(Cin / 64) k-steps over a cluster of up
//     to 8 blocks.  Each block dumps its fp32 partial tile into its own (by
//     then idle) ring buffers; after a cluster barrier, block r sums slice r
//     of the tile over the blocks in rank order through distributed shared
//     memory (a fixed order: the result is the same on every run; no
//     atomics, no scratch in device memory) and stores it.
//   - Epilogue: + bias in fp32, one cast, channels-last stores masked at
//     the image's edge and at Cout.
// f32: `conv_f32_kernel`, exact fp32 FMAs (no TF32), tiled as an SGEMM: 128
//   pixels x 128 output channels per 256-thread block (two an SM), 8 x 8
//   outputs per thread, k-steps of 16 channels of one tap stored K-major
//   (each pixel's and output channel's 16 channels contiguous, read as
//   conflict-free float4s), double buffered with 16-byte cp.async (zero
//   source size outside the image; Cin a multiple of 4, as the wrapper pads).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "host.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may use

// 1024-byte aligned start of dynamic shared memory (the 128-byte swizzle's
// period), with the slack requested at launch
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

struct ConvParams {
  void* out;
  const __nv_bfloat16* bias;   // may be null
  int h, w, cout;
  int tw, th;                  // the output rectangle: tw * th = 128 pixels
  int tiles_w, tiles_h;        // rectangles per image along W and H
  int chunks;                  // 64-channel chunks of Cin
};

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;         // output pixels per block (2 consumer warpgroups x 64)
constexpr int kThreads = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int kA = kBM * 128;    // one stage of A: 128 pixels x 64 channels, bytes
constexpr int kMaxSplits = 8;    // the k-step splits of one cluster (its portable size)

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = kA + B_BYTES;
  static constexpr int STAGES = (kMaxSmem - 2048) / STAGE < 5 ? (kMaxSmem - 2048) / STAGE : 5;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static constexpr int DUMP = 256 * (BN / 2) * 4;   // the fp32 partial tile of a split
  static_assert(STAGES >= 2 && SMEM <= kMaxSmem, "ring does not fit");
  static_assert(DUMP <= STAGES * STAGE, "the partial tile must fit the ring");
};

// where this block's output tile starts: image, row, column, channel
struct Origin {
  int b, h0, w0, n0;
};

// out[pixel (row of the tile), col .. col + 1] = v + bias, masked
__device__ __forceinline__ void store_pair(const ConvParams& p, const Origin& o, int row, int col,
                                           float v0, float v1) {
  const int hh = o.h0 + row / p.tw, ww = o.w0 + row % p.tw;
  const int n = o.n0 + col;
  if (hh >= p.h || ww >= p.w || n >= p.cout) return;
  if (p.bias) {
    v0 += __bfloat162float(p.bias[n]);
    if (n + 1 < p.cout) v1 += __bfloat162float(p.bias[n + 1]);
  }
  __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) +
                       ((int64_t(o.b) * p.h + hh) * p.w + ww) * p.cout + n;
  if (p.cout % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16(v0);
    if (n + 1 < p.cout) dst[1] = __float2bfloat16(v1);
  }
}

// float4 q of a warpgroup pair's accumulators (q = i * 256 + consumer
// thread): registers 4i .. 4i + 3 of that thread, i.e. rows g and g + 8 of
// its warp's 16, columns 8i + 2(lane % 4) and the next
__device__ __forceinline__ void store_quad(const ConvParams& p, const Origin& o, int q, float4 v) {
  const int i = q / 256, th = q % 256;
  const int lane = th % 32;
  const int row = (th / 32) * 16 + lane / 4;   // (warpgroup * 4 + warp) * 16 + g
  const int col = 8 * i + 2 * (lane % 4);
  store_pair(p, o, row, col, v.x, v.y);
  store_pair(p, o, row + 8, col, v.z, v.w);
}

// SPLIT: the block is rank blockIdx.x of a cluster of gridDim.x blocks, each
// taking one contiguous range of the k-steps
template <int BN, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const ConvParams p) {
  using T = Tile<BN>;
  constexpr int ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);   // stage s: A at s * STAGE, B after it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * T::STAGE);
  uint64_t* empty = full + ST;

  const int rank = SPLIT ? int(blockIdx.x) : 0;
  const int splits = SPLIT ? int(gridDim.x) : 1;
  const int per_image = p.tiles_w * p.tiles_h;
  const int mt = blockIdx.z;
  const int rect = mt % per_image;
  const Origin o = {mt / per_image, (rect / p.tiles_w) * p.th, (rect % p.tiles_w) * p.tw,
                    int(blockIdx.y) * BN};
  const int ksteps = 9 * p.chunks;
  const int k0 = rank * ksteps / splits;
  const int n_steps = (rank + 1) * ksteps / splits - k0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer: one thread issues the TMA loads
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_steps; ++t) {
        const int k = k0 + t;
        const int tap = k / p.chunks;
        const int c0 = (k - tap * p.chunks) * 64;
        const int s = t % ST;
        mbar_wait(empty + s, ((t / ST) & 1) ^ 1);
        mbar_expect_tx(full + s, T::STAGE);
        uint8_t* a = ring + s * T::STAGE;
        tma_load_4d(a, &tx, full + s, c0, o.w0 + tap % 3 - 1, o.h0 + tap / 3 - 1, o.b);
        tma_load_3d(a + kA, &tw, full + s, c0, tap, o.n0);
      }
    }
    if (SPLIT) {   // every thread of the cluster meets both cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // consumers: warpgroup c owns pixel rows [64c, 64c + 64) of the tile
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int th = threadIdx.x - 128;   // 0..255
  const int lane = th % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t ring_addr = smem_addr(ring);

  for (int t = 0; t < n_steps; ++t) {
    const int s = t % ST;
    mbar_wait(full + s, (t / ST) & 1);
    const uint32_t a_addr = ring_addr + s * T::STAGE + c * 64 * 128;
    const uint32_t b_addr = ring_addr + s * T::STAGE + kA;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 64 channels: four k-steps of 16 (32 bytes)
      wgmma_ss<BN>(acc, wgmma_desc(a_addr + kk * 32, 16, 1024, 1),
                   wgmma_desc(b_addr + kk * 32, 16, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<1>();   // the previous step's products are done: free its stage
    fence_regs(acc);
    if (t > 0 && lane == 0) mbar_arrive(empty + (t - 1) % ST);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  if (!SPLIT) {
    const int row = c * 64 + (th % 128 / 32) * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      store_pair(p, o, row, col, acc[4 * i], acc[4 * i + 1]);
      store_pair(p, o, row + 8, col, acc[4 * i + 2], acc[4 * i + 3]);
    }
    return;
  }

  // split: the partial tile into this block's ring (every load into it has
  // landed, and the other warpgroup's products no longer read it), float4
  // q = i * 256 + th
  named_bar_sync(1, 256);
  float4* dump = reinterpret_cast<float4*>(ring);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
    dump[i * 256 + th] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  cluster_sync();   // every block's partial is in place
  // block `rank` sums its slice of the tile over the blocks, in rank order
  constexpr int Q = BN / 8 * 256;
  const int q_end = (rank + 1) * Q / splits;
  for (int q = rank * Q / splits + th; q < q_end; q += 256) {
    const uint32_t addr = ring_addr + q * 16;
    float4 sum = ld_cluster_v4(map_to_rank(addr, 0));
    for (int r = 1; r < splits; ++r) {   // the partials of the other splits
      const float4 v = ld_cluster_v4(map_to_rank(addr, r));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store_quad(p, o, q, sum);
  }
  cluster_sync();   // no block leaves while another still reads its partial
}

// ---------------------------------------------------------------------------
// f32: exact fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFM = 128, kFN = 128, kFK = 16;
constexpr int kFLd = kFK + 4;   // a row of 16 channels, +4: conflict-free float4 reads

struct F32Params {
  const float* x;
  const float* w;
  const float* bias;   // may be null
  float* out;
  int batch, h, w_, cin, cout;
  int64_t m;           // output pixels = batch * h * w_
};

// Thread (tx, ty) = (tid % 16, tid / 16) owns output rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, channels tx + 16j (j < 8).  A (pixels) and B (output
// channels) rows hold 16 consecutive input channels (K-major), so a k-group
// of 4 is one float4 from each; a warp's A reads are broadcasts and its B
// reads hit 8 distinct bank groups per quarter-warp (row stride 20 floats).
__global__ void __launch_bounds__(256, 2) conv_f32_kernel(const F32Params p) {
  __shared__ __align__(16) float as[2][kFM][kFLd];
  __shared__ __align__(16) float bs[2][kFN][kFLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = int64_t(blockIdx.x) * kFM;
  const int n0 = blockIdx.y * kFN;

  // the loads: thread tid copies channels 4 lq .. 4 lq + 3 of rows lr and
  // lr + 64 (one 16-byte cp.async each, zeros outside the image)
  const int lq = tid % 4, lr = tid / 4;
  int hw_of[2];   // each row's pixel, packed h << 16 | w (-1 past M)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + lr + 64 * i;
    const int rem = int(m % (int64_t(p.h) * p.w_));
    hw_of[i] = m < p.m ? (rem / p.w_) << 16 | (rem % p.w_) : -1;
  }

  const int chunks = (p.cin + kFK - 1) / kFK;
  const int steps = 9 * chunks;
  auto load = [&](int t, int buf) {
    const int tap = t / chunks;
    const int ch = (t - tap * chunks) * kFK + 4 * lq;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool ch_ok = ch < p.cin;
    // the pixel (h + dy, w + dx) of row m lies (dy * W + dx) pixels from m's own
    const int64_t shift = int64_t(dy) * p.w_ + dx;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      const int hh = (hw_of[i] >> 16) + dy, ww = (hw_of[i] & 0xffff) + dx;
      const bool ok = ch_ok && hw_of[i] >= 0 && hh >= 0 && hh < p.h && ww >= 0 && ww < p.w_;
      cp_async16(&as[buf][r][4 * lq], ok ? p.x + (m0 + r + shift) * p.cin + ch : p.x,
                 ok ? 16 : 0);
      const int n = n0 + r;
      const bool wok = ch_ok && n < p.cout;
      cp_async16(&bs[buf][r][4 * lq], wok ? p.w + (int64_t(n) * 9 + tap) * p.cin + ch : p.w,
                 wok ? 16 : 0);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0, 0);
  for (int t = 0; t < steps; ++t) {
    const int buf = t & 1;
    if (t + 1 < steps) {
      load(t + 1, buf ^ 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < kFK / 4; ++kq) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&as[buf][ty * 4 + i % 4 + (i / 4) * 64][4 * kq]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&bs[buf][tx + 16 * j][4 * kq]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {   // channels in order: k, k + 1, k + 2, k + 3
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    __syncthreads();   // this buffer may be refilled
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty * 4 + i % 4 + (i / 4) * 64;
    if (m >= p.m) continue;
    float* orow = p.out + m * p.cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < p.cout) orow[n] = acc[i][j] + (p.bias ? p.bias[n] : 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int tw, th, bn, splits;
};

template <int BN, bool SPLIT>
int launch_bn(const CUtensorMap& mx, const CUtensorMap& mw, const ConvParams& p, dim3 grid,
              cudaStream_t stream) {
  using T = Tile<BN>;
  static const cudaError_t attr = allow_smem(conv_wgmma_kernel<BN, SPLIT>, T::SMEM);
  if (attr != cudaSuccess) return int(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = grid.x;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = SPLIT ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, conv_wgmma_kernel<BN, SPLIT>, mx, mw, p);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <int BN>
int launch_split(const CUtensorMap& mx, const CUtensorMap& mw, const ConvParams& p, dim3 grid,
                 cudaStream_t stream) {
  return grid.x > 1 ? launch_bn<BN, true>(mx, mw, p, grid, stream)
                    : launch_bn<BN, false>(mx, mw, p, grid, stream);
}

int run_bf16(const void* x, const void* w, const void* bias, void* out, int batch, int h,
             int width, int cin, int cout, const Plan& plan, cudaStream_t stream) {
  // the plan is the wrapper's (ops/conv.conv_plan); what the kernel relies on is checked here
  if (cin % 8 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      plan.tw * plan.th != kBM || (plan.tw != 16 && plan.tw != 32 && plan.tw != 64) ||
      plan.splits < 1 || plan.splits > kMaxSplits)
    return int(cudaErrorInvalidValue);
  ConvParams p = {};
  p.out = out;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.h = h;
  p.w = width;
  p.cout = cout;
  p.tw = plan.tw;
  p.th = plan.th;
  p.tiles_w = (width + plan.tw - 1) / plan.tw;
  p.tiles_h = (h + plan.th - 1) / plan.th;
  p.chunks = (cin + 63) / 64;
  const int64_t m_tiles = int64_t(batch) * p.tiles_w * p.tiles_h;
  if (m_tiles > 65535 || plan.splits > 9 * p.chunks) return int(cudaErrorInvalidValue);
  dim3 grid(unsigned(plan.splits), unsigned((cout + plan.bn - 1) / plan.bn), unsigned(m_tiles));

  CUtensorMap mx, mw;
  const cuuint64_t row = cuuint64_t(cin) * 2;   // bytes per pixel, per tap
  const cuuint64_t x_dims[4] = {cuuint64_t(cin), cuuint64_t(width), cuuint64_t(h),
                                cuuint64_t(batch)};
  const cuuint64_t x_strides[3] = {row, row * width, row * width * h};
  const cuuint32_t x_box[4] = {64, cuuint32_t(plan.tw), cuuint32_t(plan.th), 1};
  const cuuint64_t w_dims[3] = {cuuint64_t(cin), 9, cuuint64_t(cout)};
  const cuuint64_t w_strides[2] = {row, row * 9};
  const cuuint32_t w_box[3] = {64, 1, cuuint32_t(plan.bn)};
  if (!encode_bf16(&mx, x, 4, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(&mw, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return int(cudaErrorInvalidValue);
  switch (plan.bn) {
    case 32: return launch_split<32>(mx, mw, p, grid, stream);
    case 64: return launch_split<64>(mx, mw, p, grid, stream);
    case 96: return launch_split<96>(mx, mw, p, grid, stream);
    case 128: return launch_split<128>(mx, mw, p, grid, stream);
    case 160: return launch_split<160>(mx, mw, p, grid, stream);
    case 192: return launch_split<192>(mx, mw, p, grid, stream);
    case 256: return launch_split<256>(mx, mw, p, grid, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int BN>
int clusters_bn(int size) {
  using T = Tile<BN>;
  int n = 0;
  if (size == 1) {
    cudaError_t err = allow_smem(conv_wgmma_kernel<BN, false>, T::SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_wgmma_kernel<BN, false>,
                                                          kThreads, T::SMEM);
    return err == cudaSuccess ? n * sm_count() : -int(err);
  }
  cudaError_t err = allow_smem(conv_wgmma_kernel<BN, true>, T::SMEM);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(size));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = T::SMEM;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = unsigned(size);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, conv_wgmma_kernel<BN, true>, &cfg);
  return err == cudaSuccess ? n : -int(err);
}

}  // namespace

extern "C" {

// How many clusters of `size` blocks (1-8) of the bf16 kernel at N tile bn
// the current card holds at once (for size 1: blocks); a negative
// cudaError_t code on failure.  The wrapper's split rule reads it.
int sdtpu_conv3x3_clusters(int bn, int size) {
  if (size < 1 || size > kMaxSplits) return -int(cudaErrorInvalidValue);
  switch (bn) {
    case 32: return clusters_bn<32>(size);
    case 64: return clusters_bn<64>(size);
    case 96: return clusters_bn<96>(size);
    case 128: return clusters_bn<128>(size);
    case 160: return clusters_bn<160>(size);
    case 192: return clusters_bn<192>(size);
    case 256: return clusters_bn<256>(size);
    default: return -int(cudaErrorInvalidValue);
  }
}


// Returns 0 on success, else a cudaError_t code.  dtype: 0 = bf16, 1 = f32
// (x, weight, bias and out share it; bias may be null).  All tensors are
// contiguous in the layouts named at the top of this file, x and weight
// 16-byte aligned.  bf16 takes the wrapper's plan (ops/conv.conv_plan): the
// output rectangle tw x th, the N tile bn (32, 64, 96, 128, 160, 192 or 256)
// and the k-step splits (1-8, one cluster), and Cin a multiple of 8 (TMA);
// f32 ignores the plan and takes Cin a multiple of 4.
int sdtpu_conv3x3(const void* x, const void* w, const void* bias, void* out, int dtype,
                  int batch, int h, int width, int cin, int cout, int tw, int th, int bn,
                  int splits, void* stream) {
  if (batch <= 0 || h <= 0 || width <= 0 || cin <= 0 || cout <= 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run_bf16(x, w, bias, out, batch, h, width, cin, cout, {tw, th, bn, splits}, s);
  if (cin % 4 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return int(cudaErrorInvalidValue);   // 16-byte cp.async rows
  F32Params p = {static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<const float*>(bias), static_cast<float*>(out), batch, h, width,
                 cin, cout, int64_t(batch) * h * width};
  const int64_t m_tiles = (p.m + kFM - 1) / kFM;
  if (m_tiles > 0x7fffffff || h >= 32768 || width >= 65536) return int(cudaErrorInvalidValue);
  dim3 grid(unsigned(m_tiles), unsigned((cout + kFN - 1) / kFN));
  conv_f32_kernel<<<grid, 256, 0, s>>>(p);
  return int(cudaGetLastError());
}

}  // extern "C"

// Flash attention for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels of sdwebui_tpu/ops/flash_attention.py, whose
// Pallas bodies all share `_kernel` / `_kernel_single_kv`:
//   :111 `flash_attention`         (BH, S, D)    batch = BH, heads = 1
//   :308 `flash_attention_packed`  (B, S, H*D)   head stride D
//   :429 `flash_attention_4d`      (B, S, H, D)  head stride D, row stride H*D
//   out = softmax(q k^T * scale) v   over (batch, heads, S, D) views
// with an fp32 running max, denominator and accumulator, padded KV columns
// masked with -1e30 and the denominator floored at 1e-30.  The TPU's
// 128-lane head packing (B2) and its per-head blocks (B3) become the head
// and sequence strides of one launch: no head split or merge copy, and
// q/k/v may be the chunk views of a fused qkv projection (row stride 3*H*D).
//
// What bounds it on the H100: at the Stable Diffusion shapes (S = 1024 or
// 4096, D = 40 or 80) attention does 4*S*S*D flops per head over only
// 3*S*D inputs, so it is bound by tensor-core issue and on-chip data
// movement as long as the S x S score matrix never reaches device memory.
// The bf16 design (FlashAttention-2 on mma.sync) keeps everything on chip:
//   - one thread block of 4 warps per (batch*head, q-tile); a loop over
//     64-row KV tiles inside the block replaces the TPU grid's sequential KV
//     axis;
//   - K/V tiles stream into shared memory with cp.async (double-buffered
//     when they fit), fragments come out with ldmatrix (V transposed by
//     ldmatrix.trans), products run as mma.m16n8k16 bf16 with fp32
//     accumulation;
//   - scores, probabilities, the running max/denominator and the output
//     accumulator stay in registers; P is rounded to bf16 (the value dtype)
//     before P.V, as the TPU kernel does;
//   - D is zero-padded to 16 in shared memory only; device memory holds the
//     unpadded tensors, read through explicit batch, head and sequence
//     strides (last dim contiguous);
//   - D > 160 (the VAE's single 512-wide head) splits D over the warps: each
//     warp computes a partial q.k over its slice, the partials are summed in
//     shared memory, and each warp accumulates its own slice of the output;
//   - when one KV tile covers Skv the loop body runs once: the softmax is
//     exact in a single pass, as in `_kernel_single_kv`.
// f32 inputs (the VAE's NaN retry) take exact fp32 products on the CUDA
// cores instead of TF32, so that path keeps full precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // large-but-finite, as the TPU kernel
constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may use
constexpr int kWarps = 4;
constexpr int kBK = 64;            // kv rows per tile (bf16 kernel)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int batch, heads, sq, skv, d;
  int dp;              // bf16: padded head dim held in shared memory
  int bq, bk;          // q rows and kv rows per tile
  int ld;              // row stride of the q/k/v tiles in shared memory
  int split;           // bf16: warps sharing one row group (split of D)
  int stages;          // bf16: k/v buffers (2 = prefetch the next tile)
  int vec;             // bf16: 16-byte cp.async loads are aligned
  int ld_s, ld_o;      // f32: score and output row strides in shared memory
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------------

// Copy `rows` x dp of a (rows_valid x d) strided tile into shared memory,
// zero-filling ragged rows and padded columns (d is a multiple of 8).
__device__ void load_tile_bf16(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src,
                               int64_t row_stride, int rows_valid, int rows, int d, int dp,
                               bool vec) {
  const int chunks = dp / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    __nv_bfloat16* out = dst + r * ld + col;
    const bool ok = r < rows_valid && col < d;
    if (vec) {
      cp_async16(out, ok ? src + r * row_stride + col : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        out[e] = ok ? src[r * row_stride + col + e] : __float2bfloat16(0.f);
    }
  }
}

template <int DW>  // head-dim columns per warp (multiple of 16, <= 160)
__global__ void __launch_bounds__(kWarps * 32) flash_attention_bf16_kernel(Params p) {
  constexpr int KC = DW / 16;   // 16-wide k chunks of q.k over the warp's slice
  constexpr int OT = DW / 8;    // 8-wide output column tiles
  constexpr int NT = kBK / 8;   // 8-wide score column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = p.ld;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs = qs + p.bq * ld;           // stages x (k tile, v tile)
  float* partial = reinterpret_cast<float*>(kvs + p.stages * 2 * kBK * ld);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp / p.split;   // row group: 16 q rows
  const int sp = warp % p.split;   // head-dim slice
  const int d0 = sp * DW;
  const int g = lane / 4;          // fragment row (and row + 8)
  const int tq = lane % 4;         // fragment column pair
  const bool vec = p.vec != 0;

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * p.bq;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
  const int q_valid = min(p.bq, p.sq - q0);
  const int n_tiles = (p.skv + kBK - 1) / kBK;

  auto issue = [&](int t) {
    const int kv0 = t * kBK;
    const int kv_valid = min(kBK, p.skv - kv0);
    __nv_bfloat16* ks = kvs + (p.stages == 2 ? (t & 1) : 0) * 2 * kBK * ld;
    load_tile_bf16(ks, ld, kg + kv0 * p.k_ss, p.k_ss, kv_valid, kBK, p.d, p.dp, vec);
    load_tile_bf16(ks + kBK * ld, ld, vg + kv0 * p.v_ss, p.v_ss, kv_valid, kBK, p.d, p.dp, vec);
    cp_async_commit();
  };

  load_tile_bf16(qs, ld, qg, p.q_ss, q_valid, p.bq, p.d, p.dp, vec);
  cp_async_commit();
  issue(0);
  cp_async_wait_one();   // the q tile has landed (the first k/v may be in flight)
  __syncthreads();

  // q fragments for this warp's 16 rows and head-dim slice (ldmatrix x4:
  // rows 0-7 / 8-15 x columns 0-7 / 8-15 of each 16x16 chunk)
  uint32_t qf[KC][4];
  {
    const int r = rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int c = d0 + (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) ldsm_x4(qf[kc], qs + r * ld + c + kc * 16);
  }

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};   // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    if (p.stages == 2 && t + 1 < n_tiles) {
      issue(t + 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kvs + (p.stages == 2 ? (t & 1) : 0) * 2 * kBK * ld;
    const __nv_bfloat16* vs = ks + kBK * ld;
    const int kv0 = t * kBK;

    // s (16 x 64) = q . k^T over this warp's head-dim slice
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jn = 0; jn < NT / 2; ++jn) {
        uint32_t bf[4];   // b0/b1 of score tiles 2jn and 2jn+1
        const int r = jn * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = d0 + kc * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(bf, ks + r * ld + c);
        mma_bf16(s[2 * jn], qf[kc], bf[0], bf[1]);
        mma_bf16(s[2 * jn + 1], qf[kc], bf[2], bf[3]);
      }
    }
    if (p.split > 1) {   // sum the head-dim slices' partial scores
      float* mine = partial + warp * (NT * 4 * 32);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * 32 + lane] = s[j][e];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float acc = 0.f;
          for (int x = 0; x < p.split; ++x)
            acc += partial[(rg * p.split + x) * (NT * 4 * 32) + (j * 4 + e) * 32 + lane];
          s[j][e] = acc;
        }
    }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * tq + (e & 1);
        const float v = col < p.skv ? s[j][e] * p.scale : kNegInf;
        s[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = __expf(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = __expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = pv;
        l_run[e >> 1] += pv;
      }
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o (16 x DW) += p (16 x 64, bf16) . v[:, slice]
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int jo = 0; jo < OT / 2; ++jo) {
        uint32_t bf[4];   // b0/b1 of output tiles 2jo and 2jo+1 (v transposed)
        const int r = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = d0 + jo * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(bf, vs + r * ld + c);
        mma_bf16(o[2 * jo], pa, bf[0], bf[1]);
        mma_bf16(o[2 * jo + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();   // this k/v buffer (and the partials) may be refilled
    if (p.stages == 1 && t + 1 < n_tiles) issue(t + 1);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] = fmaxf(l_run[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < OT; ++j) {
    const int col = d0 + j * 8 + 2 * tq;
    if (col >= p.d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rg * 16 + g + 8 * i;
      if (r < q_valid) {
        *reinterpret_cast<__nv_bfloat162*>(og + r * p.o_ss + col) =
            __floats2bfloat162_rn(o[j][2 * i] / l_run[i], o[j][2 * i + 1] / l_run[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: exact fp32 products on the CUDA cores
// ---------------------------------------------------------------------------
// The whole block works on each tile: all threads compute the bq x bk scores,
// one warp per row runs the online softmax, all threads update the bq x d
// output in shared memory.  Products stay fp32 (no TF32), so the path keeps
// full precision.

constexpr int kF32Threads = 256;

// Copy a (rows_valid x d) strided tile into `rows` x d, zero-filling the rest.
__device__ void load_tile_f32(float* dst, int ld, const float* src, int64_t row_stride,
                              int rows_valid, int rows, int d) {
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    dst[r * ld + c] = r < rows_valid ? src[r * row_stride + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kF32Threads) flash_attention_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // bq x ld
  float* ks = qs + p.bq * p.ld;                 // bk x ld
  float* vs = ks + p.bk * p.ld;                 // bk x ld
  float* ss = vs + p.bk * p.ld;                 // bq x ld_s: scores, then probabilities
  float* os = ss + p.bq * p.ld_s;               // bq x ld_o: output accumulator
  float* m_s = os + p.bq * p.ld_o;              // bq running max
  float* l_s = m_s + p.bq;                      // bq running denominator
  float* a_s = l_s + p.bq;                      // bq rescale of this tile

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int q0 = blockIdx.y * p.bq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
  const int d = p.d;

  const int q_valid = min(p.bq, p.sq - q0);
  load_tile_f32(qs, p.ld, qg, p.q_ss, q_valid, p.bq, d);
  for (int idx = threadIdx.x; idx < p.bq * p.ld_o; idx += blockDim.x) os[idx] = 0.f;
  for (int r = threadIdx.x; r < p.bq; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int n_tiles = (p.skv + p.bk - 1) / p.bk;
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * p.bk;
    const int kv_valid = min(p.bk, p.skv - kv0);
    __syncthreads();   // the previous tile's k/v/p are no longer read
    load_tile_f32(ks, p.ld, kg + kv0 * p.k_ss, p.k_ss, kv_valid, p.bk, d);
    load_tile_f32(vs, p.ld, vg + kv0 * p.v_ss, p.v_ss, kv_valid, p.bk, d);
    __syncthreads();

    // s = q . k^T * scale, padded kv columns masked
    for (int idx = threadIdx.x; idx < p.bq * p.bk; idx += blockDim.x) {
      const int r = idx / p.bk;
      const int c = idx - r * p.bk;
      const float* qr = qs + r * p.ld;
      const float* kr = ks + c * p.ld;
      float acc = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < d; ++kk) acc = fmaf(qr[kk], kr[kk], acc);
      ss[r * p.ld_s + c] = c < kv_valid ? acc * p.scale : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < p.bq; r += n_warps) {
      float* row = ss + r * p.ld_s;
      float mx = kNegInf;
      for (int c = lane; c < p.bk; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < p.bk; c += 32) {
        const float pv = expf(row[c] - m_new);
        row[c] = pv;
        sum += pv;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // o = o * alpha + p . v
    for (int idx = threadIdx.x; idx < p.bq * d; idx += blockDim.x) {
      const int r = idx / d;
      const int c = idx - r * d;
      const float* pr = ss + r * p.ld_s;
      float acc = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < p.bk; ++kk) acc = fmaf(pr[kk], vs[kk * p.ld + c], acc);
      float* o = os + r * p.ld_o + c;
      *o = *o * a_s[r] + acc;
    }
  }

  __syncthreads();
  for (int idx = threadIdx.x; idx < q_valid * d; idx += blockDim.x) {
    const int r = idx / d;
    const int c = idx - r * d;
    og[r * p.o_ss + c] = os[r * p.ld_o + c] / fmaxf(l_s[r], 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t smem_f32(const Params& p) {
  return 4 * (size_t(p.bq + 2 * p.bk) * p.ld + size_t(p.bq) * (p.ld_s + p.ld_o + 3));
}

// f32: the largest tiles whose working set fits one block's shared memory
// (64 x 64 up to d = 112; 32 q rows x 16 kv rows at the VAE's d = 512).
bool choose_f32_tiles(Params& p) {
  static const int kTiles[][2] = {{64, 64}, {64, 32}, {32, 32}, {32, 16}, {16, 16}, {16, 8}};
  p.ld = p.d + 1;   // odd: lanes reading different k/q rows hit different banks
  p.ld_o = p.d;
  for (const auto& t : kTiles) {
    p.bq = t[0];
    p.bk = t[1];
    p.ld_s = p.bk + 1;
    if (smem_f32(p) <= size_t(kMaxSmem)) return true;
  }
  return false;
}

size_t smem_bf16(const Params& p) {
  return 2 * (size_t(p.bq) * p.ld + size_t(p.stages) * 2 * kBK * p.ld) +
         (p.split > 1 ? size_t(kWarps) * (kBK / 8) * 4 * 32 * 4 : 0);
}

template <int DW>
int launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bf16(p);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bf16_kernel<DW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned(p.batch) * unsigned(p.heads), unsigned((p.sq + p.bq - 1) / p.bq));
  flash_attention_bf16_kernel<DW><<<grid, kWarps * 32, smem, stream>>>(p);
  return int(cudaGetLastError());
}

int run_bf16(Params p, cudaStream_t stream) {
  // head-dim slice per warp: all of D up to 160, else split over 2 or 4 warps
  int dw = round_up(p.d, 16);
  p.split = 1;
  if (dw > 160) {
    p.split = round_up(p.d, 32) / 2 <= 160 ? 2 : 4;
    dw = round_up(p.d, 16 * p.split) / p.split;
  }
  p.dp = dw * p.split;
  p.ld = p.dp + 8;   // 16-byte rows, (ld / 2) words = 4 x odd: conflict-free ldmatrix
  p.bq = 16 * (kWarps / p.split);
  p.bk = kBK;
  p.stages = 2;
  if (smem_bf16(p) > size_t(kMaxSmem)) p.stages = 1;
  if (smem_bf16(p) > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  switch (dw) {
    case 16: return launch_bf16<16>(p, stream);
    case 32: return launch_bf16<32>(p, stream);
    case 48: return launch_bf16<48>(p, stream);
    case 64: return launch_bf16<64>(p, stream);
    case 80: return launch_bf16<80>(p, stream);
    case 96: return launch_bf16<96>(p, stream);
    case 112: return launch_bf16<112>(p, stream);
    case 128: return launch_bf16<128>(p, stream);
    case 144: return launch_bf16<144>(p, stream);
    case 160: return launch_bf16<160>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

int run_f32(Params p, cudaStream_t stream) {
  if (!choose_f32_tiles(p)) return int(cudaErrorInvalidValue);
  const size_t smem = smem_f32(p);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(unsigned(p.batch) * unsigned(p.heads), unsigned((p.sq + p.bq - 1) / p.bq));
  flash_attention_f32_kernel<<<grid, kF32Threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

bool aligned16(const void* ptr, int64_t sb, int64_t sh, int64_t ss) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && sh % 8 == 0 &&
         ss % 8 == 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  dtype: 0 = bf16, 1 = f32.
// Strides are in elements; the last dim is contiguous; d is a multiple of 8
// and at most 512.  A bf16 output's strides must be even (bf16 pairs).
int sdtpu_flash_attention(const void* q, const void* k, const void* v, void* o, int dtype,
                          int batch, int heads, int sq, int skv, int d,
                          int64_t q_sb, int64_t q_sh, int64_t q_ss,
                          int64_t k_sb, int64_t k_sh, int64_t k_ss,
                          int64_t v_sb, int64_t v_sh, int64_t v_ss,
                          int64_t o_sb, int64_t o_sh, int64_t o_ss,
                          float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || d <= 0 || d > 512 || d % 8 != 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.batch = batch; p.heads = heads; p.sq = sq; p.skv = skv; p.d = d;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_f32(p, s);
  if (reinterpret_cast<uintptr_t>(o) % 4 != 0 || o_sb % 2 || o_sh % 2 || o_ss % 2)
    return int(cudaErrorInvalidValue);
  p.vec = aligned16(q, q_sb, q_sh, q_ss) && aligned16(k, k_sb, k_sh, k_ss) &&
          aligned16(v, v_sb, v_sh, v_ss);
  return run_bf16(p, s);
}

}  // extern "C"

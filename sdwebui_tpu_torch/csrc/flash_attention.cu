// Flash attention for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels of sdwebui_tpu/ops/flash_attention.py, whose
// Pallas bodies all share `_kernel` / `_kernel_single_kv`:
//   :111 `flash_attention`         (BH, S, D)    batch = BH, heads = 1
//   :308 `flash_attention_packed`  (B, S, H*D)   head stride D
//   :429 `flash_attention_4d`      (B, S, H, D)  head stride D, row stride H*D
//   out = softmax(q k^T * scale) v   over (batch, heads, S, D) views
// with an fp32 running max, denominator and accumulator, padded KV columns
// masked with -1e30, P rounded to the value dtype (bf16) before P.V, and the
// denominator floored at 1e-30.  The TPU's 128-lane head packing (B2) and
// its per-head blocks (B3) become the head and sequence strides of one
// launch: no head split or merge copy, and q/k/v may be the chunk views of
// a fused qkv projection (row stride 3*H*D).
//
// Three device kernels, picked by (dtype, d):
//
// 1. bf16, d <= 128 (the UNet heads, d = 40, 64, 80): `attn_tc_kernel`.
//    At S = 1024-4096 attention does 4*S*S*d flops per head over 3*S*d
//    inputs: it is bound by the tensor cores as long as the S x S scores
//    stay on chip, and, at d <= 64, just as much by the exponentials (the
//    card's 16 per clock per SM take as long as the products of a 64-wide
//    head).  So the design keeps both units busy at once:
//    - warp specialisation: one producer warpgroup (registers cut to 24
//      with setmaxnreg) and two consumer warpgroups of 64 q rows each (128
//      q rows per block, 168 registers a thread: ptxas keeps the launch
//      bound's limit whatever setmaxnreg grants, so O, S and P must fit it;
//      past d = 80 the kv tile halves to 64 rows);
//    - the producer's single thread issues TMA tensor loads: the q tile
//      once, then a ring of 2 K and 2 V stages, each stage with full/empty
//      mbarriers, so loads run ahead of the math and no __syncthreads sits
//      in the loop;
//    - S = Q K^T is wgmma m64nNk16 with both operands in shared memory;
//      O += P V is wgmma in its register-A form, P converted in place from
//      the S accumulator, V read MN-major (d contiguous) through the
//      descriptor's transpose bit, so no transpose copy is made;
//    - the consumers take turns at the tensor cores (two named barriers):
//      one issues Q K^T(t + 1) and P V(t) while the other runs its softmax,
//      and each waits only for its scores before its own softmax starts,
//      so P V(t) finishes under the softmax of t + 1;
//    - the online softmax runs in registers (exp2 with the scale folded in);
//    - the head dim is padded to 16 (the wgmma k-step) by TMA's zero fill
//      of out-of-bounds columns: each tensor map is (d, S, H, B) with d
//      innermost, so a box wider than d reads zeros, never the next head;
//      the swizzle is the widest (128, 64 or 32 bytes) dividing the padded
//      row, one box per swizzle span (d = 40: three 32-byte boxes);
//    - the epilogue divides by the sum and stores bf16 through the output's
//      strides, masking ragged rows.
// 2. bf16, 128 < d <= 512 (the VAE's single 512-wide head): `attn_wide_kernel`.
//    Tensor-bound like kernel 1 (d = 512 makes the exponentials cheap), but
//    a 64 x 512 fp32 output does not fit one warpgroup's registers.  The
//    two consumer warpgroups split d rather than each recomputing S (which
//    would double the Q K^T flops): each computes partial scores over its
//    half of d (wgmma, 64 q rows x 64 kv rows), the halves are exchanged
//    through shared memory (two named barriers per tile) and both run the
//    same softmax, then each accumulates its half of O with register-A
//    wgmma.  One producer warp, not a warpgroup: 288 threads leave 168
//    registers a thread all the same (three warps share a quarter of the
//    register file), so at d = 512 ptxas spills some and serialises the
//    products.  64 q rows per block keep the K/V re-reads to S / 64 per
//    head; one K and one V buffer (64 KB each at d = 512)
//    fill shared memory, and K of the next tile loads while P V runs.  At
//    S = 4096 that is 64 blocks for 132 SMs, so where one block per q tile
//    would leave half the SMs idle, a cluster of two blocks splits the kv
//    range and merges (m, l, O) through distributed shared memory (as
//    flash-decoding does, but with no scratch in device memory).
// 3. f32, any d (the VAE's fp32 retry and forced f32 calls): `attn_f32_kernel`.
//    Products stay exact fp32 FMAs (TF32 off, 1e-4 against the plain
//    version).  Bound by shared-memory reads, so every value read feeds
//    several FMAs from register micro-tiles: Q K^T in 4 x 4 tiles per thread
//    with the d-reduction split over four thread groups, P V in 4 x 16
//    tiles.  32 q rows and 32 kv rows per tile; K of the next tile loads
//    (cp.async) during P V, V during the next Q K^T.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "host.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // large-but-finite, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;   // 227 KB: the most one block may use

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1024-byte aligned start of dynamic shared memory (the 128-byte swizzle's
// period), with the slack requested at launch
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

struct OutParams {
  void* o;
  int64_t o_sb, o_sh, o_ss;
  int sq, skv, d;
  float scale_log2;   // scale * log2(e): the softmax runs in exp2
};

// ---------------------------------------------------------------------------
// online softmax over one tile of a wgmma accumulator (rows g and g + 8 of
// each warp's 16); returns nothing, leaves P (fp32) in s
// ---------------------------------------------------------------------------
template <int NS>   // accumulator floats per thread: N / 2
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], int kv0, int skv, float scale_log2,
                                             int lane) {
  const bool tail = kv0 + NS * 2 > skv;
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (tail && kv0 + 8 * j + 2 * (lane & 3) + (e & 1) >= skv) x = kNegInf;
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = fast_exp2(m_run[i] - mx[i]);
    m_run[i] = mx[i];
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = fast_exp2(s[4 * j + e] - m_run[e >> 1]);
      s[4 * j + e] = pv;
      l_run[e >> 1] += pv;
    }
}

// P (bf16) as register A fragments, one per 16 kv columns
template <int NS>
__device__ __forceinline__ void p_fragments(const float (&s)[NS], uint32_t (&pa)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// o / l as bf16 at rows row0 + {0, 8}, columns col0 + 8j + 2(lane % 4)
template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO], float (&l_run)[2],
                                           const OutParams& p, int b, int h, int row0, int col0,
                                           int lane) {
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
    if (col >= p.d) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < p.sq)
        *reinterpret_cast<__nv_bfloat162*>(og + r * p.o_ss + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 1: bf16, d <= 128
// ---------------------------------------------------------------------------

constexpr int kBM = 128;     // q rows per block (2 consumer warpgroups x 64)
constexpr int kStages = 2;   // K and V buffers each
constexpr int kThreads = 384;
constexpr int kTurn = 1;      // named barriers 1 and 2: the consumers' turns

template <int DK>   // head dim padded to 16
struct TcTile {
  // kv rows per tile: 128, or 64 where O, S and P together would pass the
  // 168 registers a thread of a 384-thread block gets (ptxas spills and
  // serialises the wgmma pipeline there)
  static constexpr int BN = DK <= 80 ? 128 : 64;
  static constexpr int SW = DK % 64 == 0 ? 128 : DK % 32 == 0 ? 64 : 32;   // swizzle bytes
  static constexpr int BOXW = SW / 2;                                       // columns per box
  static constexpr int NBOX = DK * 2 / SW;
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int Q_BYTES = kBM * DK * 2;
  static constexpr int KV_BYTES = BN * DK * 2;
  static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 128 + 1024;
};

template <int DK>
__global__ void __launch_bounds__(kThreads, 1)
    attn_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const OutParams p) {
  using T = TcTile<DK>;
  constexpr int BN = T::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + T::Q_BYTES;                 // kStages K tiles
  uint8_t* vs = ks + kStages * T::KV_BYTES;      // kStages V tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * T::KV_BYTES);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (p.skv + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty_k + s, 8);   // one arrival per consumer warp
      mbar_init(empty_v + s, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::NBOX; ++x)
        tma_load_4d(qs + x * kBM * T::SW, &tq, full_q, x * T::BOXW, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t ph = (t / kStages) & 1;
        mbar_wait(empty_k + s, ph ^ 1);
        mbar_expect_tx(full_k + s, T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
          tma_load_4d(ks + s * T::KV_BYTES + x * BN * T::SW, &tk, full_k + s, x * T::BOXW,
                      t * BN, h, b);
        mbar_wait(empty_v + s, ph ^ 1);
        mbar_expect_tx(full_v + s, T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
          tma_load_4d(vs + s * T::KV_BYTES + x * BN * T::SW, &tv, full_v + s, x * T::BOXW,
                      t * BN, h, b);
      }
    }
  } else {
    // consumers: warpgroup c owns q rows [64c, 64c + 64) of the block.  The
    // two take turns at the tensor cores (named barriers kTurn + c): one
    // issues P.V(t) and Q.K^T(t + 1) while the other runs its softmax.
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    float o[DK / 2];
#pragma unroll
    for (int i = 0; i < DK / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    float sc[BN / 2];
    const uint32_t q_addr = smem_addr(qs) + c * 64 * T::SW;

    // S = Q K^T over d (k-steps of 16 columns; a box per swizzle span)
    auto issue_qk = [&](int s) {
      const uint32_t k_addr = smem_addr(ks + s * T::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        const int box = kk * 32 / T::SW;
        const int off = kk * 32 % T::SW;
        const uint64_t da =
            wgmma_desc(q_addr + box * kBM * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
        const uint64_t db =
            wgmma_desc(k_addr + box * BN * T::SW + off, 16, 8 * T::SW, T::LAYOUT);
        wgmma_ss<BN>(sc, da, db, kk > 0);
      }
    };

    // O += P V: V is MN-major (d contiguous); a k-step is 16 kv rows
    auto issue_pv = [&](int s, const uint32_t (&pa)[BN / 16][4]) {
      const uint32_t v_addr = smem_addr(vs + s * T::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db =
            wgmma_desc(v_addr + kk * 16 * T::SW, BN * T::SW, 8 * T::SW, T::LAYOUT);
        wgmma_rs<DK>(o, pa[kk], db, 1);
      }
    };

    // the first turn: Q K^T(0).  Every sync on a turn barrier meets one
    // arrival from the other warpgroup; no wgmma sits in a branch (ptxas
    // would serialise the pipeline)
    if (c == 1) named_bar_arrive(kTurn, 256);   // warpgroup 0 goes first
    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    named_bar_sync(kTurn + c, 256);
    fence_regs(sc);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    named_bar_arrive(kTurn + 1 - c, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(empty_k);
    float alpha[2];
    uint32_t pa[BN / 16][4];
    softmax_tile(sc, m_run, l_run, alpha, 0, p.skv, p.scale_log2, lane);
    p_fragments(sc, pa);

    // one turn: Q K^T(t + 1), then P V(t) in a second group; the softmax of
    // t + 1 runs once the scores are in, while P V(t) finishes
    for (int t = 0; t + 1 < n_tiles; ++t) {
      const int s = t % kStages;
      const int s1 = (t + 1) % kStages;
      mbar_wait(full_v + s, (t / kStages) & 1);
      mbar_wait(full_k + s1, ((t + 1) / kStages) & 1);
      named_bar_sync(kTurn + c, 256);
      fence_regs(o);
      fence_regs(sc);
      wgmma_fence();
      issue_qk(s1);
      wgmma_commit();
      issue_pv(s, pa);
      wgmma_commit();
      named_bar_arrive(kTurn + 1 - c, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k + s1);
      softmax_tile(sc, m_run, l_run, alpha, (t + 1) * BN, p.skv, p.scale_log2, lane);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v + s);
      rescale(o, alpha);
      p_fragments(sc, pa);
    }
    {   // the last turn: P V alone; warpgroup 0 hands warpgroup 1 its last turn
      const int t = n_tiles - 1;
      const int s = t % kStages;
      mbar_wait(full_v + s, (t / kStages) & 1);
      named_bar_sync(kTurn + c, 256);
      fence_regs(o);
      wgmma_fence();
      issue_pv(s, pa);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (c == 0) named_bar_arrive(kTurn + 1, 256);
    }

    store_rows(o, l_run, p, b, h, q0 + c * 64 + warp * 16 + lane / 4, 0, lane);
  }
}

// ---------------------------------------------------------------------------
// kernel 2: bf16, 128 < d <= 512
// ---------------------------------------------------------------------------

constexpr int kWideBM = 64;   // q rows per block
constexpr int kWideBN = 64;   // kv rows per tile
// two consumer warpgroups and one producer warp (it only issues TMA loads)
constexpr int kWideThreads = 288;

template <int DS>   // head-dim columns per consumer warpgroup (d padded to 2 * DS)
struct WideTile {
  static constexpr int DP = 2 * DS;
  static constexpr int NBOX = DP / 64;               // 128-byte swizzle boxes of 64 columns
  static constexpr int Q_BYTES = kWideBM * DP * 2;
  static constexpr int KV_BYTES = kWideBN * DP * 2;
  static constexpr int X_BYTES = 2 * kWideBM * kWideBN * 4;   // the score halves
  static constexpr int SMEM = Q_BYTES + 2 * KV_BYTES + X_BYTES + 64 + 1024;
};

// SPLIT: a cluster of two blocks shares each q tile, each taking half of the
// kv tiles; block 1 hands its (m, l, O) to block 0 through distributed
// shared memory (into block 0's K and V buffers), and block 0 merges and
// stores.  Used when the grid would leave half the SMs idle.
template <int DS, bool SPLIT>
__global__ void __launch_bounds__(kWideThreads, 1)
    attn_wide_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const OutParams p) {
  using T = WideTile<DS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + T::Q_BYTES;
  uint8_t* vs = ks + T::KV_BYTES;
  float* xs = reinterpret_cast<float*>(vs + T::KV_BYTES);   // [2][32 floats x 128 threads]
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(xs) + T::X_BYTES);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = bars + 2;
  uint64_t* empty_k = bars + 3;
  uint64_t* empty_v = bars + 4;

  const int rank = SPLIT ? int(blockIdx.x & 1) : 0;   // the block's rank in its cluster
  const int q0 = int(SPLIT ? blockIdx.x / 2 : blockIdx.x) * kWideBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_all = (p.skv + kWideBN - 1) / kWideBN;
  const int per_block = SPLIT ? (n_all + 1) / 2 : n_all;
  const int t0 = rank * per_block;                      // this block's kv tiles
  const int n_tiles = max(0, min(n_all - t0, per_block));
  const int wg = threadIdx.x / 128;   // 0, 1: consumers; 2: the producer warp

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    mbar_init(empty_k, 8);
    mbar_init(empty_v, 8);
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer: one K and one V buffer, K(t+1) loads during P.V(t)
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::NBOX; ++x)
        tma_load_4d(qs + x * kWideBM * 128, &tq, full_q, x * 64, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t ph = t & 1;
        const int kv0 = (t0 + t) * kWideBN;
        mbar_wait(empty_k, ph ^ 1);
        mbar_expect_tx(full_k, T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
          tma_load_4d(ks + x * kWideBN * 128, &tk, full_k, x * 64, kv0, h, b);
        mbar_wait(empty_v, ph ^ 1);
        mbar_expect_tx(full_v, T::KV_BYTES);
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
          tma_load_4d(vs + x * kWideBN * 128, &tv, full_v, x * 64, kv0, h, b);
      }
    }
    if (SPLIT) {   // every thread of both blocks meets the two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    // consumers: warpgroup c owns head-dim columns [c * DS, (c + 1) * DS)
    const int c = wg;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    float o[DS / 2];
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_addr(qs);
    const uint32_t k_addr = smem_addr(ks);
    const uint32_t v_addr = smem_addr(vs) + c * (DS / 64) * kWideBN * 128;
    float* mine = xs + c * (kWideBN / 2) * 128;
    const float* theirs = xs + (1 - c) * (kWideBN / 2) * 128;
    mbar_wait(full_q, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t ph = t & 1;
      float sc[kWideBN / 2];
#pragma unroll
      for (int i = 0; i < kWideBN / 2; ++i) sc[i] = 0.f;

      // partial S over this warpgroup's columns
      mbar_wait(full_k, ph);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk) {
        const int col = c * DS + kk * 16;
        const uint32_t off = (col / 64) * 64 * 128 + (col % 64) * 2;   // box, then in the row
        const uint64_t da = wgmma_desc(q_addr + off, 16, 1024, 1);
        const uint64_t db = wgmma_desc(k_addr + off, 16, 1024, 1);
        wgmma_ss<kWideBN>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(empty_k);

      // the two halves meet in shared memory, element for element (both
      // warpgroups hold the same fragment positions)
#pragma unroll
      for (int i = 0; i < kWideBN / 2; ++i) mine[i * 128 + tid] = sc[i];
      named_bar_sync(1, 256);
#pragma unroll
      for (int i = 0; i < kWideBN / 2; ++i) sc[i] += theirs[i * 128 + tid];
      named_bar_sync(2, 256);   // both have read before either writes again

      float alpha[2];
      softmax_tile(sc, m_run, l_run, alpha, (t0 + t) * kWideBN, p.skv, p.scale_log2, lane);
      rescale(o, alpha);
      uint32_t pa[kWideBN / 16][4];
      p_fragments(sc, pa);

      mbar_wait(full_v, ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWideBN / 16; ++kk) {
        const uint64_t db = wgmma_desc(v_addr + kk * 16 * 128, kWideBN * 128, 1024, 1);
        wgmma_rs<DS>(o, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty_v);
    }

    if (SPLIT) {
      // block 1's partials, in the thread's fragment order: O into block
      // 0's K and V buffers (DS / 2 floats x 256 threads fit them), the
      // running max and sum into its score buffer
      const int th = threadIdx.x;   // 0..255
      const uint32_t o_buf = smem_addr(ks);
      const uint32_t ml_buf = smem_addr(xs);
      cluster_sync();   // block 0 is done with its buffers
      if (rank == 1) {
#pragma unroll
        for (int i = 0; i < DS / 8; ++i)
          st_cluster_v4(map_to_rank(o_buf + (i * 256 + th) * 16, 0), o[4 * i], o[4 * i + 1],
                        o[4 * i + 2], o[4 * i + 3]);
        st_cluster_v4(map_to_rank(ml_buf + th * 16, 0), m_run[0], m_run[1], l_run[0],
                      l_run[1]);
      }
      cluster_sync();   // block 1's partials have landed
      if (rank == 1) return;
      const float4 ml = reinterpret_cast<const float4*>(xs)[th];
      const float m_other[2] = {ml.x, ml.y};
      const float l_other[2] = {ml.z, ml.w};
      float a_mine[2], a_other[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_run[i], m_other[i]);
        a_mine[i] = fast_exp2(m_run[i] - m_new);
        a_other[i] = fast_exp2(m_other[i] - m_new);
        l_run[i] = l_run[i] * a_mine[i] + l_other[i] * a_other[i];
      }
      const float4* theirs_o = reinterpret_cast<const float4*>(ks);
#pragma unroll
      for (int i = 0; i < DS / 8; ++i) {
        const float4 v = theirs_o[i * 256 + th];
        // registers 4j, 4j+1 hold row g, 4j+2, 4j+3 row g + 8
        o[4 * i + 0] = o[4 * i + 0] * a_mine[0] + v.x * a_other[0];
        o[4 * i + 1] = o[4 * i + 1] * a_mine[0] + v.y * a_other[0];
        o[4 * i + 2] = o[4 * i + 2] * a_mine[1] + v.z * a_other[1];
        o[4 * i + 3] = o[4 * i + 3] * a_mine[1] + v.w * a_other[1];
      }
    }
    store_rows(o, l_run, p, b, h, q0 + warp * 16 + lane / 4, c * DS, lane);
  }
}

// ---------------------------------------------------------------------------
// kernel 3: f32, exact FMAs from register micro-tiles
// ---------------------------------------------------------------------------

constexpr int kF32BM = 32;        // q rows per block
constexpr int kF32BN = 32;        // kv rows per tile
constexpr int kF32Threads = 256;
constexpr int kF32LdS = kF32BN + 1;

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int sq, skv, d;
  int ld;   // q/k row stride in shared memory: d + 4 (16-byte rows, odd in float4s)
  float scale;
};

size_t smem_f32(int d, int ld) {
  return 4 * (size_t(2 * kF32BM) * ld + size_t(kF32BN) * d + 5 * kF32BM * kF32LdS +
              3 * kF32BM);
}

// rows [0, rows) of a (rows_valid x d) strided tile into shared memory with
// cp.async, zero-filling rows past rows_valid
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src,
                                              int64_t row_stride, int rows_valid, int rows,
                                              int d) {
  const int chunks = d / 4;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kF32Threads) {
    const int r = idx / chunks;
    const int col = (idx - r * chunks) * 4;
    const bool ok = r < rows_valid;
    cp_async16(dst + r * ld + col, ok ? src + r * row_stride + col : src, ok ? 16 : 0);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kF32Threads) attn_f32_kernel(const F32Params p) {
  extern __shared__ __align__(16) float smem_f[];
  const int ld = p.ld;
  const int d = p.d;
  float* qs = smem_f;                         // 32 x ld
  float* ks = qs + kF32BM * ld;               // 32 x ld
  float* vs = ks + kF32BN * ld;               // 32 x d
  float* part = vs + kF32BN * d;              // 4 x 32 x 33: partial scores per d group
  float* ps = part + 4 * kF32BM * kF32LdS;    // 32 x 33: probabilities
  float* m_s = ps + kF32BM * kF32LdS;
  float* l_s = m_s + kF32BM;
  float* a_s = l_s + kF32BM;

  const int q0 = blockIdx.x * kF32BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  const int q_valid = min(kF32BM, p.sq - q0);
  const int n_tiles = (p.skv + kF32BN - 1) / kF32BN;

  // Q K^T: thread group gk (64 threads) sums the float4 chunks gk, gk + 4, ...
  // of d for rows i + 8a and kv rows j + 8b (a, b < 4): strided rows keep
  // each quarter-warp's float4 reads on distinct banks
  const int gk = tid / 64;
  const int qi = (tid % 64) / 8;
  const int kj = tid % 8;
  // P V: rows rg + 8a, columns [16 cg, 16 cg + 16)
  const int rg = tid % 8;
  const int cg = tid / 8;
  const bool pv_active = 16 * cg < d;

  auto load_k = [&](int t) {
    if (t < n_tiles) {
      load_rows_f32(ks, ld, kg + t * kF32BN * p.k_ss, p.k_ss, min(kF32BN, p.skv - t * kF32BN),
                    kF32BN, d);
    } else {
      cp_async_commit();   // an empty group keeps the wait counts regular
    }
  };
  auto load_v = [&](int t) {
    if (t < n_tiles) {
      load_rows_f32(vs, d, vg + t * kF32BN * p.v_ss, p.v_ss, min(kF32BN, p.skv - t * kF32BN),
                    kF32BN, d);
    } else {
      cp_async_commit();
    }
  };

  for (int r = tid; r < kF32BM; r += kF32Threads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float o[4][16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int x = 0; x < 16; ++x) o[a][x] = 0.f;

  load_rows_f32(qs, ld, qg, p.q_ss, q_valid, kF32BM, d);
  load_k(0);
  load_v(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kF32BN;
    cp_async_wait_one();   // q and k(t) have landed; v(t) may be in flight
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[a][x] = 0.f;
    for (int ch = gk; ch < d / 4; ch += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = *reinterpret_cast<const float4*>(qs + (qi + 8 * a) * ld + 4 * ch);
        kv[a] = *reinterpret_cast<const float4*>(ks + (kj + 8 * a) * ld + 4 * ch);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          acc[a][x] = fmaf(qv[a].x, kv[x].x, acc[a][x]);
          acc[a][x] = fmaf(qv[a].y, kv[x].y, acc[a][x]);
          acc[a][x] = fmaf(qv[a].z, kv[x].z, acc[a][x]);
          acc[a][x] = fmaf(qv[a].w, kv[x].w, acc[a][x]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        part[(gk * kF32BM + qi + 8 * a) * kF32LdS + kj + 8 * x] = acc[a][x];
    __syncthreads();   // k(t) is no longer read: the next one may load
    load_k(t + 1);

    // scores: the four partial sums, scaled, padded kv columns masked
    for (int idx = tid; idx < kF32BM * kF32BN; idx += kF32Threads) {
      const int r = idx / kF32BN;
      const int cc = idx % kF32BN;
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) sum += part[(g * kF32BM + r) * kF32LdS + cc];
      ps[r * kF32LdS + cc] = kv0 + cc < p.skv ? sum * p.scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per 4 rows, one lane per kv column
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
#pragma unroll
      for (int rr = 0; rr < kF32BM / 8; ++rr) {
        const int r = warp * (kF32BM / 8) + rr;
        const float x = ps[r * kF32LdS + lane];
        float mx = x;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float pv = expf(x - m_new);
        ps[r * kF32LdS + lane] = pv;
        float sum = pv;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
    }
    cp_async_wait_one();   // v(t) has landed; k(t + 1) may be in flight
    __syncthreads();

    // o = o * alpha + P V
    if (pv_active) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float al = a_s[rg + 8 * a];
#pragma unroll
        for (int x = 0; x < 16; ++x) o[a][x] *= al;
      }
      for (int kk = 0; kk < kF32BN; ++kk) {
        float pr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) pr[a] = ps[(rg + 8 * a) * kF32LdS + kk];
        const float* vrow = vs + kk * d + 16 * cg;
#pragma unroll
        for (int x4 = 0; x4 < 4; ++x4) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * x4);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            o[a][4 * x4 + 0] = fmaf(pr[a], vv.x, o[a][4 * x4 + 0]);
            o[a][4 * x4 + 1] = fmaf(pr[a], vv.y, o[a][4 * x4 + 1]);
            o[a][4 * x4 + 2] = fmaf(pr[a], vv.z, o[a][4 * x4 + 2]);
            o[a][4 * x4 + 3] = fmaf(pr[a], vv.w, o[a][4 * x4 + 3]);
          }
        }
      }
    }
    __syncthreads();   // v(t) and P are no longer read
    load_v(t + 1);
  }
  cp_async_wait_all();

  if (pv_active) {
    float* og = p.o + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = rg + 8 * a;
      if (r >= q_valid) continue;
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int col = 16 * cg + x;
        if (col < d) og[r * p.o_ss + col] = o[a][x] * inv;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the bf16 tensor as (d, S, H, B) with d innermost: boxes of box_w x box_rows
bool encode_map(CUtensorMap* map, const View& v, int batch, int heads, int rows, int d,
                int box_w, int box_rows, CUtensorMapSwizzle swizzle) {
  cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(heads), cuuint64_t(batch)};
  cuuint64_t strides[3] = {cuuint64_t(v.ss) * 2, cuuint64_t(v.sh) * 2, cuuint64_t(v.sb) * 2};
  // a size-1 dim's stride is never stepped: give it the packed value
  if (rows == 1) strides[0] = cuuint64_t(d) * 2 * 8;
  if (heads == 1) strides[1] = strides[0] * cuuint64_t(rows);
  if (batch == 1) strides[2] = strides[1] * cuuint64_t(heads);
  cuuint32_t box[4] = {cuuint32_t(box_w), cuuint32_t(box_rows), 1, 1};
  return encode_bf16(map, v.ptr, 4, dims, strides, box, swizzle);
}

struct Call {
  View q, k, v;
  OutParams out;
  int batch, heads;
  float scale;
};

template <int DK>
int launch_tc(const Call& c, cudaStream_t stream) {
  using T = TcTile<DK>;
  CUtensorMap mq, mk, mv;
  const CUtensorMapSwizzle sw = swizzle_of(T::SW);
  if (!encode_map(&mq, c.q, c.batch, c.heads, c.out.sq, c.out.d, T::BOXW, kBM, sw) ||
      !encode_map(&mk, c.k, c.batch, c.heads, c.out.skv, c.out.d, T::BOXW, T::BN, sw) ||
      !encode_map(&mv, c.v, c.batch, c.heads, c.out.skv, c.out.d, T::BOXW, T::BN, sw))
    return int(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(attn_tc_kernel<DK>, T::SMEM);
  if (attr != cudaSuccess) return int(attr);
  dim3 grid(unsigned((c.out.sq + kBM - 1) / kBM), unsigned(c.heads), unsigned(c.batch));
  attn_tc_kernel<DK><<<grid, kThreads, T::SMEM, stream>>>(mq, mk, mv, c.out);
  return int(cudaGetLastError());
}

template <int DS, bool SPLIT>
int launch_wide_grid(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                     const Call& c, int q_tiles, cudaStream_t stream) {
  using T = WideTile<DS>;
  static const cudaError_t attr = allow_smem(attn_wide_kernel<DS, SPLIT>, T::SMEM);
  if (attr != cudaSuccess) return int(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(q_tiles * (SPLIT ? 2 : 1)), unsigned(c.heads), unsigned(c.batch));
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 2;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = SPLIT ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, attn_wide_kernel<DS, SPLIT>, mq, mk, mv, c.out);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

template <int DS>
int launch_wide(const Call& c, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!encode_map(&mq, c.q, c.batch, c.heads, c.out.sq, c.out.d, 64, kWideBM, sw) ||
      !encode_map(&mk, c.k, c.batch, c.heads, c.out.skv, c.out.d, 64, kWideBN, sw) ||
      !encode_map(&mv, c.v, c.batch, c.heads, c.out.skv, c.out.d, 64, kWideBN, sw))
    return int(cudaErrorInvalidValue);
  const int q_tiles = (c.out.sq + kWideBM - 1) / kWideBM;
  // split the kv range over a cluster of two blocks when one block per q
  // tile would leave half the SMs idle (the VAE at S = 4096: 64 blocks);
  // with the grid full (S = 16384: 256 blocks) the split only adds the
  // second Q load and the merge, and reads 9% slower
  const bool split = 2 * q_tiles * c.heads * c.batch <= sm_count() && c.out.skv > kWideBN;
  return split ? launch_wide_grid<DS, true>(mq, mk, mv, c, q_tiles, stream)
               : launch_wide_grid<DS, false>(mq, mk, mv, c, q_tiles, stream);
}

int run_bf16(const Call& c, cudaStream_t stream) {
  if (!tma_ok(c.q, c.batch, c.heads, c.out.sq) || !tma_ok(c.k, c.batch, c.heads, c.out.skv) ||
      !tma_ok(c.v, c.batch, c.heads, c.out.skv))
    return int(cudaErrorInvalidValue);
  switch ((c.out.d + 15) / 16 * 16) {
    case 16: return launch_tc<16>(c, stream);
    case 32: return launch_tc<32>(c, stream);
    case 48: return launch_tc<48>(c, stream);
    case 64: return launch_tc<64>(c, stream);
    case 80: return launch_tc<80>(c, stream);
    case 96: return launch_tc<96>(c, stream);
    case 112: return launch_tc<112>(c, stream);
    case 128: return launch_tc<128>(c, stream);
    default: return c.out.d <= 256 ? launch_wide<128>(c, stream) : launch_wide<256>(c, stream);
  }
}

int run_f32(const Call& c, cudaStream_t stream) {
  const View* views[3] = {&c.q, &c.k, &c.v};
  for (const View* v : views)   // 16-byte cp.async rows
    if (reinterpret_cast<uintptr_t>(v->ptr) % 16 || v->sb % 4 || v->sh % 4 || v->ss % 4)
      return int(cudaErrorInvalidValue);
  F32Params p = {};
  p.q = static_cast<const float*>(c.q.ptr);
  p.k = static_cast<const float*>(c.k.ptr);
  p.v = static_cast<const float*>(c.v.ptr);
  p.o = static_cast<float*>(c.out.o);
  p.q_sb = c.q.sb; p.q_sh = c.q.sh; p.q_ss = c.q.ss;
  p.k_sb = c.k.sb; p.k_sh = c.k.sh; p.k_ss = c.k.ss;
  p.v_sb = c.v.sb; p.v_sh = c.v.sh; p.v_ss = c.v.ss;
  p.o_sb = c.out.o_sb; p.o_sh = c.out.o_sh; p.o_ss = c.out.o_ss;
  p.sq = c.out.sq; p.skv = c.out.skv; p.d = c.out.d;
  p.ld = c.out.d + 4;
  p.scale = c.scale;
  const size_t smem = smem_f32(p.d, p.ld);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(attn_f32_kernel, kMaxSmem);
  if (attr != cudaSuccess) return int(attr);
  dim3 grid(unsigned((p.sq + kF32BM - 1) / kF32BM), unsigned(c.heads), unsigned(c.batch));
  attn_f32_kernel<<<grid, kF32Threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  dtype: 0 = bf16, 1 = f32.
// Strides are in elements; the last dim is contiguous; d is a multiple of 8
// and at most 512.  bf16 operands need a 16-byte aligned base and strides
// that are multiples of 8 elements (TMA); f32 operands multiples of 4
// (16-byte cp.async).  A bf16 output's strides must be even (bf16 pairs).
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
  Call c = {};
  c.q = {q, q_sb, q_sh, q_ss};
  c.k = {k, k_sb, k_sh, k_ss};
  c.v = {v, v_sb, v_sh, v_ss};
  c.out.o = o;
  c.out.o_sb = o_sb; c.out.o_sh = o_sh; c.out.o_ss = o_ss;
  c.out.sq = sq; c.out.skv = skv; c.out.d = d;
  c.out.scale_log2 = scale * kLog2e;
  c.scale = scale;
  c.batch = batch;
  c.heads = heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run_f32(c, s);
  if (reinterpret_cast<uintptr_t>(o) % 4 != 0 || o_sb % 2 || o_sh % 2 || o_ss % 2)
    return int(cudaErrorInvalidValue);
  return run_bf16(c, s);
}

}  // extern "C"

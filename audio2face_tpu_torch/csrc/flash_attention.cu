// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel audio2face_tpu/ops/attention.py
// flash_attention_pallas (_flash_kernel): online-softmax multi-head
// attention with optional causal mask, the period-bucketed ALiBi bias
// -slope_h * floor((i - j) / period), per-batch KV lengths, the per-row
// logsumexp, and in-kernel attention dropout: each position's keep bit is a
// hash of (seed, batch*head, global row, global col), so the backward
// kernels (flash_attention_bwd.cu) regenerate the same mask from indices.
// Dropout follows torch semantics: the keep multiplier scales only the
// probabilities that enter the value product; the running max, the running
// sum and the logsumexp never see it.
//
// Bound: at the encoder's shape (B*H = 96, T = 3600, D = 64, bf16) the two
// products are 4*T*T*D FLOP per (b, h) against 4*T*D*2 bytes of q/k/v/o, so
// the kernel is bound by tensor-core operations, not memory; at D = 64 the
// exponentials (one per score, 16 a clock on an SM) take as long as the
// products. One block per (b*h, 256-row q tile) walks the k tiles in a loop
// (the TPU's sequential grid axis) and stops at the last tile the KV length
// and causality can reach (the TPU's `last_needed`).
//
// bf16 (flash_fwd_wgmma_kernel): four warpgroups of 64 query rows each (two
// at head dims other than 64), one block per SM. Q is
// copied once into shared memory; K and V tiles of 64 keys stream through a
// three-stage ring filled by cp.async, the next tile's copy in flight while
// the block computes on this one, one block barrier a tile. S = Q K^T goes
// by wgmma from shared memory into registers; masking, bias, the online
// softmax (in log2 units, the scale folded into the exponent's FMA; row max
// and sum reduced over the four threads that share a row) and the dropout
// multiply run on those registers; P is rounded to bf16 in place and is the
// register A operand of O += P V, whose accumulator stays in registers until
// the one write at the end. Each warpgroup issues the next tile's S with
// this tile's P V, so that its softmax runs while the tensor cores work. No
// score or accumulator tile touches shared memory.
//
// f32 (the wav2vec2 frame windows, f32 models and the gradient checks):
// CUDA-core FMAs, so that f32 keeps f32 accuracy, on two paths chosen by
// t_k: flash_fwd_f32_short_kernel for t_k <= 64 (persistent blocks, whole
// slices' K/V by cp.async, a group of eight lanes two query rows, the rows'
// scores in registers and a one-pass softmax) and flash_fwd_f32_tiled_kernel above
// (register-tiled FFMA over a cp.async ring, ffma_tile.cuh). At the frame
// window (B*H = 12,288, T = 25, D = 64) the call moves 315 MB for 2 GFLOP,
// so it is bound by bytes; at long t_k by FMAs (67 TFLOP/s). See the f32
// section below.
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), o (BH, Tq, D) in the input
// type, lse (BH, Tq) f32; all contiguous, bf16 bases 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffma_tile.cuh"
#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float MASK_VALUE = -1e30f;
constexpr int BK = 64;  // keys per tile

// ---- bf16: wgmma, register accumulators, cp.async ring --------------------

constexpr float MASK2 = MASK_VALUE * LOG2E;  // the mask value in log2 units

// One block per SM: at D = 64, four warpgroups share each K/V tile (half
// the copies of two; 128 registers a thread fill the register file); other
// head dims need more registers, so two.
template <int D>
struct WgmmaFwd {
  static constexpr int NWG = D == 64 ? 4 : 2;  // warpgroups, 64 query rows each
  static constexpr int BQ = 64 * NWG;     // query rows per block
  static constexpr int NT = 128 * NWG;    // threads
  static constexpr int STAGES = 4;        // K/V ring: tiles j + 1, j + 2 in flight, j - 1's V read
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr int BYTES = Q_BYTES + STAGES * STAGE_BYTES;
};

// One warpgroup's online softmax of a 64 x 64 score tile in registers (the
// accumulator layout of wgmma.cuh: rows r0 and r0 + 8, columns k0 + 8j +
// cq + e), in log2 units. Leaves the dropout-scaled probabilities in s (in
// place; pack_frags rounds them into the A fragments of P V), the rescale
// factor of each row in alpha and the rows' running max in m_run; adds the
// row sums (before dropout) to l_run after rescaling it.
struct SoftmaxArgs {
  int r0, cq, kvlen, causal, period, wg_row0, bh;
  float c, slope2;  // sm_scale and the ALiBi slope times log2 e
  bool fused;       // no bias and a positive scale: the scale folds into the exponent
  uint32_t seed, drop_thr;
  float keep_scale;
};

__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], int k0, const SoftmaxArgs& a) {
  // per-element work (bias, mask) only where it is needed: the bias when
  // there is one, the mask on tiles that straddle the KV length or the diagonal
  const bool edge = k0 + BK > a.kvlen || (a.causal && k0 + BK - 1 > a.wg_row0);
  float ce = a.c;
  if (!a.fused || edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int row = a.r0 + 8 * ((i >> 1) & 1), col = k0 + 8 * (i >> 2) + a.cq + (i & 1);
      float x = s[i] * a.c;
      if (a.period > 0) x -= a.slope2 * (float)floor_div(row - col, a.period);
      if (edge) x = (col < a.kvlen && (!a.causal || col <= row)) ? x : MASK2;
      s[i] = x;
    }
    ce = 1.f;
  }
  float mx[2] = {MASK2, MASK2};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h] * ce);  // a positive scale keeps the max
    alpha[h] = fast_exp2(m_run[h] - m_new);
    m_run[h] = m_new;
  }
  // probabilities; the row sum before dropout, the value product after
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int h = (i >> 1) & 1;
    float p0 = fast_exp2(fmaf(s[i], ce, -m_run[h]));
    float p1 = fast_exp2(fmaf(s[i + 1], ce, -m_run[h]));
    sum[h] += p0 + p1;
    if (a.drop_thr > 0) {
      const int row = a.r0 + 8 * h, col = k0 + 8 * (i >> 2) + a.cq;
      p0 *= dropout_keep(a.seed, a.bh, row, col, a.drop_thr, a.keep_scale);
      p1 *= dropout_keep(a.seed, a.bh, row, col + 1, a.drop_thr, a.keep_scale);
    }
    s[i] = p0;
    s[i + 1] = p1;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l_run[h] = alpha[h] * l_run[h] + sum[h];
  }
}

template <int D>
__global__ void __launch_bounds__(WgmmaFwd<D>::NT, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, const int* __restrict__ kv_len,
                       const float* __restrict__ slopes, int heads, int t_q, int t_k,
                       int causal, int period, float sm_scale, const int* __restrict__ seed,
                       uint32_t drop_thr, float keep_scale, HashIndex hix) {
  using C = WgmmaFwd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_ring = s_q + C::Q_BYTES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, w = (tid % 128) / 32, l = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::BQ;
  const __nv_bfloat16* kb = k + (size_t)bh * t_k * D;
  const __nv_bfloat16* vb = v + (size_t)bh * t_k * D;

  SoftmaxArgs sa;
  sa.kvlen = kv_len[bh / heads];
  sa.causal = causal;
  sa.period = period;
  sa.bh = hix.of(bh, heads);
  sa.c = sm_scale * LOG2E;
  sa.slope2 = slopes[bh % heads] * LOG2E;
  sa.fused = period == 0 && sm_scale > 0.f;
  sa.seed = drop_thr > 0 ? (uint32_t)seed[0] : 0u;
  sa.drop_thr = drop_thr;
  sa.keep_scale = keep_scale;
  // this thread's rows r0 and r0 + 8 and the first of its column pairs
  sa.wg_row0 = q0 + 64 * wg;
  sa.r0 = sa.wg_row0 + 16 * w + l / 4;
  sa.cq = 2 * (l % 4);

  int last = (max(sa.kvlen - 1, 0)) / BK;
  last = min(last, (t_k + BK - 1) / BK - 1);
  if (causal) last = min(last, (q0 + C::BQ - 1) / BK);

  auto load_kv = [&](int kt) {  // tile kt into its stage, if there is one
    if (kt <= last) {
      const uint32_t stage = s_ring + (kt % C::STAGES) * C::STAGE_BYTES;
      load_tile_async<D, BK, C::NT>(stage, kb, kt * BK, t_k, tid);
      load_tile_async<D, BK, C::NT>(stage + C::KV_BYTES, vb, kt * BK, t_k, tid);
    }
    cp_async_commit();  // one group a tile, empty past the last
  };
  // group 0: Q and the first K/V tile; group 1: the second
  load_tile_async<D, C::BQ, C::NT>(s_q, q + (size_t)bh * t_q * D, q0, t_q, tid);
  load_kv(0);
  load_kv(1);

  // Both warpgroups walk every tile up to `last` with no branch around a
  // wgmma (ptxas serializes wgmma it cannot prove warpgroup-uniform): a
  // warpgroup past t_q computes rows nobody writes, and tiles above a
  // warpgroup's rows under causality are masked to exact zeros (its rows'
  // running max is finite by then).
  //
  // Tile kt: wait for its copy (issued two iterations ago; the next tile's
  // may still fly); one barrier makes it everyone's and frees the stage of
  // tile kt - 2 (read by all in iteration kt - 1), where tile kt + 2 goes.
  auto next_tile = [&](int kt) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load_kv(kt + 2);
  };

  float m_run[2] = {MASK2, MASK2}, l_run[2] = {0.f, 0.f}, alpha[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];  // P of the previous tile, waiting for its value product

  // operands are pinned (fence_regs, fence_frags) before each wgmma.fence
  next_tile(0);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor<D>(s_q, 64 * wg, kk), desc_kmajor<D>(s_ring, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m_run, l_run, alpha, 0, sa);
  pack_frags<BK>(s, pa);
  uint32_t s_v_prev = s_ring + C::KV_BYTES;

  // the pipeline: at tile kt the warpgroup issues S_kt = Q K_kt^T and
  // O += P_{kt-1} V_{kt-1} together, runs the softmax of S_kt while the
  // value product runs, then retires it, rescales O and packs P_kt
  for (int kt = 1; kt <= last; ++kt) {
    next_tile(kt);
    const uint32_t s_k = s_ring + (kt % C::STAGES) * C::STAGE_BYTES;
    fence_regs(s);
    fence_regs(acc);
    fence_frags(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<D>(s_q, 64 * wg, kk), desc_kmajor<D>(s_k, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mnmajor<D>(s_v_prev, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the scores; the value product may still run
    fence_regs(s);
    softmax_tile(s, m_run, l_run, alpha, kt * BK, sa);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_frags<BK>(s, pa);
    s_v_prev = s_k + C::KV_BYTES;
  }
  fence_regs(acc);
  fence_frags(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mnmajor<D>(s_v_prev, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = sa.r0 + 8 * h;
    if (row >= t_q) continue;
    const float lsum = fmaxf(l_run[h], 1e-30f);
    const float inv = 1.f / lsum;
    __nv_bfloat16* orow = o + ((size_t)bh * t_q + row) * D + sa.cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (l % 4 == 0) lse[(size_t)bh * t_q + row] = m_run[h] * LN2 + logf(lsum);
  }
}

// ---- f32: register-tiled CUDA-core FMAs ------------------------------------
//
// Two paths behind launch_f32, chosen by t_k:
//
// t_k <= 64 (flash_fwd_f32_short_kernel; the wav2vec2 frame windows, T =
// 25): persistent blocks (as many as fit the SMs) walk items (short_plan):
// the query rows of one (batch*head) slice, 32 at most. An item's K and V
// (contiguous spans of the kernel layout) arrive whole by 16-byte cp.async copies into
// a two-stage ring: the next item's copies fly while the block computes
// this one. A group of eight lanes (a quarter-warp, so each 16-byte load
// phase reads 128 distinct bytes) owns R = 2 query rows, read from device
// memory with 16-byte loads into registers, D / 8 values of each a lane;
// each K row the group loads serves both rows. A lane's partial dot
// products for eight keys are joined by a butterfly reduce-scatter (7
// shuffles), after which lane g holds the scores of keys 8 c + g in
// registers: the softmax is one pass over the whole row (row max and sum
// by three shuffles), with no online rescaling, and the lse comes from the
// same registers. In the value product each probability goes from its
// lane to the group by a shuffle; O is accumulated in registers and
// written with 16-byte stores. No score or probability touches shared
// memory. Shared memory is two stages of 2 t_k x D f32 (25.6 KB at
// T = 25, D = 64: seven blocks an SM). What bounds it: every 16-byte shared
// load takes the SM's shared-memory pipe four cycles whatever its
// broadcast, so loads per FMA set the floor, then the blocks resident to
// keep the copies in flight.
//
// t_k > 64 (flash_fwd_f32_tiled_kernel): a block per (batch*head, 64 query
// rows), 128 threads; Q resident, K/V tiles of 32 keys through a two-stage
// cp.async ring with one block barrier a tile; S and O register-tiled
// (ffma_tile.cuh: 4 x 4 scores and 4 x D/8 outputs a thread); row max by
// shuffles among the eight threads of a row, row sums kept per thread and
// joined once at the end, O rescaled in registers; P crosses shared memory
// once a tile, warp-locally, as the value product's operand.
//
// Both keep the floor-division ALiBi bucket, the -1e30 mask, the 1e-30
// clamp and the hash dropout of flash_common.cuh; exponents in log2 units
// with the scale folded into one multiply.

constexpr int SK_NT = 128;               // threads a short-path block
constexpr int SK_G = 8;                  // lanes a row group: one quarter-warp
constexpr int SK_GROUPS = SK_NT / SK_G;  // row groups a block
constexpr int SK_MAX_TK = 64;            // longest key sequence of the short path
constexpr int SK_R = 2;                  // query rows a group computes together

template <int D>
struct ShortFwd {
  static constexpr int R = SK_R;
  static constexpr int NV = D / SK_G;          // values of a row a lane holds
  static constexpr int VEC = NV >= 4 ? 4 : 2;  // ... in 16- or 8-byte chunks
  static constexpr int NCH = NV / VEC;
};

// How the short path cuts a call into items: an item is up to SK_R x
// SK_GROUPS query rows of one (batch*head) slice, so that every row group
// of the block computes at most one group of rows an item; the item's K
// and V are the slice's, one contiguous span each.
struct ShortPlan {
  int q_rows, n_qc, n_items, groups_per_slice, smem_bytes;
};

inline ShortPlan short_plan(int head_dim, int n_bh, int t_q, int t_k) {
  ShortPlan p;
  p.q_rows = t_q < SK_R * SK_GROUPS ? t_q : SK_R * SK_GROUPS;
  p.n_qc = (t_q + p.q_rows - 1) / p.q_rows;
  p.groups_per_slice = (p.q_rows + SK_R - 1) / SK_R;
  p.n_items = n_bh * p.n_qc;
  p.smem_bytes = 2 * 2 * t_k * head_dim * 4;  // two stages of K and V
  return p;
}

// a lane's NV values of a row: VEC-float chunks g + 8 m, m < NCH, so that
// the eight lanes of a group read 8 x VEC contiguous floats at a time
template <int D>
__device__ __forceinline__ void load_row_part(float (&dst)[ShortFwd<D>::NV], const float* row, int g) {
  using S = ShortFwd<D>;
#pragma unroll
  for (int m = 0; m < S::NCH; ++m) {
    const int at = S::VEC * (g + SK_G * m);
    if constexpr (S::VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(row + at);
      dst[4 * m] = t.x, dst[4 * m + 1] = t.y, dst[4 * m + 2] = t.z, dst[4 * m + 3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(row + at);
      dst[2 * m] = t.x, dst[2 * m + 1] = t.y;
    }
  }
}

// v[u] is this lane's partial sum for key u of eight; returns the group's
// full sum for key g (this lane's own key): a butterfly reduce-scatter,
// 4 + 2 + 1 shuffles instead of 8 x 3
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int g, unsigned gmask) {
  float w[4], x[2];
  const bool b4 = g & 4, b2 = g & 2, b1 = g & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (b4 ? v[i + 4] : v[i]) + __shfl_xor_sync(gmask, b4 ? v[i] : v[i + 4], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    x[i] = (b2 ? w[i + 2] : w[i]) + __shfl_xor_sync(gmask, b2 ? w[i] : w[i + 2], 2);
  return (b1 ? x[1] : x[0]) + __shfl_xor_sync(gmask, b1 ? x[0] : x[1], 1);
}

template <int D, int TKB>
__global__ void __launch_bounds__(SK_NT)
flash_fwd_f32_short_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, const int* __restrict__ kv_len,
                           const float* __restrict__ slopes, int heads, int t_q, int t_k,
                           int causal, int period, float sm_scale, const int* __restrict__ seed,
                           uint32_t drop_thr, float keep_scale, HashIndex hix,
                           ShortPlan plan) {
  using S = ShortFwd<D>;
  constexpr int R = S::R, NV = S::NV, NC = TKB / SK_G;  // NC: key chunks of eight
  extern __shared__ __align__(128) unsigned char smem[];
  const float* ring = reinterpret_cast<const float*>(smem);
  const uint32_t s_ring = smem_u32(smem);
  const int tid = threadIdx.x;
  const int g = tid % SK_G, grp = tid / SK_G;
  const int lane0 = (tid % 32) & ~(SK_G - 1);  // the group's first lane
  const unsigned gmask = 0xffu << lane0;
  const int q_rows = plan.q_rows, n_qc = plan.n_qc;
  const int stage = 2 * t_k * D;  // floats: K, then V
  const float c = sm_scale * LOG2E;
  const uint32_t seed0 = drop_thr > 0 ? (uint32_t)seed[0] : 0u;
  const float NEG_INF = __int_as_float(0xff800000);

  // item it: query rows r0 .. r0 + nr - 1 of slice it / n_qc
  auto load_item = [&](int it, int st) {
    if (it < plan.n_items) {
      const uint32_t dk = s_ring + st * stage * 4, dv = dk + t_k * D * 4;
      const float* ks = k + (size_t)(it / n_qc) * t_k * D;
      const float* vs = v + (size_t)(it / n_qc) * t_k * D;
      for (int i = tid; i < t_k * D / 4; i += SK_NT) {
        cp_async16(dk + 16 * i, ks + 4 * i, true);
        cp_async16(dv + 16 * i, vs + 4 * i, true);
      }
    }
    cp_async_commit();
  };

  int st = 0;
  load_item(blockIdx.x, 0);
  for (int it = blockIdx.x; it < plan.n_items; it += gridDim.x, st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this item's K/V are everyone's; the other stage is read by all
    load_item(it + gridDim.x, st ^ 1);
    const int bh = it / n_qc, r0 = it % n_qc * q_rows, nr = min(q_rows, t_q - r0);
    // this group's rows rl0 .. rl0 + R - 1 of the item's nr
    const int rl0 = grp * R;
    if (grp >= plan.groups_per_slice || rl0 >= nr) continue;  // an idle group (whole groups only)
    const int kvlen = kv_len[bh / heads];
    const float slope2 = slopes[bh % heads] * LOG2E;
    const uint32_t hbh = hix.of(bh, heads);
    const float* Kb = ring + st * stage;
    const float* Vb = Kb + t_k * D;
    int row[R];
    float qv[R][NV];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int rl = min(rl0 + r, nr - 1);  // rows past nr repeat the last; not written
      row[r] = r0 + rl;
      load_row_part<D>(qv[r], q + ((size_t)bh * t_q + row[r]) * D, g);
    }

    // scores of this lane's own keys 8 ch + g, in log2 units, masked
    float s[R][NC], mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = MASK2;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      const int j = SK_G * ch + g;
      if (SK_G * ch < t_k) {
        float part[R][SK_G];
#pragma unroll
        for (int u = 0; u < SK_G; ++u) {
#pragma unroll
          for (int r = 0; r < R; ++r) part[r][u] = 0.f;  // keys past t_k: masked below
          if (SK_G * ch + u < t_k) {
            float kr[NV];
            load_row_part<D>(kr, Kb + (SK_G * ch + u) * D, g);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float p0 = 0.f, p1 = 0.f;  // two partial sums: short chains
#pragma unroll
              for (int e = 0; e < NV; e += 2) {
                p0 = fmaf(qv[r][e], kr[e], p0);
                p1 = fmaf(qv[r][e + 1], kr[e + 1], p1);
              }
              part[r][u] = p0 + p1;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = reduce_scatter8(part[r], g, gmask) * c;
          if (period > 0) x -= slope2 * (float)floor_div(row[r] - j, period);
          x = j >= t_k ? NEG_INF : (j < kvlen && (!causal || j <= row[r])) ? x : MASK2;
          s[r][ch] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][ch] = NEG_INF;
      }
    }
    // one pass: the row max over the group, probabilities of the own keys
    // (0 past t_k), their sum before dropout, then dropout
    float l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(gmask, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(gmask, mx[r], 2));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(gmask, mx[r], 4));
      l[r] = 0.f;
#pragma unroll
      for (int ch = 0; ch < NC; ++ch) {
        float p = fast_exp2(s[r][ch] - mx[r]);
        l[r] += p;
        if (drop_thr > 0) p *= dropout_keep(seed0, hbh, row[r], SK_G * ch + g, drop_thr, keep_scale);
        s[r][ch] = p;
      }
    }
    // O += p_j v_j: each key's probability from the lane that owns it
    float acc[R][NV];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[r][e] = 0.f;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      if (SK_G * ch < t_k) {
#pragma unroll
        for (int u = 0; u < SK_G; ++u) {
          if (SK_G * ch + u < t_k) {
            float vr[NV];
            load_row_part<D>(vr, Vb + (SK_G * ch + u) * D, g);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float p = __shfl_sync(gmask, s[r][ch], lane0 + u);
#pragma unroll
              for (int e = 0; e < NV; ++e) acc[r][e] = fmaf(p, vr[e], acc[r][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(gmask, lr, 1);
      lr += __shfl_xor_sync(gmask, lr, 2);
      lr += __shfl_xor_sync(gmask, lr, 4);
      if (rl0 + r >= nr) continue;
      lr = fmaxf(lr, 1e-30f);
      const float inv = 1.f / lr;
      float* orow = o + ((size_t)bh * t_q + row[r]) * D;
#pragma unroll
      for (int m = 0; m < S::NCH; ++m) {
        const int at = S::VEC * (g + SK_G * m);
        if constexpr (S::VEC == 4) {
          *reinterpret_cast<float4*>(orow + at) =
              make_float4(acc[r][4 * m] * inv, acc[r][4 * m + 1] * inv, acc[r][4 * m + 2] * inv,
                          acc[r][4 * m + 3] * inv);
        } else {
          *reinterpret_cast<float2*>(orow + at) = make_float2(acc[r][2 * m] * inv, acc[r][2 * m + 1] * inv);
        }
      }
      if (g == 0) lse[(size_t)bh * t_q + row[r]] = mx[r] * LN2 + logf(lr);
    }
  }
}

template <int D>
struct TiledFwd {
  using T = FTile<D>;
  static constexpr int STAGE = 2 * T::WALKED_BYTES;  // K then V
  static constexpr int BYTES = T::OWNED_BYTES + 2 * STAGE + T::X_BYTES;
};

template <int D>
__global__ void __launch_bounds__(FT_NT)
flash_fwd_f32_tiled_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, const int* __restrict__ kv_len,
                           const float* __restrict__ slopes, int heads, int t_q, int t_k,
                           int causal, int period, float sm_scale, const int* __restrict__ seed,
                           uint32_t drop_thr, float keep_scale, HashIndex hix) {
  using T = FTile<D>;
  using C = TiledFwd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Qs = reinterpret_cast<const float*>(smem);
  float* Xs = reinterpret_cast<float*>(smem + T::OWNED_BYTES + 2 * C::STAGE);
  const uint32_t s_q = smem_u32(smem), s_ring = s_q + T::OWNED_BYTES;
  const int tid = threadIdx.x;
  const FMap mp;
  const int bh = blockIdx.y, q0 = blockIdx.x * FT_ROWS;
  const int kvlen = kv_len[bh / heads];
  const float c = sm_scale * LOG2E, slope2 = slopes[bh % heads] * LOG2E;
  const uint32_t seed0 = drop_thr > 0 ? (uint32_t)seed[0] : 0u;
  const uint32_t hbh = hix.of(bh, heads);
  const float* kb = k + (size_t)bh * t_k * D;
  const float* vb = v + (size_t)bh * t_k * D;

  // the last key tile the KV length and causality can reach
  int last = max(kvlen - 1, 0) / FT_COLS;
  last = min(last, (t_k + FT_COLS - 1) / FT_COLS - 1);
  if (causal) last = min(last, (q0 + FT_ROWS - 1) / FT_COLS);

  auto load_kv = [&](int kt) {  // tile kt into its stage, if there is one
    if (kt <= last) {
      const uint32_t stage = s_ring + (kt % 2) * C::STAGE;
      ft_load_async<D, FT_COLS>(stage, kb, kt * FT_COLS, t_k, tid);
      ft_load_async<D, FT_COLS>(stage + T::WALKED_BYTES, vb, kt * FT_COLS, t_k, tid);
    }
    cp_async_commit();
  };
  ft_load_async<D, FT_ROWS>(s_q, q + (size_t)bh * t_q * D, q0, t_q, tid);
  load_kv(0);

  float m_run[4], l_run[4], acc[4][T::NV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = MASK2;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < T::NV; ++e) acc[i][e] = 0.f;
  }

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is everyone's; the other stage (tile kt - 1) is read by all
    load_kv(kt + 1);
    const float* Ks = reinterpret_cast<const float*>(smem + T::OWNED_BYTES + (kt % 2) * C::STAGE);
    const float* Vs = Ks + T::WALKED_BYTES / 4;
    const int k0 = kt * FT_COLS;
    float s[4][4];
    ft_scores<D>(Qs, Ks, mp, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + mp.row(i);
      float mx = MASK2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + mp.col(j);
        float x = s[i][j] * c;
        if (period > 0) x -= slope2 * (float)floor_div(row - col, period);
        x = (col < kvlen && (!causal || col <= row)) ? x : MASK2;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = fast_exp2(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = fast_exp2(s[i][j] - m_new);
        sum += p;
        if (drop_thr > 0) p *= dropout_keep(seed0, hbh, row, k0 + mp.col(j), drop_thr, keep_scale);
        s[i][j] = p;
      }
      l_run[i] = alpha * l_run[i] + sum;  // this thread's share of the row sum
#pragma unroll
      for (int e = 0; e < T::NV; ++e) acc[i][e] *= alpha;
    }
    __syncwarp();  // the warp's reads of the last tile's P are done
    ft_store_x(Xs, mp, s);
    __syncwarp();
    ft_accumulate<D>(Xs, Vs, mp, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = q0 + mp.row(i);
    if (row >= t_q) continue;
    l = fmaxf(l, 1e-30f);
    ft_store_row<D>(o + ((size_t)bh * t_q + row) * D, mp, acc[i], 1.f / l);
    if (mp.cg == 0) lse[(size_t)bh * t_q + row] = m_run[i] * LN2 + logf(l);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  const int* kv_len;
  const float* slopes;
  int bh, heads, t_q, t_k, causal, period;
  float sm_scale;
  const int* seed;
  uint32_t drop_thr;
  float keep_scale;
  HashIndex hix;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using C = WgmmaFwd<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.t_q + C::BQ - 1) / C::BQ, a.bh);
  flash_fwd_wgmma_kernel<D><<<grid, C::NT, C::BYTES, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.lse, a.kv_len,
      a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed, a.drop_thr,
      a.keep_scale, a.hix);
  return cudaGetLastError();
}

// The f32 launch plan of one call: the path (1 short, 0 tiled), shared
// memory a block, resident blocks per SM, blocks launched, and query rows a
// block computes at once (an item of the short path, a tile of the tiled).
struct F32Plan {
  int path, smem_bytes, blocks_per_sm, grid, query_rows;
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <int D, int TKB>
cudaError_t launch_f32_short(const Args& a, F32Plan* plan) {
  auto kern = flash_fwd_f32_short_kernel<D, TKB>;
  const ShortPlan sp = short_plan(D, a.bh, a.t_q, a.t_k);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, sp.smem_bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, SK_NT, sp.smem_bytes);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (per_sm < 1 || sms < 1) return cudaErrorInvalidConfiguration;
  const int grid = sp.n_items < per_sm * sms ? sp.n_items : per_sm * sms;  // persistent blocks
  if (plan != nullptr) {
    *plan = {1, sp.smem_bytes, per_sm, grid, sp.q_rows};
    return cudaSuccess;
  }
  kern<<<grid, SK_NT, sp.smem_bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.kv_len, a.slopes,
      a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed, a.drop_thr, a.keep_scale,
      a.hix, sp);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32_tiled(const Args& a, F32Plan* plan) {
  constexpr int bytes = TiledFwd<D>::BYTES;
  auto kern = flash_fwd_f32_tiled_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.t_q + FT_ROWS - 1) / FT_ROWS, a.bh);
  if (plan != nullptr) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, FT_NT, bytes);
    *plan = {0, bytes, per_sm, (int)(grid.x * grid.y), FT_ROWS};
    return err;
  }
  kern<<<grid, FT_NT, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.kv_len, a.slopes,
      a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed, a.drop_thr, a.keep_scale, a.hix);
  return cudaGetLastError();
}

// f32: the short path for t_k <= 64, the tiled one above; with `plan`, the
// plan is filled and nothing is launched
template <int D>
cudaError_t launch_f32(const Args& a, F32Plan* plan = nullptr) {
  if (a.t_k <= 32) return launch_f32_short<D, 32>(a, plan);
  if (a.t_k <= SK_MAX_TK) return launch_f32_short<D, SK_MAX_TK>(a, plan);
  return launch_f32_tiled<D>(a, plan);
}

template <int D>
cudaError_t launch(bool bf16, const Args& a) {
  return bf16 ? launch_bf16<D>(a) : launch_f32<D>(a);
}

template <int D>
cudaError_t occupancy(int* info) {
  using C = WgmmaFwd<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return err;
  info[0] = C::BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], flash_fwd_wgmma_kernel<D>, C::NT,
                                                       C::BYTES);
}

}  // namespace

// The bf16 kernel's shared memory per block (info[0], bytes) and resident
// blocks per SM (info[1]) at head_dim.
extern "C" int a2f_flash_attention_fwd_occupancy(int head_dim, int* info) {
  switch (head_dim) {
    case 16: return occupancy<16>(info);
    case 32: return occupancy<32>(info);
    case 64: return occupancy<64>(info);
    case 128: return occupancy<128>(info);
    default: return cudaErrorInvalidValue;
  }
}

// The f32 launch plan of a call at (head_dim, batch*heads, t_q, t_k),
// launching nothing: info[0] the path (1: short keys, t_k <= 64; 0: tiled),
// info[1] shared memory a block (bytes), info[2] resident blocks per SM,
// info[3] blocks launched, info[4] query rows a block computes at once.
extern "C" int a2f_flash_attention_fwd_f32_plan(int head_dim, int batch_heads, int t_q, int t_k,
                                                int* info) {
  Args a{};
  a.bh = batch_heads;
  a.t_q = t_q;
  a.t_k = t_k;
  F32Plan p{};
  cudaError_t err;
  switch (head_dim) {
    case 16: err = launch_f32<16>(a, &p); break;
    case 32: err = launch_f32<32>(a, &p); break;
    case 64: err = launch_f32<64>(a, &p); break;
    case 128: err = launch_f32<128>(a, &p); break;
    default: return cudaErrorInvalidValue;
  }
  info[0] = p.path;
  info[1] = p.smem_bytes;
  info[2] = p.blocks_per_sm;
  info[3] = p.grid;
  info[4] = p.query_rows;
  return err;
}

// head_dim must be 16, 32, 64 or 128; period 0 = no bias.
// kv_len: (B,) int32 on the device, each in [0, t_k]; slopes: (H,) f32.
// Dropout: a position is kept iff its hash >= drop_thr, where drop_thr =
// min(int(rate * 2^31), 2^31 - 1) is computed by the caller in double;
// kept probabilities are scaled by keep_scale = 1 / (1 - rate). drop_thr 0
// turns dropout off (seed is then not read). seed: (1,) int32 on the device.
// The hash takes slice (b, h) of this launch as batch hash_b0 + b and head
// hash_h0 + h of hash_heads (HashIndex); 0, 0, heads for a whole call.
extern "C" int a2f_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const int* kv_len, const float* slopes,
                                       int batch, int heads, int t_q, int t_k,
                                       int head_dim, int is_bf16, int causal,
                                       int period, float sm_scale,
                                       const int* seed, unsigned int drop_thr,
                                       float keep_scale, int hash_b0, int hash_h0,
                                       int hash_heads, void* stream) {
  Args a{q,      k,       v,     o,      lse,      kv_len,   slopes,   batch * heads,
         heads,  t_q,     t_k,   causal, period,   sm_scale, seed,     drop_thr,
         keep_scale, {hash_b0, hash_h0, hash_heads}, static_cast<cudaStream_t>(stream)};
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 16: return launch<16>(bf16, a);
    case 32: return launch<32>(bf16, a);
    case 64: return launch<64>(bf16, a);
    case 128: return launch<128>(bf16, a);
    default: return cudaErrorInvalidValue;
  }
}

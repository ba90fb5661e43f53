// Flash-attention backward for Hopper (sm_90a): delta, dq, dk, dv.
//
// Replaces the TPU kernels of audio2face_tpu/ops/attention.py
// flash_attention_bwd_pallas (_flash_bwd_dkdv_kernel, _flash_bwd_dq_kernel)
// and the delta = rowsum(dO * O) it computes beside them: from q, k, v, O,
// dO and the forward's per-row logsumexp they recompute every probability
// tile on chip,
//   p  = exp(s - lse)            (s: scaled scores + ALiBi bias, masked)
//   dv = (m . p)^T dO            (m: the forward's dropout keep multiplier)
//   ds = p . (m . dO v^T - delta) . scale
//   dq = ds k,   dk = ds^T q
// with the forward's causal mask, period-bucketed ALiBi bias, per-batch KV
// lengths and hash dropout (the keep multiplier is regenerated from
// (seed, batch*head, row, col); no mask tensor exists).
//
// Bound: five 64x64xD products per tile pair against reads of q, k, v, O,
// dO and writes of dq, dk, dv. Design: two kernels, one per output
// ownership, no atomics, so results are deterministic. The dq kernel runs
// first: one block per (batch*head, 64-row q tile) computes delta for its
// own rows (and writes it), then walks the k tiles up to the last one the
// KV length and causality can reach. The dk/dv kernel runs second: one block
// per (batch*head, 64-row k tile) reads that delta and walks the q tiles,
// skipping keys at or past the KV length and, under causality, the q tiles
// above the diagonal. P and dS are rounded to the input type before their
// products, as the TPU kernels do.
//
// bf16 (flash_bwd_dq_wgmma_kernel, flash_bwd_dkdv_wgmma_kernel): one
// warpgroup per block. The tile the block owns (Q and dO, or K and V) stays
// in shared memory; the tiles it walks stream through a two-stage ring
// filled by cp.async, the next one in flight during this one's math, one
// block barrier a tile; exponents in log2 units, the scale in an FMA. Both
// score-side products go by wgmma from shared memory into registers. The
// dk/dv kernel works in transposed scores, S^T = K Q^T and dP^T = V dO^T,
// so that (m P)^T and dS^T, formed and rounded in registers, are directly
// the register A operands of dV += (m P)^T dO and dK += dS^T Q; the dq kernel
// forms dS in registers as the A operand of dQ += dS K. All accumulators
// (S, dP, dQ, dK, dV) live in registers; no f32 tile touches shared memory.
// (Overlapping a tile's score products with the previous tile's
// accumulating ones, as the forward does, was tried: at the training shape
// it was no faster and took 40 more registers.)
//
// f32 (flash_bwd_*_f32_kernel): CUDA-core FMAs through shared memory, so
// that f32 gradients keep f32 accuracy (the gradient checks' path).
//
// Layout: q, O, dO, dq (BH, Tq, D); k, v, dk, dv (BH, Tk, D) in the input
// type; lse, delta (BH, Tq) f32; all contiguous, bf16 bases 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BT = 64;         // rows of the tile a block owns, and of the tiles it walks
constexpr int NTHREADS = 128;  // 4 warps: one warpgroup

// what every tile needs to rebuild the forward's probabilities
struct TileParams {
  int t_q, kvlen, causal, period, bh;
  float slope, sm_scale, keep_scale;
  float c, slope2;  // sm_scale and slope times log2 e (the bf16 kernels' exponent)
  uint32_t seed, drop_thr;
};

__device__ TileParams tile_params(const int* kv_len, const float* slopes, int heads, int t_q,
                                  int causal, int period, float sm_scale, const int* seed,
                                  uint32_t drop_thr, float keep_scale) {
  TileParams tp;
  tp.bh = blockIdx.y;
  tp.t_q = t_q;
  tp.kvlen = kv_len[tp.bh / heads];
  tp.causal = causal;
  tp.period = period;
  tp.slope = slopes[tp.bh % heads];
  tp.sm_scale = sm_scale;
  tp.c = sm_scale * LOG2E;
  tp.slope2 = tp.slope * LOG2E;
  tp.keep_scale = keep_scale;
  tp.drop_thr = drop_thr;
  tp.seed = drop_thr > 0 ? (uint32_t)seed[0] : 0u;
  return tp;
}

// p (zeroed by the mask, never trusted to underflow: a fully masked row has
// a finite lse of about -1e30, and a padded row (>= t_q) has lse 0), the
// keep multiplier m, and ds = p (m dP - delta) scale of one position; the
// exponent in log2 units (lse2 = lse log2 e), the scale folded into an FMA
struct Grad {
  float pm, ds;
};
__device__ __forceinline__ Grad position_grad(float s, float dp, float lse2, float delta, int row,
                                              int col, const TileParams& tp) {
  float x = fmaf(s, tp.c, -lse2);
  if (tp.period > 0) x -= tp.slope2 * (float)floor_div(row - col, tp.period);
  const bool ok = row < tp.t_q && col < tp.kvlen && (!tp.causal || col <= row);
  const float p = ok ? fast_exp2(x) : 0.f;
  float m = 1.f;
  if (tp.drop_thr > 0) m = dropout_keep(tp.seed, tp.bh, row, col, tp.drop_thr, tp.keep_scale);
  return {p * m, p * (dp * m - delta) * tp.sm_scale};
}

// delta = rowsum(dO * O) of row q0 + tid / 2 in f32, two threads a row
// (each sums half of D, then they exchange); 0 for rows at or past t_q. The
// first thread of each pair writes it to `delta`.
template <typename T, int D>
__device__ float row_delta(const T* out, const T* dout, float* delta, int bh, int q0, int t_q) {
  const int row = q0 + threadIdx.x / 2, half = threadIdx.x % 2;
  float acc = 0.f;
  if (row < t_q) {
    const size_t base = ((size_t)bh * t_q + row) * D + half * (D / 2);
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(out + base + c);
        const uint4 b = *reinterpret_cast<const uint4*>(dout + base + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 fa = __bfloat1622float2(a2[i]), fb = __bfloat1622float2(b2[i]);
          acc = fmaf(fa.x, fb.x, acc);
          acc = fmaf(fa.y, fb.y, acc);
        }
      }
    } else {
      for (int c = 0; c < D / 2; ++c) acc = fmaf(out[base + c], dout[base + c], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0 && row < t_q) delta[(size_t)bh * t_q + row] = acc;
  return acc;
}

// ---- bf16: wgmma, register accumulators, cp.async ring --------------------

constexpr int STAGES = 2;

template <int D>
struct WgmmaBwd {
  static constexpr int TILE = BT * D * 2;  // one 64-row bf16 tile
  static constexpr int ROWS = BT * 4;      // 64 f32 per-row values
  // dq: Q, dO resident; ring of (K, V)
  static constexpr int DQ_STAGE = 2 * TILE;
  static constexpr int DQ_BYTES = 2 * TILE + STAGES * DQ_STAGE;
  // dk/dv: K, V resident; ring of (Q, dO, lse, delta)
  static constexpr int DKDV_STAGE = 2 * TILE + 2 * ROWS;
  static constexpr int DKDV_BYTES = 2 * TILE + STAGES * DKDV_STAGE;
  static constexpr int DQ_MIN_BLOCKS = D <= 64 ? 3 : 2;
  static constexpr int DKDV_MIN_BLOCKS = D <= 64 ? 2 : 1;
};

// ---- dq (and delta): one block per (batch*head, 64-row q tile) ------------
template <int D>
__global__ void __launch_bounds__(NTHREADS, WgmmaBwd<D>::DQ_MIN_BLOCKS)
flash_bwd_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                          const int* __restrict__ kv_len, const float* __restrict__ slopes,
                          int heads, int t_q, int t_k, int causal, int period, float sm_scale,
                          const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using C = WgmmaBwd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem), s_do = s_q + C::TILE, s_ring = s_do + C::TILE;
  const TileParams tp =
      tile_params(kv_len, slopes, heads, t_q, causal, period, sm_scale, seed, drop_thr, keep_scale);
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int bh = tp.bh, q0 = blockIdx.x * BT;
  const __nv_bfloat16* kb = k + (size_t)bh * t_k * D;
  const __nv_bfloat16* vb = v + (size_t)bh * t_k * D;

  // group 0: Q, dO and the first K/V tile
  load_tile_async<D, BT, NTHREADS>(s_q, q + (size_t)bh * t_q * D, q0, t_q, tid);
  load_tile_async<D, BT, NTHREADS>(s_do, dout + (size_t)bh * t_q * D, q0, t_q, tid);
  load_tile_async<D, BT, NTHREADS>(s_ring, kb, 0, t_k, tid);
  load_tile_async<D, BT, NTHREADS>(s_ring + C::TILE, vb, 0, t_k, tid);
  cp_async_commit();

  // this thread's rows r0, r0 + 8 (accumulator layout, wgmma.cuh); their
  // delta comes from the thread pairs 2 (l / 4) and 2 (l / 4) + 16 of this warp
  const int r0 = q0 + 16 * w + l / 4;
  const int cq = 2 * (l % 4);
  const float dsum = row_delta<__nv_bfloat16, D>(out, dout, delta, bh, q0, t_q);
  const float dl[2] = {__shfl_sync(0xffffffffu, dsum, 2 * (l / 4)),
                       __shfl_sync(0xffffffffu, dsum, 2 * (l / 4) + 16)};
  float ll[2];  // lse of rows r0, r0 + 8 in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h)
    ll[h] = r0 + 8 * h < t_q ? lse[(size_t)bh * t_q + r0 + 8 * h] * LOG2E : 0.f;

  // the last k tile the KV length and causality can reach, as in the
  // forward; a zero-length item walks tile 0 fully masked and gets dq = 0
  int last = (max(tp.kvlen - 1, 0)) / BT;
  last = min(last, (t_k + BT - 1) / BT - 1);
  if (causal) last = min(last, (q0 + BT - 1) / BT);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait<0>();  // tile kt, issued an iteration ago
    fence_proxy_async();
    __syncthreads();  // ... is everyone's, and the other stage is read by all
    if (kt + 1 <= last) {  // the next tile's copy flies during this tile's math
      const uint32_t nxt = s_ring + ((kt + 1) % STAGES) * C::DQ_STAGE;
      load_tile_async<D, BT, NTHREADS>(nxt, kb, (kt + 1) * BT, t_k, tid);
      load_tile_async<D, BT, NTHREADS>(nxt + C::TILE, vb, (kt + 1) * BT, t_k, tid);
      cp_async_commit();
    }

    const int k0 = kt * BT;
    const uint32_t s_k = s_ring + (kt % STAGES) * C::DQ_STAGE, s_v = s_k + C::TILE;
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<D>(s_q, 0, kk), desc_kmajor<D>(s_k, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_kmajor<D>(s_do, 0, kk), desc_kmajor<D>(s_v, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of the scores, then rounded into the A fragments of dS K
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      s[i] = position_grad(s[i], dp[i], ll[h], dl[h], r0 + 8 * h, k0 + 8 * (i >> 2) + cq + (i & 1), tp).ds;
    }
    uint32_t dsa[BT / 16][4];
    pack_frags<BT>(s, dsa);
    fence_regs(acc);
    fence_frags(dsa);
    // dQ += dS K: K (keys x D) MN-major from shared memory
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs<D>(acc, dsa[kk], desc_mnmajor<D>(s_k, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= t_q) continue;
    __nv_bfloat16* drow = dq + ((size_t)bh * t_q + row) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + 8 * j) = pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// (Q, dO, lse, delta) of q tile iq into a dk/dv ring stage
template <int D>
__device__ __forceinline__ void load_q_stage(uint32_t stage, const __nv_bfloat16* qb,
                                             const __nv_bfloat16* dob, const float* lseb,
                                             const float* deltab, int iq, int t_q, int tid) {
  using C = WgmmaBwd<D>;
  const int q0 = iq * BT;
  load_tile_async<D, BT, NTHREADS>(stage, qb, q0, t_q, tid);
  load_tile_async<D, BT, NTHREADS>(stage + C::TILE, dob, q0, t_q, tid);
  const int i = tid % BT;
  const bool ok = q0 + i < t_q;
  const float* src = (tid < BT ? lseb : deltab) + (ok ? q0 + i : 0);
  cp_async4(stage + 2 * C::TILE + (tid < BT ? 0 : C::ROWS) + 4 * i, src, ok);
}

// ---- dk, dv: one block per (batch*head, 64-row k tile), loop over q tiles --
template <int D>
__global__ void __launch_bounds__(NTHREADS, WgmmaBwd<D>::DKDV_MIN_BLOCKS)
flash_bwd_dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            const int* __restrict__ kv_len, const float* __restrict__ slopes,
                            int heads, int t_q, int t_k, int causal, int period, float sm_scale,
                            const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using C = WgmmaBwd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem), s_v = s_k + C::TILE, s_ring = s_v + C::TILE;
  const TileParams tp =
      tile_params(kv_len, slopes, heads, t_q, causal, period, sm_scale, seed, drop_thr, keep_scale);
  const int tid = threadIdx.x, w = tid / 32, l = tid % 32;
  const int bh = tp.bh, k0 = blockIdx.x * BT;
  const __nv_bfloat16* qb = q + (size_t)bh * t_q * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * t_q * D;
  const float* lseb = lse + (size_t)bh * t_q;
  const float* deltab = delta + (size_t)bh * t_q;

  // this thread's keys c0, c0 + 8 (rows of the transposed accumulators)
  const int c0 = k0 + 16 * w + l / 4;
  const int cq = 2 * (l % 4);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // keys at or past the KV length are masked everywhere: their dk, dv stay 0;
  // under causality, q tiles wholly above this k tile contribute nothing
  const int n_q_tiles = (t_q + BT - 1) / BT;
  const int iq0 = causal ? k0 / BT : 0;
  if (k0 < tp.kvlen && iq0 < n_q_tiles) {
    // group 0: K, V and the first q tile
    load_tile_async<D, BT, NTHREADS>(s_k, k + (size_t)bh * t_k * D, k0, t_k, tid);
    load_tile_async<D, BT, NTHREADS>(s_v, v + (size_t)bh * t_k * D, k0, t_k, tid);
    load_q_stage<D>(s_ring, qb, dob, lseb, deltab, iq0, t_q, tid);
    cp_async_commit();

    for (int iq = iq0; iq < n_q_tiles; ++iq) {
      const int it = iq - iq0;
      cp_async_wait<0>();  // q tile iq, issued an iteration ago
      fence_proxy_async();
      __syncthreads();  // ... is everyone's, and the other stage is read by all
      if (iq + 1 < n_q_tiles) {  // the next tile's copy flies during this tile's math
        load_q_stage<D>(s_ring + ((it + 1) % STAGES) * C::DKDV_STAGE, qb, dob, lseb, deltab, iq + 1,
                        t_q, tid);
        cp_async_commit();
      }

      const int q0 = iq * BT;
      const uint32_t s_q = s_ring + (it % STAGES) * C::DKDV_STAGE, s_do = s_q + C::TILE;
      const float* rows = reinterpret_cast<const float*>(smem + (s_q - s_k) + 2 * C::TILE);
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, desc_kmajor<D>(s_k, 0, kk), desc_kmajor<D>(s_q, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, desc_kmajor<D>(s_v, 0, kk), desc_kmajor<D>(s_do, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // (m P)^T in place of S^T and dS^T in place of dP^T, then rounded into
      // the A fragments of the two products
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int key = c0 + 8 * ((i >> 1) & 1), qc = 8 * (i >> 2) + cq;  // qc: q row within the tile
        const float2 lq = *reinterpret_cast<const float2*>(rows + qc);
        const float2 dq2 = *reinterpret_cast<const float2*>(rows + BT + qc);
        const Grad g0 = position_grad(st[i], dpt[i], lq.x * LOG2E, dq2.x, q0 + qc, key, tp);
        const Grad g1 = position_grad(st[i + 1], dpt[i + 1], lq.y * LOG2E, dq2.y, q0 + qc + 1, key, tp);
        st[i] = g0.pm;
        st[i + 1] = g1.pm;
        dpt[i] = g0.ds;
        dpt[i + 1] = g1.ds;
      }
      uint32_t pa[BT / 16][4], dsa[BT / 16][4];
      pack_frags<BT>(st, pa);
      pack_frags<BT>(dpt, dsa);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_frags(pa);
      fence_frags(dsa);
      // dV += (m P)^T dO and dK += dS^T Q: dO and Q (q rows x D) MN-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs<D>(dv_acc, pa[kk], desc_mnmajor<D>(s_do, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs<D>(dk_acc, dsa[kk], desc_mnmajor<D>(s_q, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
  }

  __nv_bfloat16* dkb = dk + (size_t)bh * t_k * D;
  __nv_bfloat16* dvb = dv + (size_t)bh * t_k * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = c0 + 8 * h;
    if (key >= t_k) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t)key * D + 8 * j + cq;
      *reinterpret_cast<uint32_t*>(dkb + at) = pack_bf16(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvb + at) = pack_bf16(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---- f32: CUDA-core FMAs through shared memory ----------------------------

// Shared-memory map of one block. NQ query rows by NK key columns per score
// tile; the dk/dv kernel keeps P and two accumulators, the dq kernel one.
template <int D, int NQ, int NK, bool DKDV>
struct Layout {
  static constexpr int TP = D + 1;   // q/k/v/dO pitch (odd: conflict-free columns)
  static constexpr int SP = NK + 4;  // score and dP pitch
  static constexpr int PP = NK + 1;  // P and dS pitch
  static constexpr int OP = D + 4;   // accumulator pitch
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(NQ * TP * sizeof(float));
  static constexpr int K = DO + align128(NQ * TP * sizeof(float));
  static constexpr int V = K + align128(NK * TP * sizeof(float));
  static constexpr int S = V + align128(NK * TP * sizeof(float));
  static constexpr int DP = S + align128(NQ * SP * sizeof(float));
  static constexpr int DS = DP + align128(NQ * SP * sizeof(float));
  static constexpr int P = DS + align128(NQ * PP * sizeof(float));
  static constexpr int LSE = P + (DKDV ? align128(NQ * PP * sizeof(float)) : 0);
  static constexpr int DELTA = LSE + align128(NQ * sizeof(float));
  static constexpr int ACC0 = DELTA + align128(NQ * sizeof(float));
  static constexpr int ACC1 = ACC0 + align128(BT * OP * sizeof(float));
  static constexpr int BYTES = ACC1 + (DKDV ? align128(BT * OP * sizeof(float)) : 0);
};

// ROWS rows [row0, row0 + ROWS) of a (T, D) slab into a pitched tile; rows
// past `valid` are zero
template <int D, int TP, int ROWS>
__device__ void load_tile(float* dst, const float* src, int row0, int valid) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NTHREADS) {
    int r = idx / D, c = idx % D;
    int g = row0 + r;
    dst[r * TP + c] = g < valid ? src[(size_t)g * D + c] : 0.f;
  }
}

// ROWS per-row scalars (lse, delta); rows past `valid` are zero
template <int ROWS>
__device__ void load_rows(float* dst, const float* src, int row0, int valid) {
  for (int i = threadIdx.x; i < ROWS; i += NTHREADS) dst[i] = row0 + i < valid ? src[row0 + i] : 0.f;
}

// out[NQ x NK] = A[NQ x D] B[NK x D]^T: the scores q k^T and dP = dO v^T
template <int D, int NQ, int NK, int TP, int SP>
__device__ void abt_product(const float* As, const float* Bs, float* out) {
  for (int idx = threadIdx.x; idx < NQ * NK; idx += NTHREADS) {
    int r = idx / NK, c = idx % NK;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(As[r * TP + d], Bs[c * TP + d], s);
    out[r * SP + c] = s;
  }
}

// acc[NK x D] += A[NQ x NK]^T B[NQ x D]: dv += (m p)^T dO and dk += ds^T q
template <int D, int NQ, int NK, int PP, int TP, int OP>
__device__ void atb_accumulate(const float* As, const float* Bs, float* acc_s) {
  for (int idx = threadIdx.x; idx < NK * D; idx += NTHREADS) {
    int c = idx / D, d = idx % D;
    float o = acc_s[c * OP + d];
#pragma unroll 16
    for (int r = 0; r < NQ; ++r) o = fmaf(As[r * PP + c], Bs[r * TP + d], o);
    acc_s[c * OP + d] = o;
  }
}

// acc[NQ x D] += A[NQ x NK] B[NK x D]: dq += ds k
template <int D, int NQ, int NK, int PP, int TP, int OP>
__device__ void ab_accumulate(const float* As, const float* Bs, float* acc_s) {
  for (int idx = threadIdx.x; idx < NQ * D; idx += NTHREADS) {
    int r = idx / D, d = idx % D;
    float o = acc_s[r * OP + d];
#pragma unroll 16
    for (int c = 0; c < NK; ++c) o = fmaf(As[r * PP + c], Bs[c * TP + d], o);
    acc_s[r * OP + d] = o;
  }
}

// From the score tile and dP = dO v^T: P' = m p (only when Ps is given) and
// dS = p (m dP - delta) scale. p is zeroed by the mask (see position_grad).
template <int NQ, int NK, int SP, int PP>
__device__ void probabilities_and_ds(const float* Ss, const float* dPs, float* Ps, float* dSs,
                                     const float* lse_s, const float* delta_s,
                                     int q0, int k0, const TileParams& tp) {
  for (int idx = threadIdx.x; idx < NQ * NK; idx += NTHREADS) {
    const int r = idx / NK, c = idx % NK;
    const int row = q0 + r, col = k0 + c;
    float x = Ss[r * SP + c] * tp.sm_scale;
    if (tp.period > 0) x -= tp.slope * (float)floor_div(row - col, tp.period);
    const bool ok = row < tp.t_q && col < tp.kvlen && (!tp.causal || col <= row);
    const float p = ok ? expf(x - lse_s[r]) : 0.f;
    float m = 1.f;
    if (tp.drop_thr > 0) m = dropout_keep(tp.seed, tp.bh, row, col, tp.drop_thr, tp.keep_scale);
    const float ds = p * (dPs[r * SP + c] * m - delta_s[r]) * tp.sm_scale;
    if (Ps != nullptr) Ps[r * PP + c] = p * m;
    dSs[r * PP + c] = ds;
  }
}

template <int D, int NQ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ kv_len, const float* __restrict__ slopes,
                          int heads, int t_q, int t_k, int causal, int period,
                          float sm_scale, const int* __restrict__ seed, uint32_t drop_thr,
                          float keep_scale) {
  using L = Layout<D, NQ, BT, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* dOs = reinterpret_cast<float*>(smem + L::DO);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  float* dSs = reinterpret_cast<float*>(smem + L::DS);
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  float* dKs = reinterpret_cast<float*>(smem + L::ACC0);
  float* dVs = reinterpret_cast<float*>(smem + L::ACC1);

  const TileParams tp =
      tile_params(kv_len, slopes, heads, t_q, causal, period, sm_scale, seed, drop_thr, keep_scale);
  const int bh = tp.bh;
  const int k0 = blockIdx.x * BT;
  const float* qb = q + (size_t)bh * t_q * D;
  const float* dob = dout + (size_t)bh * t_q * D;
  const float* lseb = lse + (size_t)bh * t_q;
  const float* deltab = delta + (size_t)bh * t_q;

  for (int idx = threadIdx.x; idx < BT * L::OP; idx += NTHREADS) {
    dKs[idx] = 0.f;
    dVs[idx] = 0.f;
  }
  // keys at or past the KV length are masked everywhere: their dk, dv stay 0
  if (k0 < tp.kvlen) {
    load_tile<D, L::TP, BT>(Ks, k + (size_t)bh * t_k * D, k0, t_k);
    load_tile<D, L::TP, BT>(Vs, v + (size_t)bh * t_k * D, k0, t_k);
    const int n_q_tiles = (t_q + NQ - 1) / NQ;
    // under causality, q tiles wholly above this k tile contribute nothing
    for (int iq = causal ? k0 / NQ : 0; iq < n_q_tiles; ++iq) {
      const int q0 = iq * NQ;
      __syncthreads();  // the previous tile's products are done
      load_tile<D, L::TP, NQ>(Qs, qb, q0, t_q);
      load_tile<D, L::TP, NQ>(dOs, dob, q0, t_q);
      load_rows<NQ>(lse_s, lseb, q0, t_q);
      load_rows<NQ>(delta_s, deltab, q0, t_q);
      __syncthreads();
      abt_product<D, NQ, BT, L::TP, L::SP>(Qs, Ks, Ss);
      abt_product<D, NQ, BT, L::TP, L::SP>(dOs, Vs, dPs);
      __syncthreads();
      probabilities_and_ds<NQ, BT, L::SP, L::PP>(Ss, dPs, Ps, dSs, lse_s, delta_s, q0, k0, tp);
      __syncthreads();
      atb_accumulate<D, NQ, BT, L::PP, L::TP, L::OP>(Ps, dOs, dVs);
      atb_accumulate<D, NQ, BT, L::PP, L::TP, L::OP>(dSs, Qs, dKs);
    }
  }
  __syncthreads();

  float* dkb = dk + (size_t)bh * t_k * D;
  float* dvb = dv + (size_t)bh * t_k * D;
  for (int idx = threadIdx.x; idx < BT * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    if (k0 + r < t_k) {
      dkb[(size_t)(k0 + r) * D + d] = dKs[r * L::OP + d];
      dvb[(size_t)(k0 + r) * D + d] = dVs[r * L::OP + d];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ out,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        const int* __restrict__ kv_len, const float* __restrict__ slopes,
                        int heads, int t_q, int t_k, int causal, int period, float sm_scale,
                        const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using L = Layout<D, BT, BT, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* dOs = reinterpret_cast<float*>(smem + L::DO);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  float* dSs = reinterpret_cast<float*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  float* dQs = reinterpret_cast<float*>(smem + L::ACC0);

  const TileParams tp =
      tile_params(kv_len, slopes, heads, t_q, causal, period, sm_scale, seed, drop_thr, keep_scale);
  const int bh = tp.bh;
  const int q0 = blockIdx.x * BT;

  const float* kb = k + (size_t)bh * t_k * D;
  const float* vb = v + (size_t)bh * t_k * D;
  load_tile<D, L::TP, BT>(Qs, q + (size_t)bh * t_q * D, q0, t_q);
  load_tile<D, L::TP, BT>(dOs, dout + (size_t)bh * t_q * D, q0, t_q);
  load_rows<BT>(lse_s, lse + (size_t)bh * t_q, q0, t_q);
  const float dsum = row_delta<float, D>(out, dout, delta, bh, q0, t_q);
  if (threadIdx.x % 2 == 0) delta_s[threadIdx.x / 2] = dsum;
  for (int idx = threadIdx.x; idx < BT * L::OP; idx += NTHREADS) dQs[idx] = 0.f;

  // the last k tile the KV length and causality can reach, as in the
  // forward; a zero-length item walks tile 0 fully masked and gets dq = 0
  int last = (max(tp.kvlen - 1, 0)) / BT;
  last = min(last, (t_k + BT - 1) / BT - 1);
  if (causal) last = min(last, (q0 + BT - 1) / BT);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K/V/dS reads are done
    load_tile<D, L::TP, BT>(Ks, kb, k0, t_k);
    load_tile<D, L::TP, BT>(Vs, vb, k0, t_k);
    __syncthreads();
    abt_product<D, BT, BT, L::TP, L::SP>(Qs, Ks, Ss);
    abt_product<D, BT, BT, L::TP, L::SP>(dOs, Vs, dPs);
    __syncthreads();
    probabilities_and_ds<BT, BT, L::SP, L::PP>(Ss, dPs, static_cast<float*>(nullptr), dSs,
                                              lse_s, delta_s, q0, k0, tp);
    __syncthreads();
    ab_accumulate<D, BT, BT, L::PP, L::TP, L::OP>(dSs, Ks, dQs);
  }
  __syncthreads();

  float* dqb = dq + (size_t)bh * t_q * D;
  for (int idx = threadIdx.x; idx < BT * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    if (q0 + r < t_q) dqb[(size_t)(q0 + r) * D + d] = dQs[r * L::OP + d];
  }
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int* kv_len;
  const float* slopes;
  int bh, heads, t_q, t_k, causal, period;
  float sm_scale;
  const int* seed;
  uint32_t drop_thr;
  float keep_scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bf16(const Args& a) {
  using C = WgmmaBwd<D>;
  using bf = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  const bf *q = static_cast<const bf*>(a.q), *k = static_cast<const bf*>(a.k);
  const bf *v = static_cast<const bf*>(a.v), *dout = static_cast<const bf*>(a.dout);
  dim3 q_grid((a.t_q + BT - 1) / BT, a.bh);
  flash_bwd_dq_wgmma_kernel<D><<<q_grid, NTHREADS, C::DQ_BYTES, a.stream>>>(
      q, k, v, static_cast<const bf*>(a.out), dout, a.lse, a.delta, static_cast<bf*>(a.dq),
      a.kv_len, a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed,
      a.drop_thr, a.keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 k_grid((a.t_k + BT - 1) / BT, a.bh);
  flash_bwd_dkdv_wgmma_kernel<D><<<k_grid, NTHREADS, C::DKDV_BYTES, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.kv_len,
      a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed, a.drop_thr,
      a.keep_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  // D = 128 walks 32-row q tiles so that the dk/dv block's tiles and two
  // accumulators fit one block's shared memory
  constexpr int NQ = D == 128 ? 32 : BT;
  constexpr int dkdv_bytes = Layout<D, NQ, BT, true>::BYTES;
  constexpr int dq_bytes = Layout<D, BT, BT, false>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  dim3 q_grid((a.t_q + BT - 1) / BT, a.bh);
  flash_bwd_dq_f32_kernel<D><<<q_grid, NTHREADS, dq_bytes, a.stream>>>(
      q, k, v, static_cast<const float*>(a.out), dout, a.lse, a.delta, static_cast<float*>(a.dq),
      a.kv_len, a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed,
      a.drop_thr, a.keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 k_grid((a.t_k + BT - 1) / BT, a.bh);
  flash_bwd_dkdv_f32_kernel<D, NQ><<<k_grid, NTHREADS, dkdv_bytes, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.kv_len, a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed,
      a.drop_thr, a.keep_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(bool bf16, const Args& a) {
  return bf16 ? launch_bf16<D>(a) : launch_f32<D>(a);
}

template <int D>
cudaError_t occupancy(int* info) {
  using C = WgmmaBwd<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  info[0] = C::DQ_BYTES;
  info[2] = C::DKDV_BYTES;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], flash_bwd_dq_wgmma_kernel<D>,
                                                      NTHREADS, C::DQ_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], flash_bwd_dkdv_wgmma_kernel<D>,
                                                       NTHREADS, C::DKDV_BYTES);
}

}  // namespace

// The bf16 kernels' shared memory per block and resident blocks per SM at
// head_dim: info[0], info[1] of the dq kernel, info[2], info[3] of dk/dv.
extern "C" int a2f_flash_attention_bwd_occupancy(int head_dim, int* info) {
  switch (head_dim) {
    case 16: return occupancy<16>(info);
    case 32: return occupancy<32>(info);
    case 64: return occupancy<64>(info);
    case 128: return occupancy<128>(info);
    default: return cudaErrorInvalidValue;
  }
}

// Launches the dq kernel (which also writes delta = rowsum(dO * O)), then
// the dk/dv kernel (which reads it), on `stream`. head_dim must be 16, 32,
// 64 or 128; period 0 = no bias. kv_len: (B,) int32 on the device, each in
// [0, t_k]; slopes: (H,) f32; lse: (B*H, t_q) f32, the forward's; delta:
// (B*H, t_q) f32 scratch, written. Dropout as in a2f_flash_attention_fwd:
// kept iff hash >= drop_thr, kept values scaled by keep_scale, drop_thr 0 =
// off; seed: (1,) int32 on the device, the forward's.
extern "C" int a2f_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv,
                                       const int* kv_len, const float* slopes, int batch,
                                       int heads, int t_q, int t_k, int head_dim, int is_bf16,
                                       int causal, int period, float sm_scale,
                                       const int* seed, unsigned int drop_thr,
                                       float keep_scale, void* stream) {
  Args a{q,      k,      v,      out,    dout,   lse,      delta,    dq,
         dk,     dv,     kv_len, slopes, batch * heads,    heads,    t_q,
         t_k,    causal, period, sm_scale, seed, drop_thr, keep_scale,
         static_cast<cudaStream_t>(stream)};
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 16: return launch<16>(bf16, a);
    case 32: return launch<32>(bf16, a);
    case 64: return launch<64>(bf16, a);
    case 128: return launch<128>(bf16, a);
    default: return cudaErrorInvalidValue;
  }
}

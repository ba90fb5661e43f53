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
// f32 (flash_bwd_*_f32_kernel; f32 training and the gradient checks):
// CUDA-core FMAs, so that f32 gradients keep f32 accuracy, register-tiled
// over a cp.async ring (ffma_tile.cuh): 64 owned rows a block, walked tiles
// of 32 rows, S and dP as 4 x 4 micro-tiles a thread, the accumulators in
// registers, (m P) and dS through shared memory once a tile. At the f32
// training shape the five products (<= 22 GFLOP) bound it by FMAs, not by
// its 118 MB. There is no short-key path: no path takes the gradient of the
// frame windows (the wav2vec2 extractor is detached).
//
// Layout: q, O, dO, dq (BH, Tq, D); k, v, dk, dv (BH, Tk, D) in the input
// type; lse, delta (BH, Tq) f32; all contiguous, bf16 bases 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffma_tile.cuh"
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

// ---- f32: register-tiled CUDA-core FMAs (ffma_tile.cuh) --------------------
//
// The same two kernels by output ownership, no atomics. Each block (128
// threads) owns 64 rows and walks tiles of 32 rows of the other operand
// through a two-stage cp.async ring, one block barrier a tile. Both score
// products (S and dP, or their transposes) are 4 x 4 register micro-tiles a
// thread; the gradient of each position is formed in registers
// (position_grad, as in the bf16 kernels); the tile that feeds the
// accumulating product (dS, or (m P)^T and dS^T) crosses shared memory once,
// warp-locally; the accumulators (dQ, or dK and dV) stay in registers, 4 x
// D/8 a thread, until the one write at the end.

template <int D>
struct F32Bwd {
  using T = FTile<D>;
  static constexpr int ROWS = FT_ROWS * 4;  // a tile's per-row f32 values
  // dq: Q and dO owned; ring of (K, V); dS; lse and delta of the owned rows
  static constexpr int DQ_STAGE = 2 * T::WALKED_BYTES;
  static constexpr int DQ_BYTES = 2 * T::OWNED_BYTES + 2 * DQ_STAGE + T::X_BYTES + 2 * ROWS;
  // dk/dv: K and V owned; ring of (Q, dO, lse, delta) of 32 q rows; (m P)^T and dS^T
  static constexpr int DKDV_STAGE = 2 * T::WALKED_BYTES + 2 * FT_COLS * 4;
  static constexpr int DKDV_BYTES = 2 * T::OWNED_BYTES + 2 * DKDV_STAGE + 2 * T::X_BYTES;
};

// ---- dq (and delta): one block per (batch*head, 64-row q tile) ------------
template <int D>
__global__ void __launch_bounds__(FT_NT)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ out,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq,
                        const int* __restrict__ kv_len, const float* __restrict__ slopes,
                        int heads, int t_q, int t_k, int causal, int period, float sm_scale,
                        const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using T = FTile<D>;
  using C = F32Bwd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Qs = reinterpret_cast<const float*>(smem);
  const float* dOs = reinterpret_cast<const float*>(smem + T::OWNED_BYTES);
  const int ring_off = 2 * T::OWNED_BYTES;
  float* Xs = reinterpret_cast<float*>(smem + ring_off + 2 * C::DQ_STAGE);
  float* lse_s = reinterpret_cast<float*>(smem + ring_off + 2 * C::DQ_STAGE + T::X_BYTES);
  float* delta_s = lse_s + FT_ROWS;
  const uint32_t s_q = smem_u32(smem), s_ring = s_q + ring_off;
  const TileParams tp =
      tile_params(kv_len, slopes, heads, t_q, causal, period, sm_scale, seed, drop_thr, keep_scale);
  const int tid = threadIdx.x;
  const FMap mp;
  const int bh = tp.bh, q0 = blockIdx.x * FT_ROWS;
  const float* kb = k + (size_t)bh * t_k * D;
  const float* vb = v + (size_t)bh * t_k * D;

  // the last k tile the KV length and causality can reach, as in the
  // forward; a zero-length item walks tile 0 fully masked and gets dq = 0
  int last = max(tp.kvlen - 1, 0) / FT_COLS;
  last = min(last, (t_k + FT_COLS - 1) / FT_COLS - 1);
  if (causal) last = min(last, (q0 + FT_ROWS - 1) / FT_COLS);

  auto load_kv = [&](int kt) {
    if (kt <= last) {
      const uint32_t stage = s_ring + (kt % 2) * C::DQ_STAGE;
      ft_load_async<D, FT_COLS>(stage, kb, kt * FT_COLS, t_k, tid);
      ft_load_async<D, FT_COLS>(stage + T::WALKED_BYTES, vb, kt * FT_COLS, t_k, tid);
    }
    cp_async_commit();
  };
  // group 0: Q, dO and the first K/V tile
  ft_load_async<D, FT_ROWS>(s_q, q + (size_t)bh * t_q * D, q0, t_q, tid);
  ft_load_async<D, FT_ROWS>(s_q + T::OWNED_BYTES, dout + (size_t)bh * t_q * D, q0, t_q, tid);
  load_kv(0);
  const float dsum = row_delta<float, D>(out, dout, delta, bh, q0, t_q);
  if (tid % 2 == 0) delta_s[tid / 2] = dsum;
  if (tid < FT_ROWS) lse_s[tid] = q0 + tid < t_q ? lse[(size_t)bh * t_q + q0 + tid] * LOG2E : 0.f;
  __syncthreads();
  float ll[4], dl[4];  // lse (log2 units) and delta of this thread's rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ll[i] = lse_s[mp.row(i)];
    dl[i] = delta_s[mp.row(i)];
  }

  float acc[4][T::NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < T::NV; ++e) acc[i][e] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is everyone's; the other stage is read by all
    load_kv(kt + 1);
    const float* Ks = reinterpret_cast<const float*>(smem + ring_off + (kt % 2) * C::DQ_STAGE);
    const float* Vs = Ks + T::WALKED_BYTES / 4;
    const int k0 = kt * FT_COLS;
    float s[4][4], dp[4][4];
    ft_scores<D>(Qs, Ks, mp, s);
    ft_scores<D>(dOs, Vs, mp, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = position_grad(s[i][j], dp[i][j], ll[i], dl[i], q0 + mp.row(i), k0 + mp.col(j), tp).ds;
    __syncwarp();  // the warp's reads of the last tile's dS are done
    ft_store_x(Xs, mp, s);
    __syncwarp();
    ft_accumulate<D>(Xs, Ks, mp, acc);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + mp.row(i);
    if (row < t_q) ft_store_row<D>(dq + ((size_t)bh * t_q + row) * D, mp, acc[i], 1.f);
  }
}

// ---- dk, dv: one block per (batch*head, 64-key tile), loop over q tiles --
template <int D>
__global__ void __launch_bounds__(FT_NT)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          const int* __restrict__ kv_len, const float* __restrict__ slopes,
                          int heads, int t_q, int t_k, int causal, int period, float sm_scale,
                          const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using T = FTile<D>;
  using C = F32Bwd<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Ks = reinterpret_cast<const float*>(smem);
  const float* Vs = reinterpret_cast<const float*>(smem + T::OWNED_BYTES);
  const int ring_off = 2 * T::OWNED_BYTES;
  float* Xp = reinterpret_cast<float*>(smem + ring_off + 2 * C::DKDV_STAGE);
  float* Xd = Xp + T::X_BYTES / 4;
  const uint32_t s_k = smem_u32(smem), s_ring = s_k + ring_off;
  const TileParams tp =
      tile_params(kv_len, slopes, heads, t_q, causal, period, sm_scale, seed, drop_thr, keep_scale);
  const int tid = threadIdx.x;
  const FMap mp;
  const int bh = tp.bh, k0 = blockIdx.x * FT_ROWS;
  const float* qb = q + (size_t)bh * t_q * D;
  const float* dob = dout + (size_t)bh * t_q * D;
  const float* lseb = lse + (size_t)bh * t_q;
  const float* deltab = delta + (size_t)bh * t_q;

  float dk_acc[4][T::NV], dv_acc[4][T::NV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < T::NV; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // (Q, dO, lse, delta) of the 32-row q tile iq into a ring stage
  auto load_q = [&](int iq, int n_q_tiles) {
    if (iq < n_q_tiles) {
      const uint32_t stage = s_ring + (iq % 2) * C::DKDV_STAGE;
      const int q0 = iq * FT_COLS;
      ft_load_async<D, FT_COLS>(stage, qb, q0, t_q, tid);
      ft_load_async<D, FT_COLS>(stage + T::WALKED_BYTES, dob, q0, t_q, tid);
      if (tid < 2 * FT_COLS) {
        const int i = tid % FT_COLS;
        const bool ok = q0 + i < t_q;
        const float* src = (tid < FT_COLS ? lseb : deltab) + (ok ? q0 + i : 0);
        cp_async4(stage + 2 * T::WALKED_BYTES + (tid < FT_COLS ? 0 : 4 * FT_COLS) + 4 * i, src, ok);
      }
    }
    cp_async_commit();
  };

  // keys at or past the KV length are masked everywhere: their dk, dv stay 0;
  // under causality, q tiles wholly above this k tile contribute nothing
  const int n_q_tiles = (t_q + FT_COLS - 1) / FT_COLS;
  const int iq0 = causal ? k0 / FT_COLS : 0;
  if (k0 < tp.kvlen && iq0 < n_q_tiles) {
    // group 0: K, V and the first q tile
    ft_load_async<D, FT_ROWS>(s_k, k + (size_t)bh * t_k * D, k0, t_k, tid);
    ft_load_async<D, FT_ROWS>(s_k + T::OWNED_BYTES, v + (size_t)bh * t_k * D, k0, t_k, tid);
    load_q(iq0, n_q_tiles);
    for (int iq = iq0; iq < n_q_tiles; ++iq) {
      cp_async_wait<0>();
      __syncthreads();  // q tile iq is everyone's; the other stage is read by all
      load_q(iq + 1, n_q_tiles);
      const unsigned char* stage = smem + ring_off + (iq % 2) * C::DKDV_STAGE;
      const float* Qt = reinterpret_cast<const float*>(stage);
      const float* dOt = Qt + T::WALKED_BYTES / 4;
      const float* lse_t = dOt + T::WALKED_BYTES / 4;
      const float* delta_t = lse_t + FT_COLS;
      const int q0 = iq * FT_COLS;
      // transposed tiles: rows are this block's keys, columns the q rows
      float st[4][4], dpt[4][4];
      ft_scores<D>(Ks, Qt, mp, st);
      ft_scores<D>(Vs, dOt, mp, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float l2 = lse_t[mp.col(j)] * LOG2E, dl = delta_t[mp.col(j)];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const Grad gr = position_grad(st[i][j], dpt[i][j], l2, dl, q0 + mp.col(j), k0 + mp.row(i), tp);
          st[i][j] = gr.pm;
          dpt[i][j] = gr.ds;
        }
      }
      __syncwarp();  // the warp's reads of the last tile's (m P)^T and dS^T are done
      ft_store_x(Xp, mp, st);
      ft_store_x(Xd, mp, dpt);
      __syncwarp();
      ft_accumulate<D>(Xp, dOt, mp, dv_acc);  // dV += (m P)^T dO
      ft_accumulate<D>(Xd, Qt, mp, dk_acc);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + mp.row(i);
    if (key >= t_k) continue;
    ft_store_row<D>(dk + ((size_t)bh * t_k + key) * D, mp, dk_acc[i], 1.f);
    ft_store_row<D>(dv + ((size_t)bh * t_k + key) * D, mp, dv_acc[i], 1.f);
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
  using C = F32Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  dim3 q_grid((a.t_q + FT_ROWS - 1) / FT_ROWS, a.bh);
  flash_bwd_dq_f32_kernel<D><<<q_grid, FT_NT, C::DQ_BYTES, a.stream>>>(
      q, k, v, static_cast<const float*>(a.out), dout, a.lse, a.delta, static_cast<float*>(a.dq),
      a.kv_len, a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed,
      a.drop_thr, a.keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 k_grid((a.t_k + FT_ROWS - 1) / FT_ROWS, a.bh);
  flash_bwd_dkdv_f32_kernel<D><<<k_grid, FT_NT, C::DKDV_BYTES, a.stream>>>(
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

template <int D>
cudaError_t occupancy_f32(int* info) {
  using C = F32Bwd<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKDV_BYTES);
  if (err != cudaSuccess) return err;
  info[0] = C::DQ_BYTES;
  info[2] = C::DKDV_BYTES;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], flash_bwd_dq_f32_kernel<D>, FT_NT,
                                                      C::DQ_BYTES);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], flash_bwd_dkdv_f32_kernel<D>,
                                                       FT_NT, C::DKDV_BYTES);
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

// The f32 kernels' shared memory per block and resident blocks per SM at
// head_dim: info[0], info[1] of the dq kernel, info[2], info[3] of dk/dv.
extern "C" int a2f_flash_attention_bwd_f32_occupancy(int head_dim, int* info) {
  switch (head_dim) {
    case 16: return occupancy_f32<16>(info);
    case 32: return occupancy_f32<32>(info);
    case 64: return occupancy_f32<64>(info);
    case 128: return occupancy_f32<128>(info);
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

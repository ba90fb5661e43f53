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
// f32 (flash_fwd_f32_kernel): CUDA-core FMAs through shared memory, so that
// f32 results keep f32 accuracy (the gradient checks' path).
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), o (BH, Tq, D) in the input
// type, lse (BH, Tq) f32; all contiguous, bf16 bases 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                       uint32_t drop_thr, float keep_scale) {
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
  sa.bh = bh;
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

// ---- f32: CUDA-core FMAs through shared memory ----------------------------

constexpr int BQ = 64;         // query rows per block (16 per warp)
constexpr int NTHREADS = 128;  // 4 warps

template <int D>
struct Layout {
  static constexpr int TP = D + 1;   // q/k/v pitch (odd: conflict-free columns)
  static constexpr int SP = BK + 4;  // score pitch
  static constexpr int PP = BK + 1;  // probability pitch
  static constexpr int OP = D + 4;   // accumulator pitch
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * TP * sizeof(float));
  static constexpr int V = K + align128(BK * TP * sizeof(float));
  static constexpr int S = V + align128(BK * TP * sizeof(float));
  static constexpr int P = S + align128(BQ * SP * sizeof(float));
  static constexpr int O = P + align128(BQ * PP * sizeof(float));
  static constexpr int BYTES = O + align128(BQ * OP * sizeof(float));
};

// 64 rows [row0, row0 + 64) of a (T, D) slab into a pitched tile; rows past
// `valid` are zero
template <int D, int TP>
__device__ void load_tile(float* dst, const float* src, int row0, int valid) {
  static_assert(BQ == BK, "one tile height for q, k and v");
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    int r = idx / D, c = idx % D;
    int g = row0 + r;
    dst[r * TP + c] = g < valid ? src[(size_t)g * D + c] : 0.f;
  }
}

// S = Q K^T for the whole 64x64 tile
template <int D, int TP, int SP>
__device__ void scores(const float* Qs, const float* Ks, float* Ss) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
    int r = idx / BK, c = idx % BK;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(Qs[r * TP + d], Ks[c * TP + d], s);
    Ss[r * SP + c] = s;
  }
}

// O += P V for the whole tile
template <int D, int TP, int PP, int OP>
__device__ void accumulate_pv(const float* Ps, const float* Vs, float* Os) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    int r = idx / D, d = idx % D;
    float o = Os[r * OP + d];
#pragma unroll 16
    for (int c = 0; c < BK; ++c) o = fmaf(Ps[r * PP + c], Vs[c * TP + d], o);
    Os[r * OP + d] = o;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_len,
                     const float* __restrict__ slopes, int heads, int t_q, int t_k,
                     int causal, int period, float sm_scale,
                     const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q);
  float* Ks = reinterpret_cast<float*>(smem + L::K);
  float* Vs = reinterpret_cast<float*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* Ps = reinterpret_cast<float*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvlen = kv_len[bh / heads];
  const float slope = slopes[bh % heads];
  const uint32_t seed0 = drop_thr > 0 ? (uint32_t)seed[0] : 0u;
  const float* qb = q + (size_t)bh * t_q * D;
  const float* kb = k + (size_t)bh * t_k * D;
  const float* vb = v + (size_t)bh * t_k * D;

  // each row is owned by a lane pair of the warp that computes it; lane
  // parity picks which half of the 64 columns (and of D) it handles
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32) + lane / 2;
  const int half = lane % 2;
  const int row = q0 + r;
  float m_run = MASK_VALUE, l_run = 0.f;

  load_tile<D, L::TP>(Qs, qb, q0, t_q);
  for (int idx = threadIdx.x; idx < BQ * L::OP; idx += NTHREADS) Os[idx] = 0.f;

  int last = (max(kvlen - 1, 0)) / BK;
  last = min(last, (t_k + BK - 1) / BK - 1);
  if (causal) last = min(last, (q0 + BQ - 1) / BK);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's K/V/P reads are done
    load_tile<D, L::TP>(Ks, kb, k0, t_k);
    load_tile<D, L::TP>(Vs, vb, k0, t_k);
    __syncthreads();
    scores<D, L::TP, L::SP>(Qs, Ks, Ss);
    __syncthreads();

    // online-softmax update of this row's half
    float s[BK / 2];
    float m_cur = MASK_VALUE;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int c = half * (BK / 2) + i;
      const int col = k0 + c;
      float x = Ss[r * L::SP + c] * sm_scale;
      if (period > 0) x -= slope * (float)floor_div(row - col, period);
      bool ok = col < kvlen && (!causal || col <= row);
      x = ok ? x : MASK_VALUE;
      s[i] = x;
      m_cur = fmaxf(m_cur, x);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    const float m_new = fmaxf(m_run, m_cur);
    const float alpha = expf(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float p = expf(s[i] - m_new);
      sum += p;
      if (drop_thr > 0)
        p *= dropout_keep(seed0, bh, row, k0 + half * (BK / 2) + i, drop_thr, keep_scale);
      Ps[r * L::PP + half * (BK / 2) + i] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = alpha * l_run + sum;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < D / 2; ++d) Os[r * L::OP + half * (D / 2) + d] *= alpha;
    __syncthreads();
    accumulate_pv<D, L::TP, L::PP, L::OP>(Ps, Vs, Os);
  }
  __syncthreads();

  if (row < t_q) {
    const float l = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l;
    float* ob = o + ((size_t)bh * t_q + row) * D + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) ob[d] = Os[r * L::OP + half * (D / 2) + d] * inv;
    if (half == 0) lse[(size_t)bh * t_q + row] = m_run + logf(l);
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
      a.keep_scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.t_q + BQ - 1) / BQ, a.bh);
  flash_fwd_f32_kernel<D><<<grid, NTHREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.kv_len, a.slopes,
      a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed, a.drop_thr, a.keep_scale);
  return cudaGetLastError();
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

// head_dim must be 16, 32, 64 or 128; period 0 = no bias.
// kv_len: (B,) int32 on the device, each in [0, t_k]; slopes: (H,) f32.
// Dropout: a position is kept iff its hash >= drop_thr, where drop_thr =
// min(int(rate * 2^31), 2^31 - 1) is computed by the caller in double;
// kept probabilities are scaled by keep_scale = 1 / (1 - rate). drop_thr 0
// turns dropout off (seed is then not read). seed: (1,) int32 on the device.
extern "C" int a2f_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, float* lse,
                                       const int* kv_len, const float* slopes,
                                       int batch, int heads, int t_q, int t_k,
                                       int head_dim, int is_bf16, int causal,
                                       int period, float sm_scale,
                                       const int* seed, unsigned int drop_thr,
                                       float keep_scale, void* stream) {
  Args a{q,      k,       v,     o,      lse,      kv_len,   slopes,   batch * heads,
         heads,  t_q,     t_k,   causal, period,   sm_scale, seed,     drop_thr,
         keep_scale, static_cast<cudaStream_t>(stream)};
  const bool bf16 = is_bf16 != 0;
  switch (head_dim) {
    case 16: return launch<16>(bf16, a);
    case 32: return launch<32>(bf16, a);
    case 64: return launch<64>(bf16, a);
    case 128: return launch<128>(bf16, a);
    default: return cudaErrorInvalidValue;
  }
}

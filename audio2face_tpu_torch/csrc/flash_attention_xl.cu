// Flash-attention forward with Transformer-XL relative-position attention
// for Hopper (sm_90a): the attention of the wav2vec2-Conformer's blocks
// (Gulati et al., arXiv:2005.08100; Dai et al., arXiv:1901.02860 §3.3, in
// ESPnet's form). No TPU counterpart: the JAX package has no Conformer.
//
// For head h, query i and key j the score is
//   s(i, j) = sm_scale * (q'_i . k_j + q'_i . r_h(i - j) + c_h(i - j))
// with q' = q + u (the caller folds pos_bias_u into q), r_h(m) the head's
// projected sinusoid of offset m, and c_h(m) = (v - u) . r_h(m) a per-head
// table of scalars. Then the online softmax, the value product, per-batch
// KV lengths and the per-row logsumexp, as flash_attention.cu's bf16 kernel
// computes them. No (T, T) or (T, 2T - 1) tensor exists.
//
// The term q' . r(i - j) depends on the query's content, so no table of
// scalars holds it: it is a 64-wide dot product for each score. A warpgroup
// of 64 query rows against a tile of 64 keys spans the offsets of two
// 64-row chunks of R (chunk x holds offsets 64 x .. 64 x + 63). The kernel
// computes each chunk's product with the warpgroup's rows once, by wgmma
// (Q' R_x^T, 64 x 64), and a chunk serves two consecutive key tiles: the
// entries at or below the diagonal (q = row - position >= 0) go to the next
// tile, those above to this one. So the product adds one 64 x 64 x 80
// product a tile to the two of plain attention: the fifth k block of 16
// carries c as c_hi + c_lo (two bf16 columns of R, beside two columns of
// ones in the A operand), which adds the table to the same f32 sums.
//
// The skew: entry (row, position p) of chunk x belongs to key column
// row - p (+64). Each warp owns its 16 rows of the product (the wgmma
// accumulator layout), so it writes its entries, skewed, into a ring of
// 128 f16 columns per row in shared memory, one per warp: the entry with
// q = row - p goes to column (64 (kt + 1) + q) mod 128, which is where tile
// kt reads key column q + 64 (q < 0) and tile kt + 1 reads key column q
// (q >= 0). Tile kt then reads its 64 columns in the accumulator layout
// (conflict-free: a row is 68 words), as the initial value of the score
// accumulator, and Q K^T accumulates onto it. The ring stores f16 (11
// significant bits: rounding a term of 40 costs 0.016 before the 1/8
// scale), saturated at +-65504.
//
// Shared memory (226 KB, one block an SM): Q (256 x 64 bf16), the K/V ring
// of flash_attention.cu (four stages), a ring of six R chunks (64 x 80
// bf16; the four warpgroups' chunks of this tile and two tiles ahead), the
// 64 x 16 ones operand, and the warps' staging rings. Each tile needs one
// new chunk: the warpgroups' chunks slide down by one a tile, so chunk x
// serves warpgroup 0 at one tile, warpgroup 1 at the next, and so on.
//
// Layout: q (BH, Tq, 64), k and v (BH, Tk, 64), o (BH, Tq, 64) bf16, lse
// (BH, Tq) f32; rel (H, 2 radius + 1, 80) bf16, row m + radius:
// [r_h(m) (64), c_hi, c_lo, 0 x 14]; all contiguous, 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float MASK2 = -1e30f * LOG2E;  // the mask value in log2 units
constexpr int D = 64;                    // head dim
constexpr int BK = 64;                   // keys a tile, offsets a chunk
constexpr int NWG = 4;                   // warpgroups, 64 query rows each
constexpr int BQ = 64 * NWG;
constexpr int NT = 128 * NWG;
constexpr int STAGES = 4;                // K/V ring as in flash_attention.cu
constexpr int DR = D + 16;               // an R row: r, c_hi, c_lo, zeros
constexpr int R_STAGES = 6;              // R chunks: four in use, two in flight
constexpr int SROW = 136;                // f16 a staging row: 128 columns, padded
constexpr float F16_MAX = 65504.f;

constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BK * D * 2;
constexpr int STAGE_BYTES = 2 * KV_BYTES;
constexpr int R_BYTES = BK * DR * 2;
constexpr int ONES_BYTES = 64 * 16 * 2;
constexpr int WARP_STAGING = 16 * SROW * 2;
constexpr int OFF_RING = Q_BYTES;
constexpr int OFF_R = OFF_RING + STAGES * STAGE_BYTES;
constexpr int OFF_ONES = OFF_R + R_STAGES * R_BYTES;
constexpr int OFF_STAGING = OFF_ONES + ONES_BYTES;
constexpr int BYTES = OFF_STAGING + (NT / 32) * WARP_STAGING;
static_assert(BYTES <= 227 * 1024, "one block's shared memory");

// rows [row0, row0 + 64) of a head's (n_rows, 80) R into a core-matrix
// tile; rows outside [0, n_rows) are zero-filled
__device__ __forceinline__ void load_r_chunk(uint32_t tile, const __nv_bfloat16* rel, int row0,
                                             int n_rows, int tid) {
  constexpr int CB = DR / 8;
#pragma unroll
  for (int idx = tid; idx < BK * CB; idx += NT) {
    const int cm = idx >> 3, r = (cm / CB) * 8 + (idx & 7), cb = cm % CB;
    const int g = row0 + r;
    const bool ok = g >= 0 && g < n_rows;
    cp_async16(tile + idx * 16, rel + (size_t)(ok ? g : 0) * DR + cb * 8, ok);
  }
}

// the online softmax of a warpgroup's 64 x 64 tile (flash_attention.cu's,
// with only the KV-length mask): s raw in, probabilities out
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&alpha)[2], int k0, int cq,
                                             int kvlen, float c) {
  float ce = c;
  if (k0 + BK > kvlen) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i >> 2) + cq + (i & 1);
      s[i] = col < kvlen ? s[i] * c : MASK2;
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
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    const float p = fast_exp2(fmaf(s[i], ce, -m_run[h]));
    sum[h] += p;
    s[i] = p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l_run[h] = alpha[h] * l_run[h] + sum[h];
  }
}

__global__ void __launch_bounds__(NT, 1)
flash_fwd_xl_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, const int* __restrict__ kv_len,
                    const __nv_bfloat16* __restrict__ rel, int heads, int t_q, int t_k, int radius,
                    float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_ring = s_q + OFF_RING;
  const uint32_t s_r = s_q + OFF_R;
  const uint32_t s_ones = s_q + OFF_ONES;

  const int tid = threadIdx.x;
  const int wg = tid / 128, w = (tid % 128) / 32, l = tid % 32;
  const int g = l / 4, cq = 2 * (l % 4);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int b0 = q0 / BK;  // warpgroup wg's tile-kt offsets lie in chunks b0 + wg - kt - 1, b0 + wg - kt
  const int n_rel = 2 * radius + 1;
  const __nv_bfloat16* kb = k + (size_t)bh * t_k * D;
  const __nv_bfloat16* vb = v + (size_t)bh * t_k * D;
  const __nv_bfloat16* relh = rel + (size_t)(bh % heads) * n_rel * DR;
  const int kvlen = kv_len[bh / heads];
  const float c = sm_scale * LOG2E;
  const int r0 = q0 + 64 * wg + 16 * w + g;  // this thread's rows r0 and r0 + 8
  // this warp's staging ring: 16 rows of 128 f16 columns
  __half* st = reinterpret_cast<__half*>(smem + OFF_STAGING) + (tid / 32) * (WARP_STAGING / 2);

  int last = (max(kvlen - 1, 0)) / BK;
  last = min(last, (t_k + BK - 1) / BK - 1);

  auto r_tile = [&](int x) {
    const int m = x % R_STAGES;
    return s_r + (m < 0 ? m + R_STAGES : m) * R_BYTES;
  };
  auto load_chunk = [&](int x) { load_r_chunk(r_tile(x), relh, BK * x + radius, n_rel, tid); };
  // tile kt and the chunk it brings (warpgroup 0's), if there is one
  auto load_kv = [&](int kt) {
    if (kt <= last) {
      const uint32_t stage = s_ring + (kt % STAGES) * STAGE_BYTES;
      load_tile_async<D, BK, NT>(stage, kb, kt * BK, t_k, tid);
      load_tile_async<D, BK, NT>(stage + KV_BYTES, vb, kt * BK, t_k, tid);
      load_chunk(b0 - 1 - kt);
    }
    cp_async_commit();
  };
  // group 0: Q, the chunks of the prologue (b0 .. b0 + 3), K/V tile 0 and
  // its chunk; group 1: tile 1
  load_tile_async<D, BQ, NT>(s_q, q + (size_t)bh * t_q * D, q0, t_q, tid);
  for (int x = b0; x < b0 + NWG; ++x) load_chunk(x);
  load_kv(0);
  load_kv(1);
  {  // the ones operand: columns 0 and 1 of each of its 64 rows (core-matrix layout)
    const bool one = (tid / 32) % 2 == 0 && tid % 4 == 0;
    reinterpret_cast<uint32_t*>(smem + OFF_ONES)[tid] = one ? 0x3F803F80u : 0u;
  }

  auto next_tile = [&](int kt) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load_kv(kt + 2);
  };

  // h = Q'_wg R_x^T + c, in the accumulator layout
  auto position_product = [&](float (&h)[BK / 2], int x) {
    const uint32_t rt = r_tile(x);
    fence_regs(h);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(h, desc_kmajor<D>(s_q, 64 * wg, kk), desc_kmajor<DR>(rt, 0, kk), kk > 0);
    wgmma_ss_n64(h, desc_kmajor<16>(s_ones, 0, 0), desc_kmajor<DR>(rt, 0, D / 16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(h);
  };
  // the chunk new at tile kt into the ring: entry (row, p) at column
  // (64 (kt + 1) + row - p) mod 128
  auto stage_chunk = [&](const float (&h)[BK / 2], int kt) {
    const int qb = BK * ((kt + 1) & 1) + 16 * w + g - cq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      __half* row = st + (g + 8 * hh) * SROW;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = fminf(fmaxf(h[4 * j + 2 * hh + e], -F16_MAX), F16_MAX);
          row[(qb + 8 * hh - 8 * j - e) & 127] = __float2half_rn(x);
        }
    }
  };
  // tile kt's 64 columns of the ring as the scores' initial value
  auto read_staged = [&](float (&s)[BK / 2], int kt) {
    const int rb = BK * (kt & 1) + cq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const __half* row = st + (g + 8 * hh) * SROW + rb;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 f = __half22float2(*reinterpret_cast<const __half2*>(row + 8 * j));
        s[4 * j + 2 * hh] = f.x;
        s[4 * j + 2 * hh + 1] = f.y;
      }
    }
  };

  float m_run[2] = {MASK2, MASK2}, l_run[2] = {0.f, 0.f}, alpha[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];  // P of the previous tile, waiting for its value product

  // prologue: the upper chunk of tile 0 (its entries at or below the diagonal)
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();
  position_product(s, b0 + wg);
  stage_chunk(s, -1);

  // tile 0
  next_tile(0);
  position_product(s, b0 + wg - 1);
  stage_chunk(s, 0);
  __syncwarp();
  read_staged(s, 0);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(s, desc_kmajor<D>(s_q, 64 * wg, kk), desc_kmajor<D>(s_ring, 0, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile(s, m_run, l_run, alpha, 0, cq, kvlen, c);
  pack_frags<BK>(s, pa);
  uint32_t s_v_prev = s_ring + KV_BYTES;

  // tile kt: this warpgroup's new chunk and its staging, then S_kt = the
  // staged terms + Q K_kt^T issued with O += P_{kt-1} V_{kt-1}; the softmax
  // of S_kt runs while the value product runs
  for (int kt = 1; kt <= last; ++kt) {
    next_tile(kt);
    const uint32_t s_k = s_ring + (kt % STAGES) * STAGE_BYTES;
    position_product(s, b0 + wg - 1 - kt);
    stage_chunk(s, kt);
    __syncwarp();
    read_staged(s, kt);
    fence_regs(s);
    fence_regs(acc);
    fence_frags(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_kmajor<D>(s_q, 64 * wg, kk), desc_kmajor<D>(s_k, 0, kk), 1);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(acc, pa[kk], desc_mnmajor<D>(s_v_prev, kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the scores; the value product may still run
    fence_regs(s);
    softmax_tile(s, m_run, l_run, alpha, kt * BK, cq, kvlen, c);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_frags<BK>(s, pa);
    s_v_prev = s_k + KV_BYTES;
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
    const int row = r0 + 8 * h;
    if (row >= t_q) continue;
    const float lsum = fmaxf(l_run[h], 1e-30f);
    const float inv = 1.f / lsum;
    __nv_bfloat16* orow = o + ((size_t)bh * t_q + row) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (l % 4 == 0) lse[(size_t)bh * t_q + row] = m_run[h] * LN2 + logf(lsum);
  }
}

}  // namespace

// The kernel's shared memory per block (info[0], bytes) and resident blocks
// per SM (info[1]).
extern "C" int a2f_flash_attention_fwd_xl_occupancy(int* info) {
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_xl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return err;
  info[0] = BYTES;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], flash_fwd_xl_kernel, NT, BYTES);
}

// bf16 forward with Transformer-XL relative-position attention, head_dim
// 64: rel (heads, 2 radius + 1, 80) bf16 as in the note at the top, radius
// at least max(t_q, t_k) - 1 so that every offset of a query and a key has
// its row; kv_len (batch,) int32 on the device, each in [0, t_k]; sm_scale
// positive. No causal mask, ALiBi or dropout.
extern "C" int a2f_flash_attention_fwd_xl(const void* q, const void* k, const void* v, void* o,
                                          float* lse, const int* kv_len, const void* rel,
                                          int batch, int heads, int t_q, int t_k, int head_dim,
                                          int radius, float sm_scale, void* stream) {
  if (head_dim != D || radius < t_q - 1 || radius < t_k - 1 || !(sm_scale > 0.f) || t_q < 1 ||
      t_k < 1)
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_xl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((t_q + BQ - 1) / BQ, batch * heads);
  flash_fwd_xl_kernel<<<grid, NT, BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, kv_len,
      static_cast<const __nv_bfloat16*>(rel), heads, t_q, t_k, radius, sm_scale);
  return cudaGetLastError();
}

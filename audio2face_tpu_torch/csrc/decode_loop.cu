// FaceFormer autoregressive decode loop for Hopper (sm_90a).
//
// Replaces the TPU kernel audio2face_tpu/ops/decode_kernel.py
// faceformer_decode_loop (_decode_kernel), both variants: the whole
// T-step loop in one launch. Each step t, for one batch item:
//
//   x_t   = emb_t + PPE[t mod period]
//   attn  = softmax_{j<=t}(q_t . k_j / sqrt(16) - slope_h * ((t-j) // period)) v_j
//   h     = LN1(x_t + W_o attn)
//   h     = LN2(h + ca_t)
//   h     = LN3(h + W_2 relu(W_1 h))
//   emb_{t+1} = h @ (W_r W_m) + b + style
//
// vocaset: ca_t = cross_t, the hoisted diagonal cross term. BIWI (template
// parameter): a true 2-way softmax per head over the audio latents
// {2t, 2t+1}, whose key/value projections mem_k, mem_v (2T, 64) are read
// from device memory, 2 x 128 floats a step:
//
//   qc    = h W_cq + b_cq
//   ca_t  = (softmax_{j in {2t,2t+1}}(qc . mem_k_j / sqrt(16)) mem_v_j) W_co + b_co
//
// The TPU kernel packs 8 items on lanes with block-diagonal weights; that
// packing exists for its layout and is not ported.
//
// Bound: the steps are a chain of dependent 64-wide matvecs, so latency
// bounds the dense part; the attention reads the KV cache rows [0, t]
// every step (sum_t 512 t bytes, 3.3 GB per item at T = 3600). Design: one
// thread-block cluster of CL CTAs (CL chosen by the host from the
// occupancy of clusters, up to 16) per batch item.
//   - Cache row j (f32 k | v, 512 B) belongs to CTA j mod CL and lives in
//     its shared memory, up to the rows a CTA has room for; later rows stay
//     in the caller's (B, T, 128) device buffer and their owner reads them,
//     so any T runs. Only the owner ever reads a row.
//   - Every CTA runs the step's dense chain itself from the same inputs
//     with the same code, so all hold the same bits; only the attention
//     partials cross SMs. Each CTA walks its own rows for the 4 heads, and
//     each warp pushes its (max, sum, 16-wide value sum) by st.async into
//     its slot in every CTA of the cluster (double-buffered by the parity
//     of t), completing on that CTA's mbarrier. So the step's one
//     cluster-wide synchronisation is each CTA waiting for its own
//     barrier: no barrier.cluster and no remote load a step (faster on an
//     H100 than one barrier.cluster a step and a distributed-shared-memory
//     gather: 20.7 against 23.0 ms at (8, 3600)). Every CTA then combines
//     the CL x 8 partials in one fixed order.
//   - Weights sit in shared memory in the caller's storage type (bf16 for
//     the bf16 predictor, exact, half the bytes of f32), matrices stored
//     (out, in), so that 8 lanes split each output's reduction with
//     16-byte loads and shuffle sums. LayerNorm parameters stay f32; the
//     math is f32 throughout.
//   - Each warp keeps its own copy of the 64-wide activations (registers
//     and a private shared-memory row), so layer norms and residuals take
//     warp shuffles and no block barrier: one block barrier gathers each
//     matvec's outputs, one the combined attention: 6 a step (8 in BIWI).
//   - The step's rows from device memory (the PPE row, the cross row or
//     BIWI's four latent rows) are prefetched one step ahead by cp.async.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace cg = cooperative_groups;

namespace {

constexpr int D = 64, NH = 4, HD = 16, FF = 128;
constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;  // 2 warps per head in the walk
constexpr int MAX_CLUSTER = 16;
constexpr float NEG = -1e30f;
constexpr int ROW_BYTES = 2 * D * 4;  // one cache row: k | v in f32

// packed weights in the storage type: matrices (out, in) row-major, then
// their biases; all offsets are multiples of 64 elements (16-byte aligned)
constexpr int WQKV = 0;                 // (192, 64): q | k | v outputs
constexpr int BQKV = WQKV + 3 * D * D;  // (192,)
constexpr int WO = BQKV + 3 * D;        // (64, 64)
constexpr int BO = WO + D * D;
constexpr int W1 = BO + D;              // (128, 64)
constexpr int B1 = W1 + FF * D;
constexpr int W2 = B1 + FF;             // (64, 128)
constexpr int B2 = W2 + D * FF;
constexpr int WFB = B2 + D;             // (64, 64)
constexpr int BFB = WFB + D * D;
constexpr int N_WEIGHTS_VOCASET = BFB + D;
// the BIWI variant's buffer continues with its cross-attention projections
constexpr int WCQ = N_WEIGHTS_VOCASET;  // (64, 64)
constexpr int BCQ = WCQ + D * D;
constexpr int WCO = BCQ + D;            // (64, 64)
constexpr int BCO = WCO + D * D;
constexpr int N_WEIGHTS_BIWI = BCO + D;
// f32 layer-norm parameters
constexpr int LN1S = 0, LN1B = D, LN2S = 2 * D, LN2B = 3 * D, LN3S = 4 * D, LN3B = 5 * D;
constexpr int N_LN = 6 * D;
constexpr int PART = 2 + HD;  // (max, sum, value sum[16]) per warp

// f32 scratch after the weights and the layer-norm parameters
constexpr int S_Q = 0;                     // q / 4
constexpr int S_ATTN = S_Q + D;            // combined attention output
constexpr int S_STY = S_ATTN + D;          // style
constexpr int S_Y0 = S_STY + D;            // matvec outputs, two buffers in turn
constexpr int S_Y1 = S_Y0 + FF;
constexpr int S_PV = S_Y1 + FF;            // each warp's own 64-wide input row
constexpr int S_XBAR = S_PV + NWARPS * D;  // two mbarriers (8 bytes each): the partials' arrival
// the step's rows from device memory, prefetched a step ahead:
// [parity][pe row | cross row] (vocaset) or [parity][pe row | k rows
// 2t, 2t+1 | v rows 2t, 2t+1] (BIWI)
constexpr int S_STEP = S_XBAR + 4;
constexpr int STEP_VOCASET = 2 * D, STEP_BIWI = 5 * D;
constexpr int SCRATCH_VOCASET = S_STEP + 2 * STEP_VOCASET;
constexpr int SCRATCH_BIWI = S_STEP + 2 * STEP_BIWI;
// after the scratch: every CTA's partials of the step, pushed there by
// their CTAs, [parity][rank][warp][PART]; then the cache rows
constexpr int GATHER_FLOATS = 2 * NWARPS * PART;  // a CTA's share, both parities

__host__ __device__ constexpr int n_weights(bool biwi) {
  return biwi ? N_WEIGHTS_BIWI : N_WEIGHTS_VOCASET;
}

// shared memory a CTA of a cluster of `cl` needs besides its cache rows
__host__ __device__ constexpr int fixed_bytes(bool biwi, int weight_bytes, int cl) {
  return n_weights(biwi) * weight_bytes + N_LN * 4 +
         ((biwi ? SCRATCH_BIWI : SCRATCH_VOCASET) + cl * GATHER_FLOATS) * 4;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the warp's sums of v[0..15] by a reduce-scatter (16 shuffles, not 80):
// on return v[0] of lane l holds the sum of value l / 2
__device__ __forceinline__ void warp_reduce_scatter16(float (&v)[16], int lane) {
#pragma unroll
  for (int half = 8, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// a 16-byte chunk of weights as f32: 8 bf16 or 4 f32 values
template <typename W>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void unpack(uint4 r, float (&w)[8]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[2 * i] = __uint_as_float(u[i] << 16);
      w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void unpack(uint4 r, float (&w)[4]) {
    w[0] = __uint_as_float(r.x);
    w[1] = __uint_as_float(r.y);
    w[2] = __uint_as_float(r.z);
    w[3] = __uint_as_float(r.w);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// y = x W + b for the K-wide shared-memory row x, W stored (N, K). Output n
// = 32 p + 4 warp + lane / 8 is summed by the 8 lanes of its group, lane s
// taking 16-byte chunks s, s + 8, ... of its row (contiguous 128 B for the 8
// lanes); store(n, y_n) runs on the group's first lane.
template <typename W, int K, int N, typename Store>
__device__ __forceinline__ void matvec(const W* wt, const W* bias, const float* x, int warp,
                                       int lane, Store store) {
  using CK = Chunk<W>;
  constexpr int E = CK::E, PER = K / E / 8, PASSES = N / 32;
  const int g = lane >> 3, s = lane & 7;
  float acc[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int n = 32 * p + 4 * warp + g;
    const uint4* row = reinterpret_cast<const uint4*>(wt + n * K);
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = s + 8 * j;
      float w[E];
      CK::unpack(row[c], w);
      const float4* xv = reinterpret_cast<const float4*>(x + c * E);
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        const float4 xx = xv[i];
        a = fmaf(xx.x, w[4 * i], a);
        a = fmaf(xx.y, w[4 * i + 1], a);
        a = fmaf(xx.z, w[4 * i + 2], a);
        a = fmaf(xx.w, w[4 * i + 3], a);
      }
    }
    acc[p] = a;
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], 1);
    acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], 2);
    acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], 4);
  }
  if (s == 0) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int n = 32 * p + 4 * warp + g;
      store(n, acc[p] + to_f32(bias[n]));
    }
  }
}

// in-register layer norm of the 64 values a warp holds (lane: a = v[lane],
// b = v[lane + 32]); shuffles only, the sum and the sum of squares in one
// butterfly
__device__ __forceinline__ void warp_layer_norm(float& a, float& b, const float* scale,
                                                const float* bias, int lane) {
  float s1 = a + b, s2 = a * a + b * b;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s1 * (1.f / D);
  const float var = fmaxf(s2 * (1.f / D) - mean * mean, 0.f);
  const float da = a - mean, db = b - mean;
  const float r = rsqrtf(var + 1e-5f);
  a = da * r * scale[lane] + bias[lane];
  b = db * r * scale[lane + 32] + bias[lane + 32];
}

// the warp's own copy of a 64-wide row, for the next matvec to read
__device__ __forceinline__ void put_row(float* pv, float a, float b, int lane) {
  __syncwarp();  // the warp's reads of the previous row are done
  pv[lane] = a;
  pv[lane + 32] = b;
  __syncwarp();
}

// the address of shared-memory address `addr` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 8 bytes into (possibly another CTA's) shared memory, completing on that
// CTA's mbarrier `bar`
__device__ __forceinline__ void st_async_v2(uint32_t addr, float2 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               ::"r"(addr), "f"(v.x), "f"(v.y), "r"(bar)
               : "memory");
}

// wait for phase `parity` of this CTA's mbarrier, whose bytes other CTAs
// wrote; a phase that never completes (a lost partial) traps the launch
// rather than hanging the card
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// cache row li of this CTA: per head 16 floats of k (region K) and of v
// (region V), [head][li][16]; 16-byte chunk c sits at c ^ ((li >> 1) & 3),
// so the 8 consecutive rows of a load phase hit 8 distinct bank groups
__device__ __forceinline__ int cache_index(int head, int li, int e, int rows_cta) {
  const int c = (e >> 2) ^ ((li >> 1) & 3);
  return (head * rows_cta + li) * HD + 4 * c + (e & 3);
}

// vocaset: cross is (B, T, 64) and mem_v unused; BIWI: cross is mem_k and
// mem_v its values, both (B, 2T, 64). Grid: CL CTAs a batch item, one
// cluster each.
template <bool BIWI, typename W>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_cluster_kernel(const float* __restrict__ cross, const float* __restrict__ mem_v,
                      const float* __restrict__ style, const float* __restrict__ pe,
                      const W* __restrict__ weights, const float* __restrict__ ln_params,
                      const float* __restrict__ slopes, float* __restrict__ kv,
                      float* __restrict__ out, int n_steps, int period, int rows_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cl;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  W* w = reinterpret_cast<W*>(smem_raw);
  float* ln = reinterpret_cast<float*>(smem_raw + n_weights(BIWI) * sizeof(W));
  float* sc = ln + N_LN;
  float* gather = sc + (BIWI ? SCRATCH_BIWI : SCRATCH_VOCASET);
  float* kc = gather + cl * GATHER_FLOATS;  // cache rows: K region
  float* vc = kc + NH * rows_cta * HD;      // V region
  float* pv = sc + S_PV + warp * D;
  const uint32_t xbar = smem_u32(sc + S_XBAR);  // + 8 parity

  {
    const uint4* src = reinterpret_cast<const uint4*>(weights);
    uint4* dst = reinterpret_cast<uint4*>(w);
    for (int i = tid; i < n_weights(BIWI) * (int)sizeof(W) / 16; i += NTHREADS) dst[i] = src[i];
    for (int i = tid; i < N_LN; i += NTHREADS) ln[i] = ln_params[i];
  }
  const float* sty = style + (size_t)b * D;
  if (tid < D) sc[S_STY + tid] = sty[tid];
  // vocaset reads a cross row a step, BIWI 2 * D floats of mem_k and of mem_v
  const float* crossb = cross + (size_t)b * n_steps * D * (BIWI ? 2 : 1);
  const float* memvb = BIWI ? mem_v + (size_t)b * n_steps * 2 * D : nullptr;
  float* kvb = kv + (size_t)b * n_steps * 2 * D;
  float* outb = out + (size_t)b * n_steps * D;
  const int head = warp / 2, stream = (warp % 2) * 32 + lane;  // the walk's head and row stream
  const float slope = slopes[head];
  constexpr int STEP = BIWI ? STEP_BIWI : STEP_VOCASET;

  // step t's rows into parity t & 1 by cp.async, one 16-byte copy a thread:
  // pe row, then the cross row (vocaset) or rows {2t, 2t+1} of mem_k, mem_v
  auto fetch_step = [&](int t) {
    if (tid < STEP / 4) {
      const float* src;
      if (tid < D / 4)
        src = pe + (t % period) * D + 4 * tid;
      else if (!BIWI)
        src = crossb + (size_t)t * D + 4 * (tid - D / 4);
      else if (tid < 3 * D / 4)
        src = crossb + (size_t)t * 2 * D + 4 * (tid - D / 4);
      else
        src = memvb + (size_t)t * 2 * D + 4 * (tid - 3 * D / 4);
      cp_async16(smem_u32(sc + S_STEP + (t & 1) * STEP + 4 * tid), src, true);
    }
    cp_async_commit();
  };
  fetch_step(0);
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 8, 1);
    fence_mbarrier_init();
  }
  cp_async_wait<0>();
  cluster_barrier();  // every CTA's mbarriers exist before any partial arrives

  float emb_a = sty[lane], emb_b = sty[lane + 32];
  for (int t = 0; t < n_steps; ++t) {
    const float* step = sc + S_STEP + (t & 1) * STEP;  // waited for and made visible last step
    const float xa = emb_a + step[lane], xb = emb_b + step[lane + 32];
    if (t + 1 < n_steps) fetch_step(t + 1);
    // this step's partials: CL CTAs x 8 warps x PART floats
    if (tid == 0) mbar_expect_tx(xbar + 8 * (t & 1), cl * NWARPS * PART * 4);
    put_row(pv, xa, xb, lane);

    // q | k | v; the owner of row t stores its k and v
    const bool owner = t % cl == rank;
    const int li_t = t / cl;
    matvec<W, D, 3 * D>(w + WQKV, w + BQKV, pv, warp, lane, [&](int n, float y) {
      if (n < D) {
        sc[S_Q + n] = y * 0.25f;  // 1 / sqrt(16), exact
      } else if (owner) {
        const int e = n - D;  // k: e < 64, v: e >= 64
        if (li_t < rows_cta)
          (e < D ? kc : vc)[cache_index((e % D) / HD, li_t, e % HD, rows_cta)] = y;
        else
          kvb[(size_t)t * 2 * D + e] = y;
      }
    });
    __syncthreads();

    // this CTA's rows j = rank + cl li <= t, for head `head`, row stream
    // `stream` of 64; online softmax in registers
    {
      float q[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) q[d] = sc[S_Q + head * HD + d];
      const int n_local = t >= rank ? (t - rank) / cl + 1 : 0;
      float m = NEG, l = 0.f, acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll 2
      for (int li = stream; li < n_local; li += 64) {
        const int j = rank + li * cl;
        float4 kk[4], vv[4];
        if (li < rows_cta) {
          const float4* kr = reinterpret_cast<const float4*>(kc + (head * rows_cta + li) * HD);
          const float4* vr = reinterpret_cast<const float4*>(vc + (head * rows_cta + li) * HD);
          const int sw = (li >> 1) & 3;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            kk[c] = kr[c ^ sw];
            vv[c] = vr[c ^ sw];
          }
        } else {
          const float4* kr = reinterpret_cast<const float4*>(kvb + (size_t)j * 2 * D + head * HD);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            kk[c] = kr[c];
            vv[c] = kr[D / 4 + c];
          }
        }
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s += q[4 * c] * kk[c].x + q[4 * c + 1] * kk[c].y + q[4 * c + 2] * kk[c].z +
               q[4 * c + 3] * kk[c].w;
        s -= slope * (float)((t - j) / period);  // t - j >= 0: C division floors
        const float m_new = fmaxf(m, s);
        const float a = expf(m - m_new), p = expf(s - m_new);
        l = l * a + p;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[4 * c] = acc[4 * c] * a + p * vv[c].x;
          acc[4 * c + 1] = acc[4 * c + 1] * a + p * vv[c].y;
          acc[4 * c + 2] = acc[4 * c + 2] * a + p * vv[c].z;
          acc[4 * c + 3] = acc[4 * c + 3] * a + p * vv[c].w;
        }
        m = m_new;
      }
      // the warp's partial: rescale to the warp's max, then plain sums,
      // staged in the warp's row and pushed, 8 bytes a lane, into slot
      // (parity, rank, warp) of every CTA of the cluster
      const float mw = warp_max(m);
      const float a = expf(m - mw);
      l = warp_sum(l * a);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= a;
      warp_reduce_scatter16(acc, lane);
      __syncwarp();  // the warp's reads of its row (q | k | v) are done
      if (lane % 2 == 0) pv[2 + lane / 2] = acc[0];
      if (lane == 0) {
        pv[0] = mw;
        pv[1] = l;
      }
      __syncwarp();
      const uint32_t slot = smem_u32(gather + (((t & 1) * cl + rank) * NWARPS + warp) * PART);
      for (int i = lane; i < cl * (PART / 2); i += 32) {
        const int r = i / (PART / 2), c = i % (PART / 2);
        st_async_v2(map_rank(slot + 8 * c, r), reinterpret_cast<const float2*>(pv)[c],
                    map_rank(xbar + 8 * (t & 1), r));
      }
    }
    mbar_wait_cluster(xbar + 8 * (t & 1), (t >> 1) & 1);  // every CTA's partials are here

    // element e = tid / 4 of the attention output; the 4 threads of e take
    // ranks r = tid % 4 (mod 4) and both warps of e's head, then combine by
    // shuffles: the same order, so the same bits, in every CTA
    {
      const int e = tid >> 2, qq = tid & 3;
      constexpr int N_MINE = 2 * MAX_CLUSTER / 4;
      float pm[N_MINE], pl[N_MINE], pa[N_MINE];
#pragma unroll
      for (int i = 0; i < N_MINE; ++i) {
        const int r = qq + 4 * (i / 2);
        if (r < cl) {
          const float* rp = gather + (((t & 1) * cl + r) * NWARPS + 2 * (e / HD) + i % 2) * PART;
          pm[i] = rp[0];
          pl[i] = rp[1];
          pa[i] = rp[2 + e % HD];
        } else {
          pm[i] = NEG;
          pl[i] = pa[i] = 0.f;
        }
      }
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < N_MINE; ++i) mx = fmaxf(mx, pm[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float lsum = 0.f, asum = 0.f;
#pragma unroll
      for (int i = 0; i < N_MINE; ++i) {
        const float f = expf(pm[i] - mx);
        lsum = fmaf(pl[i], f, lsum);
        asum = fmaf(pa[i], f, asum);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      asum += __shfl_xor_sync(0xffffffffu, asum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      asum += __shfl_xor_sync(0xffffffffu, asum, 2);
      if (qq == 0) sc[S_ATTN + e] = asum / lsum;
    }
    __syncthreads();

    // h = LN1(x + W_o attn)
    matvec<W, D, D>(w + WO, w + BO, sc + S_ATTN, warp, lane,
                    [&](int n, float y) { sc[S_Y0 + n] = y; });
    __syncthreads();
    float ha = xa + sc[S_Y0 + lane], hb = xb + sc[S_Y0 + lane + 32];
    warp_layer_norm(ha, hb, ln + LN1S, ln + LN1B, lane);

    // h = LN2(h + ca_t)
    if constexpr (BIWI) {
      put_row(pv, ha, hb, lane);
      matvec<W, D, D>(w + WCQ, w + BCQ, pv, warp, lane,
                      [&](int n, float y) { sc[S_Y1 + n] = y * 0.25f; });  // 1 / sqrt(16)
      __syncthreads();
      // per head (16 lanes each for a and for b) two scores and a 2-way softmax
      const float* mem = sc + S_STEP + (t & 1) * STEP + D;  // k rows 2t, 2t+1 | v rows
      const float qa = sc[S_Y1 + lane], qb = sc[S_Y1 + lane + 32];
      float s0a = qa * mem[lane], s1a = qa * mem[D + lane];
      float s0b = qb * mem[lane + 32], s1b = qb * mem[D + lane + 32];
#pragma unroll
      for (int off = 1; off < HD; off *= 2) {
        s0a += __shfl_xor_sync(0xffffffffu, s0a, off);
        s1a += __shfl_xor_sync(0xffffffffu, s1a, off);
        s0b += __shfl_xor_sync(0xffffffffu, s0b, off);
        s1b += __shfl_xor_sync(0xffffffffu, s1b, off);
      }
      const float* mv = mem + 2 * D;
      float ca_a, ca_b;
      {
        const float mx = fmaxf(s0a, s1a), p0 = expf(s0a - mx), p1 = expf(s1a - mx);
        ca_a = (p0 * mv[lane] + p1 * mv[D + lane]) / (p0 + p1);
      }
      {
        const float mx = fmaxf(s0b, s1b), p0 = expf(s0b - mx), p1 = expf(s1b - mx);
        ca_b = (p0 * mv[lane + 32] + p1 * mv[D + lane + 32]) / (p0 + p1);
      }
      put_row(pv, ca_a, ca_b, lane);
      matvec<W, D, D>(w + WCO, w + BCO, pv, warp, lane,
                      [&](int n, float y) { sc[S_Y0 + n] = y; });
      __syncthreads();
      ha += sc[S_Y0 + lane];
      hb += sc[S_Y0 + lane + 32];
    } else {
      const float* cr = sc + S_STEP + (t & 1) * STEP + D;
      ha += cr[lane];
      hb += cr[lane + 32];
    }
    warp_layer_norm(ha, hb, ln + LN2S, ln + LN2B, lane);

    // h = LN3(h + W_2 relu(W_1 h))
    put_row(pv, ha, hb, lane);
    matvec<W, D, FF>(w + W1, w + B1, pv, warp, lane,
                     [&](int n, float y) { sc[S_Y1 + n] = fmaxf(y, 0.f); });
    __syncthreads();
    matvec<W, FF, D>(w + W2, w + B2, sc + S_Y1, warp, lane,
                     [&](int n, float y) { sc[S_Y0 + n] = y; });
    __syncthreads();
    ha += sc[S_Y0 + lane];
    hb += sc[S_Y0 + lane + 32];
    warp_layer_norm(ha, hb, ln + LN3S, ln + LN3B, lane);

    // emit h_t; emb_{t+1} = h W_fb + b_fb + style
    if (rank == 0 && warp == 0) {
      outb[(size_t)t * D + lane] = ha;
      outb[(size_t)t * D + lane + 32] = hb;
    }
    put_row(pv, ha, hb, lane);
    matvec<W, D, D>(w + WFB, w + BFB, pv, warp, lane,
                    [&](int n, float y) { sc[S_Y1 + n] = y + sc[S_STY + n]; });
    cp_async_wait<0>();  // step t + 1's rows: everyone's after the barrier
    __syncthreads();
    emb_a = sc[S_Y1 + lane];
    emb_b = sc[S_Y1 + lane + 32];
  }
  cluster_barrier();  // no CTA leaves while another may still write its partials
}

template <bool BIWI, typename W>
cudaError_t set_attributes(int smem) {
  auto kernel = decode_cluster_kernel<BIWI, W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool BIWI, typename W>
cudaLaunchConfig_t launch_config(int batch, int cl, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cl);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

// rows of cache a CTA holds: as many as fit, no more than its share of T
int rows_per_cta(bool biwi, int weight_bytes, int n_steps, int cl, int limit) {
  const int cap = (limit - fixed_bytes(biwi, weight_bytes, cl)) / ROW_BYTES;
  return cap < 0 ? -1 : (cap < (n_steps + cl - 1) / cl ? cap : (n_steps + cl - 1) / cl);
}

// the largest cluster size that keeps min(batch, 8) items resident at once
template <bool BIWI, typename W>
int plan(int batch, int n_steps, int* out) {
  const int limit = smem_limit();
  for (int cl = MAX_CLUSTER; cl >= 1; cl /= 2) {
    const int rows = rows_per_cta(BIWI, sizeof(W), n_steps, cl, limit);
    if (rows < 0) return cudaErrorInvalidValue;
    const int smem = fixed_bytes(BIWI, sizeof(W), cl) + rows * ROW_BYTES;
    cudaError_t err = set_attributes<BIWI, W>(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config<BIWI, W>(batch, cl, smem, nullptr, attr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, decode_cluster_kernel<BIWI, W>, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();  // a refused size: try the next smaller one
      continue;
    }
    if (active >= (batch < 8 ? batch : 8) || cl == 1) {
      out[0] = cl;
      out[1] = rows;
      out[2] = smem;
      out[3] = active;
      out[4] = limit;
      return active > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
    }
  }
  return cudaErrorInvalidConfiguration;
}

template <bool BIWI, typename W>
int launch(const float* cross, const float* mem_v, const float* style, const float* pe,
           const void* weights, const float* ln, const float* slopes, float* kv, float* out,
           int batch, int n_steps, int period, int cl, int rows_cta, void* stream) {
  if (cl < 1 || cl > MAX_CLUSTER || (cl & (cl - 1)) || rows_cta < 0 || n_steps < 1)
    return cudaErrorInvalidValue;
  const int smem = fixed_bytes(BIWI, sizeof(W), cl) + rows_cta * ROW_BYTES;
  cudaError_t err = set_attributes<BIWI, W>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      launch_config<BIWI, W>(batch, cl, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<BIWI, W>, cross, mem_v, style, pe,
                           static_cast<const W*>(weights), ln, slopes, kv, out, n_steps, period,
                           rows_cta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// layout[0] = packed weights (elements), layout[1] = shared bytes a CTA
// of a cluster of `cluster` needs besides its cache rows, layout[2] = bytes
// of one cache row
extern "C" int a2f_decode_layout(int biwi, int bf16, int cluster, int* layout) {
  layout[0] = n_weights(biwi);
  layout[1] = fixed_bytes(biwi, bf16 ? 2 : 4, cluster);
  layout[2] = ROW_BYTES;
  return 0;
}

// plan[0] = cluster size CL, plan[1] = cache rows a CTA holds, plan[2] =
// shared bytes a CTA, plan[3] = clusters resident at once
// (cudaOccupancyMaxActiveClusters), plan[4] = shared bytes a block may use
extern "C" int a2f_decode_plan(int biwi, int bf16, int batch, int n_steps, int* plan_out) {
  if (biwi)
    return bf16 ? plan<true, __nv_bfloat16>(batch, n_steps, plan_out)
                : plan<true, float>(batch, n_steps, plan_out);
  return bf16 ? plan<false, __nv_bfloat16>(batch, n_steps, plan_out)
              : plan<false, float>(batch, n_steps, plan_out);
}

// cross: (B, T, 64) f32; style: (B, 64) f32; pe: (period, 64) f32;
// weights: the packed buffer above, bf16 if `bf16` else f32; ln: (6, 64)
// f32; slopes: (4,) f32; kv: (B, T, 128) f32 for the rows past a CTA's
// shared memory; out: (B, T, 64) f32. cluster and rows_cta from
// a2f_decode_plan.
extern "C" int a2f_decode_loop(const float* cross, const float* style, const float* pe,
                               const void* weights, const float* ln, const float* slopes,
                               float* kv, float* out, int batch, int n_steps, int period,
                               int bf16, int cluster, int rows_cta, void* stream) {
  return bf16 ? launch<false, __nv_bfloat16>(cross, nullptr, style, pe, weights, ln, slopes, kv,
                                             out, batch, n_steps, period, cluster, rows_cta, stream)
              : launch<false, float>(cross, nullptr, style, pe, weights, ln, slopes, kv, out,
                                     batch, n_steps, period, cluster, rows_cta, stream);
}

// BIWI: mem_k, mem_v: (B, 2T, 64) f32, columns head * 16 + i; weights: the
// packed buffer with W_cq, b_cq, W_co, b_co appended; the rest as above.
extern "C" int a2f_decode_loop_biwi(const float* mem_k, const float* mem_v, const float* style,
                                    const float* pe, const void* weights, const float* ln,
                                    const float* slopes, float* kv, float* out, int batch,
                                    int n_steps, int period, int bf16, int cluster, int rows_cta,
                                    void* stream) {
  return bf16 ? launch<true, __nv_bfloat16>(mem_k, mem_v, style, pe, weights, ln, slopes, kv, out,
                                            batch, n_steps, period, cluster, rows_cta, stream)
              : launch<true, float>(mem_k, mem_v, style, pe, weights, ln, slopes, kv, out, batch,
                                    n_steps, period, cluster, rows_cta, stream);
}

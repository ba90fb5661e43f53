// FaceFormer autoregressive decode loop for Hopper (sm_90a).
//
// Replaces the TPU kernel audio2face_tpu/ops/decode_kernel.py
// faceformer_decode_loop (_decode_kernel), both variants: the whole
// T-step loop in one launch. Each step t, for one batch item, at decoder
// width D (4 heads of HD = D / 4, FFN FF = 2 D):
//
//   x_t   = emb_t + PPE[t mod period]
//   attn  = softmax_{j<=t}(q_t . k_j / sqrt(HD) - slope_h * ((t-j) // period)) v_j
//   h     = LN1(x_t + W_o attn)
//   h     = LN2(h + ca_t)
//   h     = LN3(h + W_2 relu(W_1 h))
//   emb_{t+1} = h @ (W_r W_m) + b + style
//
// vocaset: ca_t = cross_t, the hoisted diagonal cross term. BIWI (template
// parameter): a true 2-way softmax per head over the audio latents
// {2t, 2t+1}, whose key/value projections mem_k, mem_v (2T, D) are read
// from device memory, 2 x 2D floats a step:
//
//   qc    = h W_cq + b_cq
//   ca_t  = (softmax_{j in {2t,2t+1}}(qc . mem_k_j / sqrt(HD)) mem_v_j) W_co + b_co
//
// Widths: D = 64 (the repo's FaceFormer) and D = 128 (FaceFormer's
// published BIWI decoder, feature_dim 128). The TPU kernel packs 8 items on
// lanes with block-diagonal weights; that packing exists for its layout and
// is not ported.
//
// Bound: the steps are a chain of dependent D-wide matvecs, so latency
// bounds the dense part; the attention reads the KV cache rows [0, t]
// every step (sum_t 8 D t bytes, 3.3 GB per item at D = 64, T = 3600).
// Design: one thread-block cluster of CL CTAs (CL chosen by the host from
// the occupancy of clusters, up to 16) per batch item.
//   - Cache row j (f32 k | v, 8 D bytes) belongs to CTA j mod CL and lives
//     in its shared memory, up to the rows a CTA has room for; later rows
//     stay in the caller's (B, T, 2D) device buffer and their owner reads
//     them, so any T runs. Only the owner ever reads a row.
//   - Each CTA walks its own rows for the 4 heads, and each warp pushes its
//     (max, sum, HD-wide value sum) by st.async into its slot in every CTA
//     of the cluster (double-buffered by the parity of t), completing on
//     that CTA's mbarrier. So the attention's cluster-wide synchronisation
//     is each CTA waiting for its own barrier: no barrier.cluster and no
//     remote load a step (faster on an H100 than one barrier.cluster a step
//     and a distributed-shared-memory gather: 20.7 against 23.0 ms at
//     (8, 3600)). Every CTA then combines the CL x 8 partials in one fixed
//     order.
//   - Where the weights live depends on D (`home_of`). The packed weights
//     are 11 D^2 + 10 D elements (BIWI): 91 KB in bf16 at D = 64, 363 KB at
//     D = 128, more than the 227 KB a block may use.
//     D = 64 (HOME_SMEM): every CTA holds all of them in shared memory and
//     runs the step's dense chain itself from the same inputs with the same
//     code, so all hold the same bits; only the attention partials cross
//     SMs.
//     D = 128 (HOME_SPLIT): CTA r holds rows [r N / CL, (r + 1) N / CL) of
//     each N-output matrix (and every bias) and computes those outputs
//     only; the 8 lanes that summed an output push it by st.async into
//     every CTA's copy of the matvec's result (double-buffered by the
//     parity of t), completing on that CTA's mbarrier for the exchange:
//     q | k | v (q to every CTA, k | v to the owner of row t alone), W_o,
//     W_cq and W_co (BIWI), W_1, W_2, W_fb. The layer norms, residuals and
//     the cross softmax run in every CTA on the same bits. (The other home
//     tried, every CTA reading whole matrices from device memory, served
//     by L2, each step, was slower; PERF.md has both step times.)
//   - Weights are stored in the caller's storage type (bf16 for the bf16
//     predictor, exact, half the bytes of f32), matrices stored (out, in),
//     so that 8 lanes split each output's reduction with 16-byte loads and
//     shuffle sums. LayerNorm parameters stay f32; the math is f32
//     throughout.
//   - Each warp keeps its own copy of the D-wide activations (registers and
//     a private shared-memory row), so layer norms and residuals take warp
//     shuffles and no block barrier: in HOME_SMEM one block barrier gathers
//     each matvec's outputs, one the combined attention: 6 a step (8 in
//     BIWI); in HOME_SPLIT each exchange's mbarrier takes a matvec's.
//   - The step's rows from device memory (the PPE row, the cross row or
//     BIWI's four latent rows) are prefetched one step ahead by cp.async.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait, mbarriers

namespace cg = cooperative_groups;

namespace {

constexpr int NH = 4;
constexpr int NTHREADS = 256, NWARPS = NTHREADS / 32;  // 2 warps per head in the walk
constexpr int MAX_CLUSTER = 16;
constexpr float NEG = -1e30f;

// where a CTA keeps the decoder's weights (the note above)
constexpr int HOME_SMEM = 0, HOME_SPLIT = 1;
__host__ __device__ constexpr int home_of(int d) { return d == 64 ? HOME_SMEM : HOME_SPLIT; }

// the offsets (in elements or floats) of the decoder of width D
template <int D>
struct Layout {
  static constexpr int HD = D / NH, FF = 2 * D;
  static constexpr int V = D / 32;             // values of a D-wide row a lane holds
  static constexpr int ROW_BYTES = 2 * D * 4;  // one cache row: k | v in f32
  // packed weights in the storage type: matrices (out, in) row-major, then
  // their biases; all offsets are multiples of 64 elements (16-byte aligned)
  static constexpr int WQKV = 0;                 // (3D, D): q | k | v outputs
  static constexpr int BQKV = WQKV + 3 * D * D;  // (3D,)
  static constexpr int WO = BQKV + 3 * D;        // (D, D)
  static constexpr int BO = WO + D * D;
  static constexpr int W1 = BO + D;  // (FF, D)
  static constexpr int B1 = W1 + FF * D;
  static constexpr int W2 = B1 + FF;  // (D, FF)
  static constexpr int B2 = W2 + D * FF;
  static constexpr int WFB = B2 + D;  // (D, D)
  static constexpr int BFB = WFB + D * D;
  static constexpr int N_WEIGHTS_VOCASET = BFB + D;
  // the BIWI variant's buffer continues with its cross-attention projections
  static constexpr int WCQ = N_WEIGHTS_VOCASET;  // (D, D)
  static constexpr int BCQ = WCQ + D * D;
  static constexpr int WCO = BCQ + D;  // (D, D)
  static constexpr int BCO = WCO + D * D;
  static constexpr int N_WEIGHTS_BIWI = BCO + D;
  // HOME_SPLIT: a CTA's rows of every matrix (q|k|v, o, f1, f2, fb, cq,
  // co), 1 / CL of each, then every bias in that order
  static constexpr int N_MATRIX_VOCASET = 3 * D * D + D * D + FF * D + D * FF + D * D;
  static constexpr int N_MATRIX_BIWI = N_MATRIX_VOCASET + 2 * D * D;
  static constexpr int N_BIAS_VOCASET = 3 * D + D + FF + D + D;
  static constexpr int N_BIAS_BIWI = N_BIAS_VOCASET + 2 * D;
  // f32 layer-norm parameters
  static constexpr int LN1S = 0, LN1B = D, LN2S = 2 * D, LN2B = 3 * D, LN3S = 4 * D, LN3B = 5 * D;
  static constexpr int N_LN = 6 * D;
  static constexpr int PART = 2 + HD;  // (max, sum, value sum[HD]) per warp
  // f32 scratch after the weights and the layer-norm parameters
  static constexpr int S_Q = 0;                     // q / sqrt(HD)
  static constexpr int S_ATTN = S_Q + D;            // combined attention output
  static constexpr int S_STY = S_ATTN + D;          // style
  static constexpr int S_Y0 = S_STY + D;            // matvec outputs, two buffers in turn
  static constexpr int S_Y1 = S_Y0 + FF;
  static constexpr int S_PV = S_Y1 + FF;            // each warp's own D-wide input row
  static constexpr int S_XBAR = S_PV + NWARPS * D;  // two mbarriers (8 bytes each): the partials' arrival
  // the step's rows from device memory, prefetched a step ahead:
  // [parity][pe row | cross row] (vocaset) or [parity][pe row | k rows
  // 2t, 2t+1 | v rows 2t, 2t+1] (BIWI)
  static constexpr int S_STEP = S_XBAR + 4;
  static constexpr int STEP_VOCASET = 2 * D, STEP_BIWI = 5 * D;
  static constexpr int SCRATCH_VOCASET = S_STEP + 2 * STEP_VOCASET;
  static constexpr int SCRATCH_BIWI = S_STEP + 2 * STEP_BIWI;
  // HOME_SPLIT, after the scratch: the exchanges' mbarriers (7 exchanges x
  // 2 parities x 8 bytes, to a 16-byte boundary), then each parity's copy
  // of every matvec's result
  static constexpr int X_QKV = 0;
  static constexpr int X_O = X_QKV + 3 * D;
  static constexpr int X_CQ = X_O + D;
  static constexpr int X_CO = X_CQ + D;
  static constexpr int X_F1 = X_CO + D;
  static constexpr int X_F2 = X_F1 + FF;
  static constexpr int X_FB = X_F2 + D;
  static constexpr int X_FLOATS = X_FB + D;
  static constexpr int EX_BARS = 32;
  static constexpr int EXCHANGE_FLOATS = EX_BARS + 2 * X_FLOATS;
  // after the scratch (and the exchanges): every CTA's partials of the
  // step, pushed there by their CTAs, [parity][rank][warp][PART]; then the
  // cache rows
  static constexpr int GATHER_FLOATS = 2 * NWARPS * PART;  // a CTA's share, both parities
};

// the exchanges of HOME_SPLIT, in a step's order
constexpr int EX_QKV = 0, EX_O = 1, EX_CQ = 2, EX_CO = 3, EX_F1 = 4, EX_F2 = 5, EX_FB = 6;

// weight elements a CTA of a cluster of `cl` holds in shared memory
template <int D>
__host__ __device__ constexpr int smem_weights(bool biwi, int cl) {
  using L = Layout<D>;
  return home_of(D) == HOME_SMEM ? (biwi ? L::N_WEIGHTS_BIWI : L::N_WEIGHTS_VOCASET)
                                 : (biwi ? L::N_MATRIX_BIWI : L::N_MATRIX_VOCASET) / cl +
                                       (biwi ? L::N_BIAS_BIWI : L::N_BIAS_VOCASET);
}

// shared memory a CTA of a cluster of `cl` needs besides its cache rows
template <int D>
__host__ __device__ constexpr int fixed_bytes(bool biwi, int weight_bytes, int cl) {
  using L = Layout<D>;
  return smem_weights<D>(biwi, cl) * weight_bytes + L::N_LN * 4 +
         ((biwi ? L::SCRATCH_BIWI : L::SCRATCH_VOCASET) +
          (home_of(D) == HOME_SPLIT ? L::EXCHANGE_FLOATS : 0) + cl * L::GATHER_FLOATS) *
             4;
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

// the warp's sums of v[0..N-1] by a reduce-scatter (N = 16: 16 shuffles,
// not 80): on return v[0] of lane l holds the sum of value l / (32 / N)
template <int N>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int half = N / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  if constexpr (N == 16) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
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

// lane s's part of the K-wide row x against weight row `row`: 16-byte
// chunks s, s + 8, ... (contiguous 128 B for the 8 lanes of a group)
template <typename W, int K>
__device__ __forceinline__ float row_part(const uint4* row, const float* x, int s) {
  using CK = Chunk<W>;
  constexpr int E = CK::E, PER = K / E / 8;
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
  return a;
}

// y = x W + b for the K-wide shared-memory row x, W stored (N, K). Output n
// = 32 p + 4 warp + lane / 8 is summed by the 8 lanes of its group;
// store(n, y_n) runs on the group's first lane.
template <typename W, int K, int N, typename Store>
__device__ __forceinline__ void matvec(const W* wt, const W* bias, const float* x, int warp,
                                       int lane, Store store) {
  constexpr int PASSES = N / 32;
  const int g = lane >> 3, s = lane & 7;
  float acc[PASSES];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int n = 32 * p + 4 * warp + g;
    acc[p] = row_part<W, K>(reinterpret_cast<const uint4*>(wt + n * K), x, s);
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

// HOME_SPLIT: rows [0, rows) of the (rows, K) matrix wt against x, 8 lanes
// a row (rows % 4 == 0, so whole warps take part in each round); the
// butterfly leaves the row's sum, the same bits, on all 8 lanes, and
// emit(r, sum, s) runs on each of them
template <typename W, int K, typename Emit>
__device__ __forceinline__ void matvec_rows(const W* wt, const float* x, int rows, int warp,
                                            int lane, Emit emit) {
  const int g = lane >> 3, s = lane & 7;
  for (int r = 4 * warp + g; r < rows; r += 4 * NWARPS) {
    float a = row_part<W, K>(reinterpret_cast<const uint4*>(wt + (size_t)r * K), x, s);
    a += __shfl_xor_sync(0xffffffffu, a, 1);
    a += __shfl_xor_sync(0xffffffffu, a, 2);
    a += __shfl_xor_sync(0xffffffffu, a, 4);
    emit(r, a, s);
  }
}

// in-register layer norm of the D = 32 V values a warp holds (lane: v[i] =
// row[lane + 32 i]); shuffles only, the sum and the sum of squares in one
// butterfly
template <int V>
__device__ __forceinline__ void warp_layer_norm(float (&v)[V], const float* scale,
                                                const float* bias, int lane) {
  float s1 = v[0], s2 = v[0] * v[0];
#pragma unroll
  for (int i = 1; i < V; ++i) {
    s1 += v[i];
    s2 += v[i] * v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  constexpr float INV_D = 1.f / (32 * V);
  const float mean = s1 * INV_D;
  const float var = fmaxf(s2 * INV_D - mean * mean, 0.f);
  const float r = rsqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = (v[i] - mean) * r * scale[lane + 32 * i] + bias[lane + 32 * i];
}

// the warp's own copy of a D-wide row, for the next matvec to read
template <int V>
__device__ __forceinline__ void put_row(float* pv, const float (&v)[V], int lane) {
  __syncwarp();  // the warp's reads of the previous row are done
#pragma unroll
  for (int i = 0; i < V; ++i) pv[lane + 32 * i] = v[i];
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

// 4 bytes, the same way
__device__ __forceinline__ void st_async_b32(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
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

// the 16-byte chunk of a cache row that lands first: HD = 16 (64 B rows)
// swizzles by (li >> 1) & 3, HD = 32 (128 B rows) by li & 7, so the 8
// consecutive rows of a load phase hit 8 distinct bank groups
template <int HD>
__device__ __forceinline__ int row_swizzle(int li) {
  return HD == 16 ? (li >> 1) & 3 : li & 7;
}

// cache row li of this CTA: per head HD floats of k (region K) and of v
// (region V), [head][li][HD]; 16-byte chunk c sits at c ^ row_swizzle(li)
template <int HD>
__device__ __forceinline__ int cache_index(int head, int li, int e, int rows_cta) {
  const int c = (e >> 2) ^ row_swizzle<HD>(li);
  return (head * rows_cta + li) * HD + 4 * c + (e & 3);
}

// vocaset: cross is (B, T, D) and mem_v unused; BIWI: cross is mem_k and
// mem_v its values, both (B, 2T, D). Grid: CL CTAs a batch item, one
// cluster each.
template <bool BIWI, typename W, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
decode_cluster_kernel(const float* __restrict__ cross, const float* __restrict__ mem_v,
                      const float* __restrict__ style, const float* __restrict__ pe,
                      const W* __restrict__ weights, const float* __restrict__ ln_params,
                      const float* __restrict__ slopes, float* __restrict__ kv,
                      float* __restrict__ out, int n_steps, int period, int rows_cta) {
  using L = Layout<D>;
  constexpr int HD = L::HD, FF = L::FF, V = L::V, PART = L::PART;
  constexpr bool SPLIT = home_of(D) == HOME_SPLIT;
  static_assert(HD == 16 || HD == 32, "widths 64 and 128");
  constexpr float SM_SCALE = HD == 16 ? 0.25f : 0.17677669529663688f;  // 1 / sqrt(HD)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cl;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  W* w = reinterpret_cast<W*>(smem_raw);
  float* ln = reinterpret_cast<float*>(smem_raw + smem_weights<D>(BIWI, cl) * sizeof(W));
  float* sc = ln + L::N_LN;
  float* ex = sc + (BIWI ? L::SCRATCH_BIWI : L::SCRATCH_VOCASET);  // HOME_SPLIT's exchanges
  float* gather = ex + (SPLIT ? L::EXCHANGE_FLOATS : 0);
  float* kc = gather + cl * L::GATHER_FLOATS;  // cache rows: K region
  float* vc = kc + NH * rows_cta * HD;         // V region
  float* pv = sc + L::S_PV + warp * D;
  const uint32_t xbar = smem_u32(sc + L::S_XBAR);  // + 8 parity
  const uint32_t exbar = smem_u32(ex);             // + 8 (2 exchange + parity)

  {
    const uint4* src = reinterpret_cast<const uint4*>(weights);
    uint4* dst = reinterpret_cast<uint4*>(w);
    if constexpr (!SPLIT) {
      for (int i = tid; i < smem_weights<D>(BIWI, 1) * (int)sizeof(W) / 16; i += NTHREADS)
        dst[i] = src[i];
    } else {
      // this CTA's rows of each matrix, then every bias: (packed weights,
      // packed bias, outputs, inputs) in the packed order
      constexpr int N_MATS = BIWI ? 7 : 5;
      const int mats[7][4] = {{L::WQKV, L::BQKV, 3 * D, D}, {L::WO, L::BO, D, D},
                              {L::W1, L::B1, FF, D},       {L::W2, L::B2, D, FF},
                              {L::WFB, L::BFB, D, D},      {L::WCQ, L::BCQ, D, D},
                              {L::WCO, L::BCO, D, D}};
      constexpr int PER16 = 16 / (int)sizeof(W);
      int lw = 0, lb = (BIWI ? L::N_MATRIX_BIWI : L::N_MATRIX_VOCASET) / cl;
#pragma unroll
      for (int m = 0; m < N_MATS; ++m) {
        const int rows = mats[m][2] / cl, n = rows * mats[m][3];
        const int from = mats[m][0] + rank * n;
        for (int i = tid; i < n / PER16; i += NTHREADS) dst[lw / PER16 + i] = src[from / PER16 + i];
        for (int i = tid; i < mats[m][2] / PER16; i += NTHREADS)
          dst[lb / PER16 + i] = src[mats[m][1] / PER16 + i];
        lw += n;
        lb += mats[m][2];
      }
    }
    for (int i = tid; i < L::N_LN; i += NTHREADS) ln[i] = ln_params[i];
  }
  // HOME_SPLIT: this CTA's rows of each matrix and every bias (see above)
  const int n_matrix = (BIWI ? L::N_MATRIX_BIWI : L::N_MATRIX_VOCASET) / cl;
  const W* w_qkv = w;
  const W* w_o = w_qkv + 3 * D * D / cl;
  const W* w_1 = w_o + D * D / cl;
  const W* w_2 = w_1 + FF * D / cl;
  const W* w_fb = w_2 + D * FF / cl;
  const W* w_cq = w_fb + D * D / cl;
  const W* w_co = w_cq + D * D / cl;
  const W* b_qkv = w + n_matrix;
  const W* b_o = b_qkv + 3 * D;
  const W* b_1 = b_o + D;
  const W* b_2 = b_1 + FF;
  const W* b_fb = b_2 + D;
  const W* b_cq = b_fb + D;
  const W* b_co = b_cq + D;

  const float* sty = style + (size_t)b * D;
  if (tid < D) sc[L::S_STY + tid] = sty[tid];
  // vocaset reads a cross row a step, BIWI 2 * D floats of mem_k and of mem_v
  const float* crossb = cross + (size_t)b * n_steps * D * (BIWI ? 2 : 1);
  const float* memvb = BIWI ? mem_v + (size_t)b * n_steps * 2 * D : nullptr;
  float* kvb = kv + (size_t)b * n_steps * 2 * D;
  float* outb = out + (size_t)b * n_steps * D;
  const int head = warp / 2, stream = (warp % 2) * 32 + lane;  // the walk's head and row stream
  const float slope = slopes[head];
  constexpr int STEP = BIWI ? L::STEP_BIWI : L::STEP_VOCASET;

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
      cp_async16(smem_u32(sc + L::S_STEP + (t & 1) * STEP + 4 * tid), src, true);
    }
    cp_async_commit();
  };
  fetch_step(0);
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 8, 1);
    if constexpr (SPLIT)
      for (int i = 0; i < 14; ++i) mbar_init(exbar + 8 * i, 1);
    fence_mbarrier_init();
  }
  cp_async_wait<0>();
  cluster_barrier();  // every CTA's mbarriers exist before any partial arrives

  float emb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) emb[i] = sty[lane + 32 * i];
  for (int t = 0; t < n_steps; ++t) {
    const int par = t & 1;
    const uint32_t phase = (t >> 1) & 1;  // each barrier completes once every other step
    const float* step = sc + L::S_STEP + par * STEP;  // waited for and made visible last step
    float x[V];
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = emb[i] + step[lane + 32 * i];
    if (t + 1 < n_steps) fetch_step(t + 1);
    // the owner of row t stores its k and v
    const int own = t % cl;
    const bool owner = own == rank;
    const int li_t = t / cl;
    auto store_kv = [&](int e, float y) {  // k: e < D, v: e >= D
      if (li_t < rows_cta)
        (e < D ? kc : vc)[cache_index<HD>((e % D) / HD, li_t, e % HD, rows_cta)] = y;
      else
        kvb[(size_t)t * 2 * D + e] = y;
    };
    // HOME_SPLIT: this parity's copies of the matvecs' results, and
    // exchange e's mbarrier
    float* xb = ex + L::EX_BARS + par * L::X_FLOATS;
    auto bar_of = [&](int e) { return exbar + 8 * (2 * e + par); };
    // rows [rank N / cl, ...) of an N-output matrix (this CTA's rows wl,
    // every bias bl) against x; post(n, y + b_n) pushed into slot n of
    // buffer `off` in every CTA; returns this CTA's copy once it is whole
    auto split_matvec = [&](auto k_inputs, const W* wl, const W* bl, int n_out, const float* xin,
                            int e, int off, auto post) -> const float* {
      constexpr int K = decltype(k_inputs)::value;
      const uint32_t buf = smem_u32(xb + off), bar = bar_of(e);
      const int n0 = rank * (n_out / cl);
      matvec_rows<W, K>(wl, xin, n_out / cl, warp, lane, [&](int r, float y, int s) {
        const int n = n0 + r;
        y = post(n, y + to_f32(bl[n]));
        for (int dst = s; dst < cl; dst += 8)
          st_async_b32(map_rank(buf + 4 * n, dst), y, map_rank(bar, dst));
      });
      mbar_wait_cluster(bar, phase);
      return xb + off;
    };
    using KD = std::integral_constant<int, D>;
    using KF = std::integral_constant<int, FF>;
    // this step's partials: CL CTAs x 8 warps x PART floats
    if (tid == 0) {
      mbar_expect_tx(xbar + 8 * par, cl * NWARPS * PART * 4);
      if constexpr (SPLIT) {
        mbar_expect_tx(bar_of(EX_QKV), (owner ? 3 * D : D) * 4);
        mbar_expect_tx(bar_of(EX_O), D * 4);
        if constexpr (BIWI) {
          mbar_expect_tx(bar_of(EX_CQ), D * 4);
          mbar_expect_tx(bar_of(EX_CO), D * 4);
        }
        mbar_expect_tx(bar_of(EX_F1), FF * 4);
        mbar_expect_tx(bar_of(EX_F2), D * 4);
        mbar_expect_tx(bar_of(EX_FB), D * 4);
      }
    }
    put_row<V>(pv, x, lane);

    // q | k | v
    const float* qs;  // q / sqrt(HD)
    if constexpr (!SPLIT) {
      matvec<W, D, 3 * D>(w + L::WQKV, w + L::BQKV, pv, warp, lane, [&](int n, float y) {
        if (n < D)
          sc[L::S_Q + n] = y * SM_SCALE;
        else if (owner)
          store_kv(n - D, y);
      });
      __syncthreads();
      qs = sc + L::S_Q;
    } else {
      // q to every CTA, k | v to the owner alone
      const uint32_t buf = smem_u32(xb + L::X_QKV), bar = bar_of(EX_QKV);
      const int n0 = rank * (3 * D / cl);
      matvec_rows<W, D>(w_qkv, pv, 3 * D / cl, warp, lane, [&](int r, float y, int s) {
        const int n = n0 + r;
        y += to_f32(b_qkv[n]);
        if (n < D) {
          for (int dst = s; dst < cl; dst += 8)
            st_async_b32(map_rank(buf + 4 * n, dst), y * SM_SCALE, map_rank(bar, dst));
        } else if (s == 0) {
          st_async_b32(map_rank(buf + 4 * n, own), y, map_rank(bar, own));
        }
      });
      mbar_wait_cluster(bar, phase);
      if (owner)
        for (int e = tid; e < 2 * D; e += NTHREADS) store_kv(e, xb[L::X_QKV + D + e]);
      __syncthreads();
      qs = xb + L::X_QKV;
    }

    // this CTA's rows j = rank + cl li <= t, for head `head`, row stream
    // `stream` of 64; online softmax in registers
    {
      float q[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) q[d] = qs[head * HD + d];
      const int n_local = t >= rank ? (t - rank) / cl + 1 : 0;
      float m = NEG, l = 0.f, acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.f;
      constexpr int WALK_UNROLL = HD == 16 ? 2 : 1;
#pragma unroll WALK_UNROLL
      for (int li = stream; li < n_local; li += 64) {
        const int j = rank + li * cl;
        float4 kk[HD / 4], vv[HD / 4];
        if (li < rows_cta) {
          const float4* kr = reinterpret_cast<const float4*>(kc + (head * rows_cta + li) * HD);
          const float4* vr = reinterpret_cast<const float4*>(vc + (head * rows_cta + li) * HD);
          const int sw = row_swizzle<HD>(li);
#pragma unroll
          for (int c = 0; c < HD / 4; ++c) {
            kk[c] = kr[c ^ sw];
            vv[c] = vr[c ^ sw];
          }
        } else {
          const float4* kr = reinterpret_cast<const float4*>(kvb + (size_t)j * 2 * D + head * HD);
#pragma unroll
          for (int c = 0; c < HD / 4; ++c) {
            kk[c] = kr[c];
            vv[c] = kr[D / 4 + c];
          }
        }
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < HD / 4; ++c)
          s += q[4 * c] * kk[c].x + q[4 * c + 1] * kk[c].y + q[4 * c + 2] * kk[c].z +
               q[4 * c + 3] * kk[c].w;
        s -= slope * (float)((t - j) / period);  // t - j >= 0: C division floors
        const float m_new = fmaxf(m, s);
        const float a = expf(m - m_new), p = expf(s - m_new);
        l = l * a + p;
#pragma unroll
        for (int c = 0; c < HD / 4; ++c) {
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
      warp_reduce_scatter<HD>(acc, lane);
      __syncwarp();  // the warp's reads of its row (q | k | v) are done
      if (lane % (32 / HD) == 0) pv[2 + lane / (32 / HD)] = acc[0];
      if (lane == 0) {
        pv[0] = mw;
        pv[1] = l;
      }
      __syncwarp();
      const uint32_t slot = smem_u32(gather + ((par * cl + rank) * NWARPS + warp) * PART);
      for (int i = lane; i < cl * (PART / 2); i += 32) {
        const int r = i / (PART / 2), c = i % (PART / 2);
        st_async_v2(map_rank(slot + 8 * c, r), reinterpret_cast<const float2*>(pv)[c],
                    map_rank(xbar + 8 * par, r));
      }
    }
    mbar_wait_cluster(xbar + 8 * par, phase);  // every CTA's partials are here

    // element e = tid / TPE of the attention output; the TPE threads of e
    // take ranks r = tid % TPE (mod TPE) and both warps of e's head, then
    // combine by shuffles: the same order, so the same bits, in every CTA
    {
      constexpr int TPE = NTHREADS / D;
      const int e = tid / TPE, qq = tid % TPE;
      constexpr int N_MINE = 2 * MAX_CLUSTER / TPE;
      float pm[N_MINE], pl[N_MINE], pa[N_MINE];
#pragma unroll
      for (int i = 0; i < N_MINE; ++i) {
        const int r = qq + TPE * (i / 2);
        if (r < cl) {
          const float* rp = gather + ((par * cl + r) * NWARPS + 2 * (e / HD) + i % 2) * PART;
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
#pragma unroll
      for (int off = 1; off < TPE; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float lsum = 0.f, asum = 0.f;
#pragma unroll
      for (int i = 0; i < N_MINE; ++i) {
        const float f = expf(pm[i] - mx);
        lsum = fmaf(pl[i], f, lsum);
        asum = fmaf(pa[i], f, asum);
      }
#pragma unroll
      for (int off = 1; off < TPE; off *= 2) {
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
        asum += __shfl_xor_sync(0xffffffffu, asum, off);
      }
      if (qq == 0) sc[L::S_ATTN + e] = asum / lsum;
    }
    __syncthreads();

    // h = LN1(x + W_o attn)
    const float* y;
    if constexpr (!SPLIT) {
      matvec<W, D, D>(w + L::WO, w + L::BO, sc + L::S_ATTN, warp, lane,
                      [&](int n, float v) { sc[L::S_Y0 + n] = v; });
      __syncthreads();
      y = sc + L::S_Y0;
    } else {
      y = split_matvec(KD{}, w_o, b_o, D, sc + L::S_ATTN, EX_O, L::X_O,
                       [](int, float v) { return v; });
    }
    float h[V];
#pragma unroll
    for (int i = 0; i < V; ++i) h[i] = x[i] + y[lane + 32 * i];
    warp_layer_norm<V>(h, ln + L::LN1S, ln + L::LN1B, lane);

    // h = LN2(h + ca_t)
    if constexpr (BIWI) {
      put_row<V>(pv, h, lane);
      const float* qc;  // qc / sqrt(HD)
      if constexpr (!SPLIT) {
        matvec<W, D, D>(w + L::WCQ, w + L::BCQ, pv, warp, lane,
                        [&](int n, float v) { sc[L::S_Y1 + n] = v * SM_SCALE; });
        __syncthreads();
        qc = sc + L::S_Y1;
      } else {
        qc = split_matvec(KD{}, w_cq, b_cq, D, pv, EX_CQ, L::X_CQ,
                          [](int, float v) { return v * SM_SCALE; });
      }
      // per head (HD lanes each for each value a lane holds) two scores and
      // a 2-way softmax
      const float* mem = step + D;  // k rows 2t, 2t+1 | v rows
      float s0[V], s1[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float qv = qc[lane + 32 * i];
        s0[i] = qv * mem[lane + 32 * i];
        s1[i] = qv * mem[D + lane + 32 * i];
      }
#pragma unroll
      for (int off = 1; off < HD; off *= 2) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s0[i] += __shfl_xor_sync(0xffffffffu, s0[i], off);
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
        }
      }
      const float* mv = mem + 2 * D;
      float ca[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float mx = fmaxf(s0[i], s1[i]), p0 = expf(s0[i] - mx), p1 = expf(s1[i] - mx);
        ca[i] = (p0 * mv[lane + 32 * i] + p1 * mv[D + lane + 32 * i]) / (p0 + p1);
      }
      put_row<V>(pv, ca, lane);
      if constexpr (!SPLIT) {
        matvec<W, D, D>(w + L::WCO, w + L::BCO, pv, warp, lane,
                        [&](int n, float v) { sc[L::S_Y0 + n] = v; });
        __syncthreads();
        y = sc + L::S_Y0;
      } else {
        y = split_matvec(KD{}, w_co, b_co, D, pv, EX_CO, L::X_CO, [](int, float v) { return v; });
      }
    } else {
      y = step + D;  // the cross row
    }
#pragma unroll
    for (int i = 0; i < V; ++i) h[i] += y[lane + 32 * i];
    warp_layer_norm<V>(h, ln + L::LN2S, ln + L::LN2B, lane);

    // h = LN3(h + W_2 relu(W_1 h))
    put_row<V>(pv, h, lane);
    if constexpr (!SPLIT) {
      matvec<W, D, FF>(w + L::W1, w + L::B1, pv, warp, lane,
                       [&](int n, float v) { sc[L::S_Y1 + n] = fmaxf(v, 0.f); });
      __syncthreads();
      matvec<W, FF, D>(w + L::W2, w + L::B2, sc + L::S_Y1, warp, lane,
                       [&](int n, float v) { sc[L::S_Y0 + n] = v; });
      __syncthreads();
      y = sc + L::S_Y0;
    } else {
      const float* f1 = split_matvec(KD{}, w_1, b_1, FF, pv, EX_F1, L::X_F1,
                                     [](int, float v) { return fmaxf(v, 0.f); });
      y = split_matvec(KF{}, w_2, b_2, D, f1, EX_F2, L::X_F2, [](int, float v) { return v; });
    }
#pragma unroll
    for (int i = 0; i < V; ++i) h[i] += y[lane + 32 * i];
    warp_layer_norm<V>(h, ln + L::LN3S, ln + L::LN3B, lane);

    // emit h_t; emb_{t+1} = h W_fb + b_fb + style
    if (rank == 0 && warp == 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) outb[(size_t)t * D + lane + 32 * i] = h[i];
    }
    put_row<V>(pv, h, lane);
    if constexpr (!SPLIT) {
      matvec<W, D, D>(w + L::WFB, w + L::BFB, pv, warp, lane,
                      [&](int n, float v) { sc[L::S_Y1 + n] = v + sc[L::S_STY + n]; });
      y = sc + L::S_Y1;
    } else {
      y = split_matvec(KD{}, w_fb, b_fb, D, pv, EX_FB, L::X_FB,
                       [&](int n, float v) { return v + sc[L::S_STY + n]; });
    }
    cp_async_wait<0>();  // step t + 1's rows: everyone's after the barrier
    __syncthreads();
#pragma unroll
    for (int i = 0; i < V; ++i) emb[i] = y[lane + 32 * i];
  }
  cluster_barrier();  // no CTA leaves while another may still write its partials
}

template <bool BIWI, typename W, int D>
cudaError_t set_attributes(int smem) {
  auto kernel = decode_cluster_kernel<BIWI, W, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

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
// (-1: the fixed part alone does not fit)
template <int D>
int rows_per_cta(bool biwi, int weight_bytes, int n_steps, int cl, int limit) {
  const int fixed = fixed_bytes<D>(biwi, weight_bytes, cl);
  if (fixed > limit) return -1;
  const int cap = (limit - fixed) / Layout<D>::ROW_BYTES, share = (n_steps + cl - 1) / cl;
  return cap < share ? cap : share;
}

// the largest cluster size that keeps min(batch, 8) items resident at once
template <bool BIWI, typename W, int D>
int plan(int batch, int n_steps, int* out) {
  const int limit = smem_limit();
  for (int cl = MAX_CLUSTER; cl >= 1; cl /= 2) {
    const int rows = rows_per_cta<D>(BIWI, sizeof(W), n_steps, cl, limit);
    if (rows < 0) return cudaErrorInvalidValue;
    const int smem = fixed_bytes<D>(BIWI, sizeof(W), cl) + rows * Layout<D>::ROW_BYTES;
    cudaError_t err = set_attributes<BIWI, W, D>(smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(batch, cl, smem, nullptr, attr);
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, decode_cluster_kernel<BIWI, W, D>, &cfg);
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

template <bool BIWI, typename W, int D>
int launch(const float* cross, const float* mem_v, const float* style, const float* pe,
           const void* weights, const float* ln, const float* slopes, float* kv, float* out,
           int batch, int n_steps, int period, int cl, int rows_cta, void* stream) {
  if (cl < 1 || cl > MAX_CLUSTER || (cl & (cl - 1)) || rows_cta < 0 || n_steps < 1)
    return cudaErrorInvalidValue;
  const int smem = fixed_bytes<D>(BIWI, sizeof(W), cl) + rows_cta * Layout<D>::ROW_BYTES;
  cudaError_t err = set_attributes<BIWI, W, D>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(batch, cl, smem, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<BIWI, W, D>, cross, mem_v, style, pe,
                           static_cast<const W*>(weights), ln, slopes, kv, out, n_steps, period,
                           rows_cta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiation for (biwi, bf16, width): fn<BIWI, W, D>(args...)
#define A2F_DISPATCH(fn, ...)                                                             \
  do {                                                                                    \
    if (width == 64) {                                                                    \
      if (biwi) return bf16 ? fn<true, __nv_bfloat16, 64>(__VA_ARGS__)                    \
                            : fn<true, float, 64>(__VA_ARGS__);                           \
      return bf16 ? fn<false, __nv_bfloat16, 64>(__VA_ARGS__) : fn<false, float, 64>(__VA_ARGS__); \
    }                                                                                     \
    if (width == 128) {                                                                   \
      if (biwi) return bf16 ? fn<true, __nv_bfloat16, 128>(__VA_ARGS__)                   \
                            : fn<true, float, 128>(__VA_ARGS__);                          \
      return bf16 ? fn<false, __nv_bfloat16, 128>(__VA_ARGS__)                            \
                  : fn<false, float, 128>(__VA_ARGS__);                                   \
    }                                                                                     \
    return cudaErrorInvalidValue;                                                         \
  } while (0)

}  // namespace

// layout[0] = packed weights (elements), layout[1] = shared bytes a CTA
// of a cluster of `cluster` needs besides its cache rows, layout[2] = bytes
// of one cache row; widths 64 and 128
extern "C" int a2f_decode_layout(int biwi, int bf16, int width, int cluster, int* layout) {
  const int wb = bf16 ? 2 : 4;
  if (width == 64) {
    layout[0] = biwi ? Layout<64>::N_WEIGHTS_BIWI : Layout<64>::N_WEIGHTS_VOCASET;
    layout[1] = fixed_bytes<64>(biwi, wb, cluster);
    layout[2] = Layout<64>::ROW_BYTES;
    return 0;
  }
  if (width == 128) {
    layout[0] = biwi ? Layout<128>::N_WEIGHTS_BIWI : Layout<128>::N_WEIGHTS_VOCASET;
    layout[1] = fixed_bytes<128>(biwi, wb, cluster);
    layout[2] = Layout<128>::ROW_BYTES;
    return 0;
  }
  return cudaErrorInvalidValue;
}

// plan[0] = cluster size CL, plan[1] = cache rows a CTA holds, plan[2] =
// shared bytes a CTA, plan[3] = clusters resident at once
// (cudaOccupancyMaxActiveClusters), plan[4] = shared bytes a block may use
extern "C" int a2f_decode_plan(int biwi, int bf16, int width, int batch, int n_steps,
                               int* plan_out) {
  A2F_DISPATCH(plan, batch, n_steps, plan_out);
}

// cross: (B, T, width) f32; style: (B, width) f32; pe: (period, width) f32;
// weights: the packed buffer above, bf16 if `bf16` else f32; ln: (6,
// width) f32; slopes: (4,) f32; kv: (B, T, 2 width) f32 for the rows past
// a CTA's shared memory; out: (B, T, width) f32. cluster and rows_cta from
// a2f_decode_plan.
extern "C" int a2f_decode_loop(const float* cross, const float* style, const float* pe,
                               const void* weights, const float* ln, const float* slopes,
                               float* kv, float* out, int batch, int n_steps, int period,
                               int width, int bf16, int cluster, int rows_cta, void* stream) {
  const int biwi = 0;
  A2F_DISPATCH(launch, cross, nullptr, style, pe, weights, ln, slopes, kv, out, batch, n_steps,
               period, cluster, rows_cta, stream);
}

// BIWI: mem_k, mem_v: (B, 2T, width) f32, columns head * width / 4 + i;
// weights: the packed buffer with W_cq, b_cq, W_co, b_co appended; the
// rest as above.
extern "C" int a2f_decode_loop_biwi(const float* mem_k, const float* mem_v, const float* style,
                                    const float* pe, const void* weights, const float* ln,
                                    const float* slopes, float* kv, float* out, int batch,
                                    int n_steps, int period, int width, int bf16, int cluster,
                                    int rows_cta, void* stream) {
  const int biwi = 1;
  A2F_DISPATCH(launch, mem_k, mem_v, style, pe, weights, ln, slopes, kv, out, batch, n_steps,
               period, cluster, rows_cta, stream);
}

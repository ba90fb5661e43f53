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
// the kernel is bound by tensor-core operations, not memory. The design
// keeps every score tile on chip: one block per (b*h, 64-row q tile) walks
// the k tiles in a loop (the TPU's sequential grid axis), stops at the last
// tile the KV length and causality can reach (the TPU's `last_needed`), and
// holds the running max and sum in registers. bf16 products run on the
// tensor cores through WMMA (bf16 operands, f32 accumulation); f32 inputs
// take CUDA-core FMAs so that f32 results keep f32 accuracy.
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), o (BH, Tq, D) in the input
// type, lse (BH, Tq) f32; all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BK = 64;        // keys per tile
constexpr int NTHREADS = 128;  // 4 warps
constexpr float MASK_VALUE = -1e30f;

template <typename T, int D>
struct Layout {
  static constexpr int TP = D + Traits<T>::PAD;   // q/k/v pitch (elements)
  static constexpr int SP = BK + 4;               // score pitch (floats)
  static constexpr int PP = BK + Traits<T>::PAD;  // probability pitch
  static constexpr int OP = D + 4;                // accumulator pitch (floats)
  static constexpr int Q = 0;
  static constexpr int K = Q + align128(BQ * TP * sizeof(T));
  static constexpr int V = K + align128(BK * TP * sizeof(T));
  static constexpr int S = V + align128(BK * TP * sizeof(T));
  static constexpr int P = S + align128(BQ * SP * sizeof(float));
  static constexpr int O = P + align128(BQ * PP * sizeof(T));
  static constexpr int BYTES = O + align128(BQ * OP * sizeof(float));
};

// 64 rows [row0, row0 + 64) of a (T, D) slab into a pitched tile; rows past
// `valid` are zero. bf16 rows move in 16-byte chunks (D is a multiple of 8).
template <typename T, int D, int TP>
__device__ void load_tile(T* dst, const T* src, int row0, int valid) {
  static_assert(BQ == BK, "one tile height for q, k and v");
  if constexpr (sizeof(T) == 2) {
    constexpr int CH = D / 8;
    for (int idx = threadIdx.x; idx < BQ * CH; idx += NTHREADS) {
      int r = idx / CH, c = idx % CH;
      int g = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)g * D + 8 * c);
      *reinterpret_cast<uint4*>(dst + r * TP + 8 * c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
      int r = idx / D, c = idx % D;
      int g = row0 + r;
      dst[r * TP + c] = g < valid ? src[(size_t)g * D + c] : 0.f;
    }
  }
}

// S = Q K^T for the whole 64x64 tile
template <typename T, int D, int TP, int SP>
__device__ void scores(const T* Qs, const T* Ks, float* Ss) {
  if constexpr (sizeof(T) == 2) {
    const int w = threadIdx.x / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
    for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Qs + (16 * w) * TP + kk * 16, TP);
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + (16 * n) * TP + kk * 16, TP);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    for (int n = 0; n < BK / 16; ++n)
      wmma::store_matrix_sync(Ss + (16 * w) * SP + 16 * n, acc[n], SP, wmma::mem_row_major);
  } else {
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
      int r = idx / BK, c = idx % BK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(Qs[r * TP + d], Ks[c * TP + d], s);
      Ss[r * SP + c] = s;
    }
  }
}

// O += P V for the whole tile
template <typename T, int D, int TP, int PP, int OP>
__device__ void accumulate_pv(const T* Ps, const T* Vs, float* Os) {
  if constexpr (sizeof(T) == 2) {
    const int w = threadIdx.x / 32;
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + (16 * w) * OP + 16 * n, OP, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + (16 * w) * PP + kk * 16, PP);
        wmma::load_matrix_sync(b, Vs + (16 * kk) * TP + 16 * n, TP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + (16 * w) * OP + 16 * n, acc, OP, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
      int r = idx / D, d = idx % D;
      float o = Os[r * OP + d];
#pragma unroll 16
      for (int c = 0; c < BK; ++c) o = fmaf(Ps[r * PP + c], Vs[c * TP + d], o);
      Os[r * OP + d] = o;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_len,
                 const float* __restrict__ slopes, int heads, int t_q, int t_k,
                 int causal, int period, float sm_scale,
                 const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  T* Ps = reinterpret_cast<T*>(smem + L::P);
  float* Os = reinterpret_cast<float*>(smem + L::O);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvlen = kv_len[bh / heads];
  const float slope = slopes[bh % heads];
  const uint32_t seed0 = drop_thr > 0 ? (uint32_t)seed[0] : 0u;
  const T* qb = q + (size_t)bh * t_q * D;
  const T* kb = k + (size_t)bh * t_k * D;
  const T* vb = v + (size_t)bh * t_k * D;

  // each row is owned by a lane pair of the warp that computes it; lane
  // parity picks which half of the 64 columns (and of D) it handles
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x / 32) + lane / 2;
  const int half = lane % 2;
  const int row = q0 + r;
  float m_run = MASK_VALUE, l_run = 0.f;

  load_tile<T, D, L::TP>(Qs, qb, q0, t_q);
  for (int idx = threadIdx.x; idx < BQ * L::OP; idx += NTHREADS) Os[idx] = 0.f;

  int last = (max(kvlen - 1, 0)) / BK;
  last = min(last, (t_k + BK - 1) / BK - 1);
  if (causal) last = min(last, (q0 + BQ - 1) / BK);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's K/V/P reads are done
    load_tile<T, D, L::TP>(Ks, kb, k0, t_k);
    load_tile<T, D, L::TP>(Vs, vb, k0, t_k);
    __syncthreads();
    scores<T, D, L::TP, L::SP>(Qs, Ks, Ss);
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
    const float alpha = Traits<T>::exp(m_run - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float p = Traits<T>::exp(s[i] - m_new);
      sum += p;
      if (drop_thr > 0)
        p *= dropout_keep(seed0, bh, row, k0 + half * (BK / 2) + i, drop_thr, keep_scale);
      Ps[r * L::PP + half * (BK / 2) + i] = from_float<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = alpha * l_run + sum;
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < D / 2; ++d) Os[r * L::OP + half * (D / 2) + d] *= alpha;
    __syncthreads();
    accumulate_pv<T, D, L::TP, L::PP, L::OP>(Ps, Vs, Os);
  }
  __syncthreads();

  if (row < t_q) {
    const float l = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l;
    T* ob = o + ((size_t)bh * t_q + row) * D + half * (D / 2);
#pragma unroll
    for (int d = 0; d < D / 2; ++d)
      ob[d] = from_float<T>(Os[r * L::OP + half * (D / 2) + d] * inv);
    if (half == 0) lse[(size_t)bh * t_q + row] = m_run + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* kv_len, const float* slopes,
                   int bh, int heads, int t_q, int t_k, int causal, int period,
                   float sm_scale, const int* seed, uint32_t drop_thr,
                   float keep_scale, cudaStream_t stream) {
  constexpr int bytes = Layout<T, D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((t_q + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, kv_len, slopes, heads,
      t_q, t_k, causal, period, sm_scale, seed, drop_thr, keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v,
                     void* o, float* lse, const int* kv_len,
                     const float* slopes, int bh, int heads, int t_q, int t_k,
                     int causal, int period, float sm_scale, const int* seed,
                     uint32_t drop_thr, float keep_scale, cudaStream_t s) {
#define A2F_LAUNCH(D)                                                          \
  launch<T, D>(q, k, v, o, lse, kv_len, slopes, bh, heads, t_q, t_k, causal,   \
               period, sm_scale, seed, drop_thr, keep_scale, s)
  switch (d) {
    case 16: return A2F_LAUNCH(16);
    case 32: return A2F_LAUNCH(32);
    case 64: return A2F_LAUNCH(64);
    case 128: return A2F_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef A2F_LAUNCH
}

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, lse, kv_len, slopes,
                                   batch * heads, heads, t_q, t_k, causal,
                                   period, sm_scale, seed, drop_thr, keep_scale, s);
  return dispatch<float>(head_dim, q, k, v, o, lse, kv_len, slopes,
                         batch * heads, heads, t_q, t_k, causal, period,
                         sm_scale, seed, drop_thr, keep_scale, s);
}

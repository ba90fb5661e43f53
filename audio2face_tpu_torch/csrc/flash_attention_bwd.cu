// Flash-attention backward for Hopper (sm_90a): dq, dk, dv.
//
// Replaces the TPU kernels of audio2face_tpu/ops/attention.py
// flash_attention_bwd_pallas (_flash_bwd_dkdv_kernel, _flash_bwd_dq_kernel):
// from q, k, v, dO, the forward's per-row logsumexp and delta =
// rowsum(dO * O) they recompute every probability tile on chip,
//   p  = exp(s - lse)            (s: scaled scores + ALiBi bias, masked)
//   dv = (m . p)^T dO            (m: the forward's dropout keep multiplier)
//   ds = p . (m . dO v^T - delta) . scale
//   dq = ds k,   dk = ds^T q
// with the forward's causal mask, period-bucketed ALiBi bias, per-batch KV
// lengths and hash dropout (the keep multiplier is regenerated from
// (seed, batch*head, row, col); no mask tensor exists).
//
// Bound: five 64x64xD products per tile pair against reads of q, k, v, dO
// and writes of dq, dk, dv: tensor-core operations at the training shape
// (B*H = 96, T = 600, D = 64, bf16), not memory. Design: two kernels, one
// per output ownership, no atomics, so results are deterministic. The
// dk/dv kernel gives one block a 64-row k/v tile and walks the q tiles;
// the dq kernel gives one block a 64-row q tile and walks the k tiles up to
// the last one the KV length and causality can reach. Score, dP, P and dS
// tiles live in shared memory only; sums are f32 in shared memory; P and
// dS are rounded to the input type before their products, as the TPU
// kernels do. bf16 products run on the tensor cores through WMMA; f32
// inputs take CUDA-core FMAs so that f32 gradients keep f32 accuracy.
//
// Layout: q, dO, dq (BH, Tq, D); k, v, dk, dv (BH, Tk, D) in the input
// type; lse, delta (BH, Tq) f32; all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace nvcuda;

constexpr int BT = 64;         // rows of the tile a block owns
constexpr int NTHREADS = 128;  // 4 warps

// Shared-memory map of one block. NQ query rows by NK key columns per score
// tile; the dk/dv kernel keeps P and two accumulators, the dq kernel one.
template <typename T, int D, int NQ, int NK, bool DKDV>
struct Layout {
  static constexpr int TP = D + Traits<T>::PAD;   // q/k/v/dO pitch (elements)
  static constexpr int SP = NK + 4;               // score and dP pitch (floats)
  static constexpr int PP = NK + Traits<T>::PAD;  // P and dS pitch
  static constexpr int OP = D + 4;                // accumulator pitch (floats)
  static constexpr int Q = 0;
  static constexpr int DO = Q + align128(NQ * TP * sizeof(T));
  static constexpr int K = DO + align128(NQ * TP * sizeof(T));
  static constexpr int V = K + align128(NK * TP * sizeof(T));
  static constexpr int S = V + align128(NK * TP * sizeof(T));
  static constexpr int DP = S + align128(NQ * SP * sizeof(float));
  static constexpr int DS = DP + align128(NQ * SP * sizeof(float));
  static constexpr int P = DS + align128(NQ * PP * sizeof(T));
  static constexpr int LSE = P + (DKDV ? align128(NQ * PP * sizeof(T)) : 0);
  static constexpr int DELTA = LSE + align128(NQ * sizeof(float));
  static constexpr int ACC0 = DELTA + align128(NQ * sizeof(float));
  static constexpr int ACC1 = ACC0 + align128(BT * OP * sizeof(float));
  static constexpr int BYTES = ACC1 + (DKDV ? align128(BT * OP * sizeof(float)) : 0);
};

// ROWS rows [row0, row0 + ROWS) of a (T, D) slab into a pitched tile; rows
// past `valid` are zero. bf16 rows move in 16-byte chunks.
template <typename T, int D, int TP, int ROWS>
__device__ void load_tile(T* dst, const T* src, int row0, int valid) {
  if constexpr (sizeof(T) == 2) {
    constexpr int CH = D / 8;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NTHREADS) {
      int r = idx / CH, c = idx % CH;
      int g = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)g * D + 8 * c);
      *reinterpret_cast<uint4*>(dst + r * TP + 8 * c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += NTHREADS) {
      int r = idx / D, c = idx % D;
      int g = row0 + r;
      dst[r * TP + c] = g < valid ? src[(size_t)g * D + c] : 0.f;
    }
  }
}

// ROWS per-row scalars (lse, delta); rows past `valid` are zero
template <int ROWS>
__device__ void load_rows(float* dst, const float* src, int row0, int valid) {
  for (int i = threadIdx.x; i < ROWS; i += NTHREADS) dst[i] = row0 + i < valid ? src[row0 + i] : 0.f;
}

// out[NQ x NK] = A[NQ x D] B[NK x D]^T: the scores q k^T and dP = dO v^T
template <typename T, int D, int NQ, int NK, int TP, int SP>
__device__ void abt_product(const T* As, const T* Bs, float* out) {
  if constexpr (sizeof(T) == 2) {
    static_assert(NQ == 16 * (NTHREADS / 32), "one 16-row stripe per warp");
    const int w = threadIdx.x / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NK / 16];
    for (int n = 0; n < NK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, As + (16 * w) * TP + kk * 16, TP);
      for (int n = 0; n < NK / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Bs + (16 * n) * TP + kk * 16, TP);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
    for (int n = 0; n < NK / 16; ++n)
      wmma::store_matrix_sync(out + (16 * w) * SP + 16 * n, acc[n], SP, wmma::mem_row_major);
  } else {
    for (int idx = threadIdx.x; idx < NQ * NK; idx += NTHREADS) {
      int r = idx / NK, c = idx % NK;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(As[r * TP + d], Bs[c * TP + d], s);
      out[r * SP + c] = s;
    }
  }
}

// acc[NK x D] += A[NQ x NK]^T B[NQ x D]: dv += (m p)^T dO and dk += ds^T q
template <typename T, int D, int NQ, int NK, int PP, int TP, int OP>
__device__ void atb_accumulate(const T* As, const T* Bs, float* acc_s) {
  if constexpr (sizeof(T) == 2) {
    static_assert(NK == 16 * (NTHREADS / 32), "one 16-row stripe per warp");
    const int w = threadIdx.x / 32;
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, acc_s + (16 * w) * OP + 16 * n, OP, wmma::mem_row_major);
      for (int kk = 0; kk < NQ / 16; ++kk) {
        // A^T(c, r) = As[r][c]: a column-major view of the row-major tile
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, As + (16 * kk) * PP + 16 * w, PP);
        wmma::load_matrix_sync(b, Bs + (16 * kk) * TP + 16 * n, TP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(acc_s + (16 * w) * OP + 16 * n, acc, OP, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < NK * D; idx += NTHREADS) {
      int c = idx / D, d = idx % D;
      float o = acc_s[c * OP + d];
#pragma unroll 16
      for (int r = 0; r < NQ; ++r) o = fmaf(As[r * PP + c], Bs[r * TP + d], o);
      acc_s[c * OP + d] = o;
    }
  }
}

// acc[NQ x D] += A[NQ x NK] B[NK x D]: dq += ds k
template <typename T, int D, int NQ, int NK, int PP, int TP, int OP>
__device__ void ab_accumulate(const T* As, const T* Bs, float* acc_s) {
  if constexpr (sizeof(T) == 2) {
    static_assert(NQ == 16 * (NTHREADS / 32), "one 16-row stripe per warp");
    const int w = threadIdx.x / 32;
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, acc_s + (16 * w) * OP + 16 * n, OP, wmma::mem_row_major);
      for (int kk = 0; kk < NK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, As + (16 * w) * PP + kk * 16, PP);
        wmma::load_matrix_sync(b, Bs + (16 * kk) * TP + 16 * n, TP);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(acc_s + (16 * w) * OP + 16 * n, acc, OP, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < NQ * D; idx += NTHREADS) {
      int r = idx / D, d = idx % D;
      float o = acc_s[r * OP + d];
#pragma unroll 16
      for (int c = 0; c < NK; ++c) o = fmaf(As[r * PP + c], Bs[c * TP + d], o);
      acc_s[r * OP + d] = o;
    }
  }
}

// what every tile needs to rebuild the forward's probabilities
struct TileParams {
  int t_q, kvlen, causal, period, bh;
  float slope, sm_scale, keep_scale;
  uint32_t seed, drop_thr;
};

// From the score tile and dP = dO v^T: P' = m p (only when Ps is given) and
// dS = p (m dP - delta) scale, both rounded to the input type. p is zeroed
// by the mask, never trusted to underflow: a fully masked row has a finite
// lse of about -1e30, and a padded row (>= t_q) has lse 0.
template <typename T, int NQ, int NK, int SP, int PP>
__device__ void probabilities_and_ds(const float* Ss, const float* dPs, T* Ps, T* dSs,
                                     const float* lse_s, const float* delta_s,
                                     int q0, int k0, const TileParams& tp) {
  for (int idx = threadIdx.x; idx < NQ * NK; idx += NTHREADS) {
    const int r = idx / NK, c = idx % NK;
    const int row = q0 + r, col = k0 + c;
    float x = Ss[r * SP + c] * tp.sm_scale;
    if (tp.period > 0) x -= tp.slope * (float)floor_div(row - col, tp.period);
    const bool ok = row < tp.t_q && col < tp.kvlen && (!tp.causal || col <= row);
    const float p = ok ? Traits<T>::exp(x - lse_s[r]) : 0.f;
    float m = 1.f;
    if (tp.drop_thr > 0) m = dropout_keep(tp.seed, tp.bh, row, col, tp.drop_thr, tp.keep_scale);
    const float ds = p * (dPs[r * SP + c] * m - delta_s[r]) * tp.sm_scale;
    if (Ps != nullptr) Ps[r * PP + c] = from_float<T>(p * m);
    dSs[r * PP + c] = from_float<T>(ds);
  }
}

// ---- dk, dv: one block per (batch*head, 64-row k tile), loop over q tiles --
template <typename T, int D, int NQ>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv,
                      const int* __restrict__ kv_len, const float* __restrict__ slopes,
                      int heads, int t_q, int t_k, int causal, int period,
                      float sm_scale, const int* __restrict__ seed, uint32_t drop_thr,
                      float keep_scale) {
  using L = Layout<T, D, NQ, BT, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* dOs = reinterpret_cast<T*>(smem + L::DO);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  T* dSs = reinterpret_cast<T*>(smem + L::DS);
  T* Ps = reinterpret_cast<T*>(smem + L::P);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  float* dKs = reinterpret_cast<float*>(smem + L::ACC0);
  float* dVs = reinterpret_cast<float*>(smem + L::ACC1);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  TileParams tp;
  tp.t_q = t_q;
  tp.kvlen = kv_len[bh / heads];
  tp.causal = causal;
  tp.period = period;
  tp.bh = bh;
  tp.slope = slopes[bh % heads];
  tp.sm_scale = sm_scale;
  tp.keep_scale = keep_scale;
  tp.drop_thr = drop_thr;
  tp.seed = drop_thr > 0 ? (uint32_t)seed[0] : 0u;

  const T* qb = q + (size_t)bh * t_q * D;
  const T* dob = dout + (size_t)bh * t_q * D;
  const float* lseb = lse + (size_t)bh * t_q;
  const float* deltab = delta + (size_t)bh * t_q;

  for (int idx = threadIdx.x; idx < BT * L::OP; idx += NTHREADS) {
    dKs[idx] = 0.f;
    dVs[idx] = 0.f;
  }
  // keys at or past the KV length are masked everywhere: their dk, dv stay 0
  if (k0 < tp.kvlen) {
    load_tile<T, D, L::TP, BT>(Ks, k + (size_t)bh * t_k * D, k0, t_k);
    load_tile<T, D, L::TP, BT>(Vs, v + (size_t)bh * t_k * D, k0, t_k);
    const int n_q_tiles = (t_q + NQ - 1) / NQ;
    // under causality, q tiles wholly above this k tile contribute nothing
    for (int iq = causal ? k0 / NQ : 0; iq < n_q_tiles; ++iq) {
      const int q0 = iq * NQ;
      __syncthreads();  // the previous tile's products are done
      load_tile<T, D, L::TP, NQ>(Qs, qb, q0, t_q);
      load_tile<T, D, L::TP, NQ>(dOs, dob, q0, t_q);
      load_rows<NQ>(lse_s, lseb, q0, t_q);
      load_rows<NQ>(delta_s, deltab, q0, t_q);
      __syncthreads();
      abt_product<T, D, NQ, BT, L::TP, L::SP>(Qs, Ks, Ss);
      abt_product<T, D, NQ, BT, L::TP, L::SP>(dOs, Vs, dPs);
      __syncthreads();
      probabilities_and_ds<T, NQ, BT, L::SP, L::PP>(Ss, dPs, Ps, dSs, lse_s, delta_s, q0, k0, tp);
      __syncthreads();
      atb_accumulate<T, D, NQ, BT, L::PP, L::TP, L::OP>(Ps, dOs, dVs);
      atb_accumulate<T, D, NQ, BT, L::PP, L::TP, L::OP>(dSs, Qs, dKs);
    }
  }
  __syncthreads();

  T* dkb = dk + (size_t)bh * t_k * D;
  T* dvb = dv + (size_t)bh * t_k * D;
  for (int idx = threadIdx.x; idx < BT * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    if (k0 + r < t_k) {
      dkb[(size_t)(k0 + r) * D + d] = from_float<T>(dKs[r * L::OP + d]);
      dvb[(size_t)(k0 + r) * D + d] = from_float<T>(dVs[r * L::OP + d]);
    }
  }
}

// ---- dq: one block per (batch*head, 64-row q tile), loop over k tiles ------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, const int* __restrict__ kv_len,
                    const float* __restrict__ slopes, int heads, int t_q, int t_k,
                    int causal, int period, float sm_scale,
                    const int* __restrict__ seed, uint32_t drop_thr, float keep_scale) {
  using L = Layout<T, D, BT, BT, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q);
  T* dOs = reinterpret_cast<T*>(smem + L::DO);
  T* Ks = reinterpret_cast<T*>(smem + L::K);
  T* Vs = reinterpret_cast<T*>(smem + L::V);
  float* Ss = reinterpret_cast<float*>(smem + L::S);
  float* dPs = reinterpret_cast<float*>(smem + L::DP);
  T* dSs = reinterpret_cast<T*>(smem + L::DS);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  float* dQs = reinterpret_cast<float*>(smem + L::ACC0);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  TileParams tp;
  tp.t_q = t_q;
  tp.kvlen = kv_len[bh / heads];
  tp.causal = causal;
  tp.period = period;
  tp.bh = bh;
  tp.slope = slopes[bh % heads];
  tp.sm_scale = sm_scale;
  tp.keep_scale = keep_scale;
  tp.drop_thr = drop_thr;
  tp.seed = drop_thr > 0 ? (uint32_t)seed[0] : 0u;

  const T* kb = k + (size_t)bh * t_k * D;
  const T* vb = v + (size_t)bh * t_k * D;
  load_tile<T, D, L::TP, BT>(Qs, q + (size_t)bh * t_q * D, q0, t_q);
  load_tile<T, D, L::TP, BT>(dOs, dout + (size_t)bh * t_q * D, q0, t_q);
  load_rows<BT>(lse_s, lse + (size_t)bh * t_q, q0, t_q);
  load_rows<BT>(delta_s, delta + (size_t)bh * t_q, q0, t_q);
  for (int idx = threadIdx.x; idx < BT * L::OP; idx += NTHREADS) dQs[idx] = 0.f;

  // the last k tile the KV length and causality can reach, as in the
  // forward; a zero-length item walks tile 0 fully masked and gets dq = 0
  int last = (max(tp.kvlen - 1, 0)) / BT;
  last = min(last, (t_k + BT - 1) / BT - 1);
  if (causal) last = min(last, (q0 + BT - 1) / BT);

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's K/V/dS reads are done
    load_tile<T, D, L::TP, BT>(Ks, kb, k0, t_k);
    load_tile<T, D, L::TP, BT>(Vs, vb, k0, t_k);
    __syncthreads();
    abt_product<T, D, BT, BT, L::TP, L::SP>(Qs, Ks, Ss);
    abt_product<T, D, BT, BT, L::TP, L::SP>(dOs, Vs, dPs);
    __syncthreads();
    probabilities_and_ds<T, BT, BT, L::SP, L::PP>(Ss, dPs, static_cast<T*>(nullptr), dSs,
                                                  lse_s, delta_s, q0, k0, tp);
    __syncthreads();
    ab_accumulate<T, D, BT, BT, L::PP, L::TP, L::OP>(dSs, Ks, dQs);
  }
  __syncthreads();

  T* dqb = dq + (size_t)bh * t_q * D;
  for (int idx = threadIdx.x; idx < BT * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    if (q0 + r < t_q) dqb[(size_t)(q0 + r) * D + d] = from_float<T>(dQs[r * L::OP + d]);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
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

template <typename T, int D>
cudaError_t launch(const Args& a) {
  // f32 at D = 128 walks 32-row q tiles so that the dk/dv block's tiles and
  // two accumulators fit one block's shared memory
  constexpr int NQ = (sizeof(T) == 4 && D == 128) ? 32 : BT;
  constexpr int dkdv_bytes = Layout<T, D, NQ, BT, true>::BYTES;
  constexpr int dq_bytes = Layout<T, D, BT, BT, false>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  dim3 k_grid((a.t_k + BT - 1) / BT, a.bh);
  flash_bwd_dkdv_kernel<T, D, NQ><<<k_grid, NTHREADS, dkdv_bytes, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.kv_len, a.slopes, a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale,
      a.seed, a.drop_thr, a.keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 q_grid((a.t_q + BT - 1) / BT, a.bh);
  flash_bwd_dq_kernel<T, D><<<q_grid, NTHREADS, dq_bytes, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.kv_len, a.slopes,
      a.heads, a.t_q, a.t_k, a.causal, a.period, a.sm_scale, a.seed, a.drop_thr,
      a.keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const Args& a) {
  switch (d) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the dk/dv kernel, then the dq kernel, on `stream`.
// head_dim must be 16, 32, 64 or 128; period 0 = no bias. kv_len: (B,)
// int32 on the device, each in [0, t_k]; slopes: (H,) f32; lse and delta =
// rowsum(dO * O): (B*H, t_q) f32. Dropout as in a2f_flash_attention_fwd:
// kept iff hash >= drop_thr, kept values scaled by keep_scale, drop_thr 0 =
// off; seed: (1,) int32 on the device, the forward's.
extern "C" int a2f_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dq, void* dk,
                                       void* dv, const int* kv_len,
                                       const float* slopes, int batch, int heads,
                                       int t_q, int t_k, int head_dim, int is_bf16,
                                       int causal, int period, float sm_scale,
                                       const int* seed, unsigned int drop_thr,
                                       float keep_scale, void* stream) {
  Args a{q,      k,     v,      dout,   lse,    delta,
         dq,     dk,    dv,     kv_len, slopes, batch * heads,
         heads,  t_q,   t_k,    causal, period, sm_scale,
         seed,   drop_thr, keep_scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16>(head_dim, a) : dispatch<float>(head_dim, a);
}

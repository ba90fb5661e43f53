// FaceFormer autoregressive decode loop for Hopper (sm_90a).
//
// Replaces the TPU kernel audio2face_tpu/ops/decode_kernel.py
// faceformer_decode_loop (_decode_kernel), vocaset variant: the whole
// T-step loop in one launch. Each step t, for one batch item:
//
//   x_t   = emb_t + PPE[t mod period]
//   attn  = softmax_{j<=t}(q_t . k_j / sqrt(16) - slope_h * ((t-j) // period)) v_j
//   h     = LN1(x_t + W_o attn)
//   h     = LN2(h + cross_t)               (the hoisted diagonal cross term)
//   h     = LN3(h + W_2 relu(W_1 h))
//   emb_{t+1} = h @ (W_r W_m) + b + style
//
// Bound: the steps are a chain of dependent 64-wide matvecs, so latency
// bounds the dense part; the attention reads the KV cache rows [0, t] every
// step (sum_t 512 t bytes, 3.3 GB per item at T = 3600), from L2 for one
// item's 1.8 MB cache. Design: one block per batch item runs all T steps
// (the TPU packs 8 items on lanes; that packing exists for its layout and
// is not ported). All weights (~148 KB f32) sit in shared memory for the
// whole loop; the (T, 128) f32 KV cache lives in device memory, allocated
// by the caller, and each step reads only rows [0, t], all written by
// earlier steps, so no stale row enters the value sum. Attention runs as
// an online softmax: two warps per head split the keys, then their partial
// (max, sum, value sum) combine in shared memory. Math is f32 throughout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64, NH = 4, HD = 16, FF = 128;
constexpr int NTHREADS = 256;  // 8 warps, 2 per head in attention
constexpr float NEG = -1e30f;

// packed f32 weight buffer, kernels in (in, out) row-major order
constexpr int WQKV = 0;                 // (64, 192): q | k | v columns
constexpr int BQKV = WQKV + D * 3 * D;  // (192,)
constexpr int WO = BQKV + 3 * D;        // (64, 64)
constexpr int BO = WO + D * D;
constexpr int W1 = BO + D;              // (64, 128)
constexpr int B1 = W1 + D * FF;
constexpr int W2 = B1 + FF;             // (128, 64)
constexpr int B2 = W2 + FF * D;
constexpr int WFB = B2 + D;             // (64, 64)
constexpr int BFB = WFB + D * D;
constexpr int LN1S = BFB + D, LN1B = LN1S + D;
constexpr int LN2S = LN1B + D, LN2B = LN2S + D;
constexpr int LN3S = LN2B + D, LN3B = LN3S + D;
constexpr int N_WEIGHTS = LN3B + D;

// per-step scratch after the weights
constexpr int S_EMB = N_WEIGHTS;
constexpr int S_X = S_EMB + D;
constexpr int S_Q = S_X + D;
constexpr int S_ATTN = S_Q + D;
constexpr int S_H = S_ATTN + D;
constexpr int S_FF = S_H + D;
constexpr int PART = 2 + HD;  // (max, sum, value sum[16]) per warp
constexpr int S_PART = S_FF + FF;
constexpr int S_RED = S_PART + 8 * PART;
constexpr int SMEM_FLOATS = S_RED + 8;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// in-place layer norm of the 64 values at v (threads 0..63 hold them);
// every thread of the block must call it
__device__ void layer_norm64(float* v, const float* scale, const float* bias, float* red) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float val = tid < D ? v[tid] : 0.f;
  float s = warp_sum(val);
  if (lane == 0 && warp < 2) red[warp] = s;
  __syncthreads();
  const float mean = (red[0] + red[1]) * (1.f / D);
  const float dv = val - mean;
  s = warp_sum(tid < D ? dv * dv : 0.f);
  if (lane == 0 && warp < 2) red[2 + warp] = s;
  __syncthreads();
  const float var = (red[2] + red[3]) * (1.f / D);
  if (tid < D) v[tid] = dv * rsqrtf(var + 1e-5f) * scale[tid] + bias[tid];
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS, 1)
decode_loop_kernel(const float* __restrict__ cross, const float* __restrict__ style,
                   const float* __restrict__ pe, const float* __restrict__ weights,
                   const float* __restrict__ slopes, float* __restrict__ kv,
                   float* __restrict__ out, int n_steps, int period) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < N_WEIGHTS; i += NTHREADS) sm[i] = weights[i];
  const float* sty = style + (size_t)b * D;
  if (tid < D) sm[S_EMB + tid] = sty[tid];
  const float* crossb = cross + (size_t)b * n_steps * D;
  float* kvb = kv + (size_t)b * n_steps * 2 * D;
  float* outb = out + (size_t)b * n_steps * D;
  const int head = warp / 2;
  const float slope = slopes[head];
  float* x = sm + S_X;
  float* h = sm + S_H;
  float* red = sm + S_RED;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    if (tid < D) x[tid] = sm[S_EMB + tid] + pe[(t % period) * D + tid];
    __syncthreads();

    // q | k | v projection; k and v go to cache row t
    if (tid < 3 * D) {
      float y = sm[BQKV + tid];
#pragma unroll 8
      for (int i = 0; i < D; ++i) y = fmaf(x[i], sm[WQKV + i * 3 * D + tid], y);
      if (tid < D)
        sm[S_Q + tid] = y * 0.25f;  // 1 / sqrt(16), exact
      else
        kvb[(size_t)t * 2 * D + tid - D] = y;
    }
    __syncthreads();

    // attention over rows [0, t]: warp pair (2h, 2h+1) splits head h's keys
    {
      float q[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) q[d] = sm[S_Q + head * HD + d];
      float m = NEG, l = 0.f, acc[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = 0.f;
#pragma unroll 2
      for (int j = (warp % 2) * 32 + lane; j <= t; j += 64) {
        const float4* kr = reinterpret_cast<const float4*>(kvb + (size_t)j * 2 * D + head * HD);
        const float4* vr = reinterpret_cast<const float4*>(kvb + (size_t)j * 2 * D + D + head * HD);
        float4 kk[4], vv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kk[c] = kr[c];
          vv[c] = vr[c];
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
      for (int off = 16; off > 0; off /= 2) {
        const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
        const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
        const float m_new = fmaxf(m, m_o);
        const float a = expf(m - m_new), a_o = expf(m_o - m_new);
        l = l * a + l_o * a_o;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          const float acc_o = __shfl_xor_sync(0xffffffffu, acc[d], off);
          acc[d] = acc[d] * a + acc_o * a_o;
        }
        m = m_new;
      }
      if (lane == 0) {
        float* part = sm + S_PART + warp * PART;
        part[0] = m;
        part[1] = l;
#pragma unroll
        for (int d = 0; d < HD; ++d) part[2 + d] = acc[d];
      }
    }
    __syncthreads();
    if (tid < D) {
      const float* p0 = sm + S_PART + (2 * (tid / HD)) * PART;
      const float* p1 = p0 + PART;
      const float mm = fmaxf(p0[0], p1[0]);
      const float a0 = expf(p0[0] - mm), a1 = expf(p1[0] - mm);
      const int d = tid % HD;
      sm[S_ATTN + tid] = (p0[2 + d] * a0 + p1[2 + d] * a1) / (p0[1] * a0 + p1[1] * a1);
    }
    __syncthreads();

    // h = LN1(x + W_o attn)
    if (tid < D) {
      float y = sm[BO + tid];
#pragma unroll 8
      for (int i = 0; i < D; ++i) y = fmaf(sm[S_ATTN + i], sm[WO + i * D + tid], y);
      h[tid] = x[tid] + y;
    }
    __syncthreads();
    layer_norm64(h, sm + LN1S, sm + LN1B, red);

    // h = LN2(h + cross_t)
    if (tid < D) h[tid] += crossb[(size_t)t * D + tid];
    __syncthreads();
    layer_norm64(h, sm + LN2S, sm + LN2B, red);

    // h = LN3(h + W_2 relu(W_1 h))
    if (tid < FF) {
      float y = sm[B1 + tid];
#pragma unroll 8
      for (int i = 0; i < D; ++i) y = fmaf(h[i], sm[W1 + i * FF + tid], y);
      sm[S_FF + tid] = fmaxf(y, 0.f);
    }
    __syncthreads();
    float f2 = 0.f;
    if (tid < D) {
      f2 = sm[B2 + tid];
#pragma unroll 8
      for (int i = 0; i < FF; ++i) f2 = fmaf(sm[S_FF + i], sm[W2 + i * D + tid], f2);
    }
    __syncthreads();
    if (tid < D) h[tid] += f2;
    __syncthreads();
    layer_norm64(h, sm + LN3S, sm + LN3B, red);

    // emit h_t; emb_{t+1} = h W_fb + b_fb + style
    if (tid < D) {
      outb[(size_t)t * D + tid] = h[tid];
      float y = sm[BFB + tid];
#pragma unroll 8
      for (int i = 0; i < D; ++i) y = fmaf(h[i], sm[WFB + i * D + tid], y);
      sm[S_EMB + tid] = y + sty[tid];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int a2f_decode_smem_bytes() { return SMEM_BYTES; }

extern "C" int a2f_decode_n_weights() { return N_WEIGHTS; }

// cross: (B, T, 64) f32; style: (B, 64) f32; pe: (period, 64) f32;
// weights: the packed f32 buffer above; slopes: (4,) f32; kv: (B, T, 128)
// f32 scratch; out: (B, T, 64) f32.
extern "C" int a2f_decode_loop(const float* cross, const float* style,
                               const float* pe, const float* weights,
                               const float* slopes, float* kv, float* out,
                               int batch, int n_steps, int period,
                               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  decode_loop_kernel<<<batch, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      cross, style, pe, weights, slopes, kv, out, n_steps, period);
  return cudaGetLastError();
}

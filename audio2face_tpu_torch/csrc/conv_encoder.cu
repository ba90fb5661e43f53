// wav2vec2 conv feature encoder for Hopper (sm_90a): the group-norm stack.
//
// Replaces the TPU kernel audio2face_tpu/ops/conv_encoder.py
// fused_conv_encoder (_stack_kernel with the _packed_im2col_and_stats
// prepass): waveform (B, L) f32 -> (B, T6, 512) bf16 through 7 convs
// (k/s 10/5, 3/2 x4, 2/2 x2, 512 channels, no bias), a length-masked group
// norm after layer 0 and an exact GELU after every layer.
//
// Bound: ~2.3e12 FLOP of bf16 products for 8 x 60 s against ~60 MB of
// input and output, so tensor-core operations bound it. The TPU kernel
// keeps a whole output tile's receptive field (~8k layer-0 rows x 512
// channels, megabytes) in VMEM; Hopper's 227 KB of shared memory cannot,
// so this port is a family of launches whose intermediates go through
// L2/HBM (the layer-0 output is 1.57 GB bf16 at 8 x 60 s):
//   1. conv0_moments + gn_fold: the masked per-(item, channel) group-norm
//      statistics from the (10, 10) second moments of the valid layer-0
//      windows (conv0 is linear), folded with the affine into one
//      per-channel scale and bias;
//   2. conv0_gelu: layer 0 (10 taps on CUDA cores) with the folded norm and
//      GELU in its epilogue;
//   3. conv_gemm_wgmma<false>, once per layer 1-6 (conv_encoder.cuh).
// conv_encoder_ln.cu is the same stack with a LayerNorm after every conv.

#include "conv_encoder.cuh"

namespace {

constexpr int NMOM = 10 + 55;  // window sums + upper-triangle products
constexpr int MOM_BLOCKS = 64;  // partial-sum blocks per item

// ---- 1. group-norm statistics ------------------------------------------

__global__ void __launch_bounds__(256)
conv0_moments(const float* __restrict__ x, const int* __restrict__ feat_len,
              float* __restrict__ partials, int n_samples) {
  const int b = blockIdx.y;
  const int n_win = feat_len[b];
  const float* xb = x + (size_t)b * n_samples;
  float acc[NMOM];
#pragma unroll
  for (int i = 0; i < NMOM; ++i) acc[i] = 0.f;
  const int per = (n_win + MOM_BLOCKS - 1) / MOM_BLOCKS;
  const int lo = blockIdx.x * per;
  const int hi = min(lo + per, n_win);
  for (int t = lo + threadIdx.x; t < hi; t += blockDim.x) {
    float w[K0];
#pragma unroll
    for (int j = 0; j < K0; ++j) w[j] = xb[S0 * t + j];
    int p = K0;
#pragma unroll
    for (int j = 0; j < K0; ++j) {
      acc[j] += w[j];
#pragma unroll
      for (int k = j; k < K0; ++k) acc[p++] += w[j] * w[k];
    }
  }
  __shared__ float red[8][NMOM];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NMOM; ++i) {
    float v = acc[i];
    for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NMOM) {
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[w][threadIdx.x];
    partials[((size_t)b * MOM_BLOCKS + blockIdx.x) * NMOM + threadIdx.x] = v;
  }
}

// per channel: mean = w.mu, E[y^2] = w^T Cw w; folded into y * gs + gb
__global__ void __launch_bounds__(C)
gn_fold(const float* __restrict__ partials, const int* __restrict__ feat_len,
        const float* __restrict__ w0, const float* __restrict__ gn_scale,
        const float* __restrict__ gn_bias, float* __restrict__ gs,
        float* __restrict__ gb) {
  const int b = blockIdx.x;
  __shared__ float tot[NMOM];
  if (threadIdx.x < NMOM) {
    float v = 0.f;
    for (int i = 0; i < MOM_BLOCKS; ++i)
      v += partials[((size_t)b * MOM_BLOCKS + i) * NMOM + threadIdx.x];
    tot[threadIdx.x] = v;
  }
  __syncthreads();
  const float inv_n = 1.f / fmaxf((float)feat_len[b], 1.f);
  const int c = threadIdx.x;
  float w[K0];
#pragma unroll
  for (int j = 0; j < K0; ++j) w[j] = w0[j * C + c];
  float mean = 0.f, ey2 = 0.f;
  int p = K0;
#pragma unroll
  for (int j = 0; j < K0; ++j) {
    mean += w[j] * (tot[j] * inv_n);
#pragma unroll
    for (int k = j; k < K0; ++k) {
      float cjk = tot[p++] * inv_n;
      ey2 += (k == j ? 1.f : 2.f) * w[j] * w[k] * cjk;
    }
  }
  const float var = fmaxf(ey2 - mean * mean, 0.f);
  const float rstd = rsqrtf(var + EPS);
  const float scale = rstd * gn_scale[c];
  gs[b * C + c] = scale;
  gb[b * C + c] = gn_bias[c] - mean * scale;
}

// ---- 2. layer 0 + folded group norm + GELU -----------------------------

__global__ void __launch_bounds__(C / 2)
conv0_gelu(const float* __restrict__ x, const float* __restrict__ w0,
           const float* __restrict__ gs, const float* __restrict__ gb,
           __nv_bfloat16* __restrict__ out, int n_samples, int t0) {
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * L0_FRAMES;
  __shared__ float xs[S0 * L0_FRAMES + K0];
  const float* xb = x + (size_t)b * n_samples;
  for (int i = threadIdx.x; i < S0 * L0_FRAMES + K0; i += blockDim.x) {
    int s = S0 * f0 + i;
    xs[i] = s < n_samples ? round_bf16(xb[s]) : 0.f;
  }
  const int c = 2 * threadIdx.x;
  float w[K0][2];
#pragma unroll
  for (int j = 0; j < K0; ++j) {
    w[j][0] = round_bf16(w0[j * C + c]);
    w[j][1] = round_bf16(w0[j * C + c + 1]);
  }
  const float s0 = gs[b * C + c], s1 = gs[b * C + c + 1];
  const float b0 = gb[b * C + c], b1 = gb[b * C + c + 1];
  __syncthreads();
  const int n = min(L0_FRAMES, t0 - f0);
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * t0 + f0) * C + c);
  for (int t = 0; t < n; ++t) {
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < K0; ++j) {
      y0 = fmaf(xs[S0 * t + j], w[j][0], y0);
      y1 = fmaf(xs[S0 * t + j], w[j][1], y1);
    }
    ob[(size_t)t * (C / 2)] = __floats2bfloat162_rn(gelu(y0 * s0 + b0), gelu(y1 * s1 + b1));
  }
}

}  // namespace

// x: (B, L) f32; feat_len: (B,) int32 valid layer-0 windows (each in
// [0, T0]); w0: (10, 512) f32; gn_scale/gn_bias: (512,) f32; w_stack: the
// layer 1-6 kernels, each transposed to (512 out, k*512) bf16 (column
// j*512 + c is tap j, input channel c), back to back; partials:
// (B, 64, 65) f32; gs, gb: (B, 512) f32; buf0: (B, T0, 512) bf16;
// buf1: (B, T1, 512) bf16; out: (B, T6, 512) bf16.
extern "C" int a2f_conv_encoder(const float* x, const int* feat_len,
                                const float* w0, const float* gn_scale,
                                const float* gn_bias,
                                const void* w_stack, float* partials,
                                float* gs, float* gb, void* buf0, void* buf1,
                                void* out, int batch, int n_samples,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t0 = out_len(n_samples, K0, S0);
  if (t0 < 1) return cudaErrorInvalidValue;
  conv0_moments<<<dim3(MOM_BLOCKS, batch), 256, 0, s>>>(x, feat_len, partials, n_samples);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_fold<<<batch, C, 0, s>>>(partials, feat_len, w0, gn_scale, gn_bias, gs, gb);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv0_gelu<<<dim3((t0 + L0_FRAMES - 1) / L0_FRAMES, batch), C / 2, 0, s>>>(
      x, w0, gs, gb, static_cast<__nv_bfloat16*>(buf0), n_samples, t0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return gemm_layers<false>(w_stack, buf0, buf1, out, batch, t0, nullptr, nullptr, nullptr, s);
}

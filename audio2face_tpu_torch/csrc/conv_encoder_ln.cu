// WavLM Large's conv feature encoder for Hopper (sm_90a): the layer-norm
// stack. The JAX package has no WavLM; this is conv_encoder.cu's stack
// (the same 7 convs, 512 channels, no bias) with a LayerNorm over the 512
// channels after every conv, then the exact GELU: waveform (B, L) f32 ->
// (B, T6, 512) bf16. Bound as conv_encoder.cu's (~2.3e12 FLOP of bf16
// products for 8 x 60 s; the norms add no products worth counting). A
// per-frame norm needs no length mask and no moments pass:
//   2'. conv0_ln_gelu: layer 0 is linear in a frame's 10 samples x, so the
//      frame's channel mean is wbar . x and its variance x^T S x, with wbar
//      the kernel's mean over channels and S = (W - wbar)(W - wbar)^T / 512
//      its centred second moment (the wrapper computes both in f64 from the
//      bf16-rounded kernel). The centred form has no E[y^2] - mean^2 to
//      cancel. 64 threads compute a block's 64 frames' statistics into
//      shared memory; then every thread normalizes its 2 channels, applies
//      the affine and the GELU on the f32 sums and rounds once.
//   3'. conv_gemm_wgmma<true>, once per layer 1-6, each block pair a
//      cluster (conv_encoder.cuh).
// The wav2vec2-Conformer's stack is the same with a bias on every conv
// (conv_bias non-null): conv 0's output gains b, so its channel mean gains
// bbar and its variance the cross term e . x, e = 2 (W - wbar)(b - bbar) / 512,
// and |b - bbar|^2 / 512 (the wrapper appends e, bbar and that to the
// statistics); layers 1-6 add b to the accumulators before their
// statistics. A null conv_bias runs WavLM's stack as before.

#include "conv_encoder.cuh"

namespace {

constexpr int NSTATS = K0 + K0 * (K0 + 1) / 2;  // wbar, then S's upper triangle
constexpr int NSTATS_BIAS = NSTATS + K0 + 2;     // then e, bbar and the bias's variance

// ln_stats: wbar (10), then S's upper triangle row by row with the
// off-diagonal entries doubled (55): mean = wbar . x, var = sum_{j<=k} s_jk x_j x_k;
// with conv_bias (conv 0's, f32) also e (10), bbar and |b - bbar|^2 / 512:
// mean += bbar, var += e . x + |b - bbar|^2 / 512
__global__ void __launch_bounds__(C / 2)
conv0_ln_gelu(const float* __restrict__ x, const float* __restrict__ w0,
              const float* __restrict__ ln_stats, const float* __restrict__ ln_scale,
              const float* __restrict__ ln_bias, const float* __restrict__ conv_bias,
              __nv_bfloat16* __restrict__ out, int n_samples, int t0) {
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * L0_FRAMES;
  __shared__ float xs[S0 * L0_FRAMES + K0];
  __shared__ float st[NSTATS_BIAS];
  __shared__ float mu[L0_FRAMES], rs[L0_FRAMES];
  const float* xb = x + (size_t)b * n_samples;
  for (int i = threadIdx.x; i < S0 * L0_FRAMES + K0; i += blockDim.x) {
    int s = S0 * f0 + i;
    xs[i] = s < n_samples ? round_bf16(xb[s]) : 0.f;
  }
  if (threadIdx.x < (conv_bias != nullptr ? NSTATS_BIAS : NSTATS))
    st[threadIdx.x] = ln_stats[threadIdx.x];
  const int c = 2 * threadIdx.x;
  float w[K0][2];
#pragma unroll
  for (int j = 0; j < K0; ++j) {
    w[j][0] = round_bf16(w0[j * C + c]);
    w[j][1] = round_bf16(w0[j * C + c + 1]);
  }
  const float g0 = ln_scale[c], g1 = ln_scale[c + 1];
  const float b0 = ln_bias[c], b1 = ln_bias[c + 1];
  __syncthreads();
  const int n = min(L0_FRAMES, t0 - f0);
  if (threadIdx.x < n) {  // one frame's statistics a thread
    const float* xt = xs + S0 * threadIdx.x;
    float m = 0.f, v = 0.f;
    int p = K0;
#pragma unroll
    for (int j = 0; j < K0; ++j) {
      m = fmaf(st[j], xt[j], m);
#pragma unroll
      for (int k = j; k < K0; ++k) v = fmaf(st[p++] * xt[j], xt[k], v);
    }
    if (conv_bias != nullptr) {
#pragma unroll
      for (int j = 0; j < K0; ++j) v = fmaf(st[NSTATS + j], xt[j], v);
      m += st[NSTATS + K0];
      v += st[NSTATS + K0 + 1];
    }
    mu[threadIdx.x] = m;
    rs[threadIdx.x] = rsqrtf(fmaxf(v, 0.f) + EPS);
  }
  __syncthreads();
  __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * t0 + f0) * C + c);
  for (int t = 0; t < n; ++t) {
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < K0; ++j) {
      y0 = fmaf(xs[S0 * t + j], w[j][0], y0);
      y1 = fmaf(xs[S0 * t + j], w[j][1], y1);
    }
    if (conv_bias != nullptr) {
      y0 += conv_bias[c];
      y1 += conv_bias[c + 1];
    }
    const float m = mu[t], r = rs[t];
    ob[(size_t)t * (C / 2)] =
        __floats2bfloat162_rn(gelu(fmaf((y0 - m) * r, g0, b0)), gelu(fmaf((y1 - m) * r, g1, b1)));
  }
}

}  // namespace

// x: (B, L) f32; w0: (10, 512) f32; w_stack: the layer 1-6 kernels as
// a2f_conv_encoder takes them; buf0, buf1, out as there;
// ln_stats: (65,) f32, layer 0's wbar and doubled-off-diagonal S (2'),
// (77,) with conv_bias; ln_scale, ln_bias: (7, 512) f32, each conv's
// LayerNorm affine; conv_bias: (7, 512) f32, each conv's bias, or null.
extern "C" int a2f_conv_encoder_ln(const float* x, const float* w0, const float* ln_stats,
                                   const float* ln_scale, const float* ln_bias,
                                   const float* conv_bias, const void* w_stack, void* buf0,
                                   void* buf1, void* out, int batch, int n_samples,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t0 = out_len(n_samples, K0, S0);
  if (t0 < 1) return cudaErrorInvalidValue;
  conv0_ln_gelu<<<dim3((t0 + L0_FRAMES - 1) / L0_FRAMES, batch), C / 2, 0, s>>>(
      x, w0, ln_stats, ln_scale, ln_bias, conv_bias, static_cast<__nv_bfloat16*>(buf0),
      n_samples, t0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm_layers<true>(w_stack, buf0, buf1, out, batch, t0, ln_scale, ln_bias, conv_bias, s);
}

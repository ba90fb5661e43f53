// wav2vec2 conv feature encoder for Hopper (sm_90a).
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
//   3. strided_conv_gemm, once per layer 1-6: the layer is a GEMM whose A
//      row t is the contiguous slice h[2t : 2t + k] (k*512 values; the
//      TPU's pairing trick in general form), B is the (k*512, 512) kernel;
//      WMMA bf16 tiles with f32 accumulation, cp.async double buffering,
//      GELU in the epilogue.
// The GELU is the exact erf form (erff).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int C = 512;
constexpr int K0 = 10, S0 = 5;
constexpr int NMOM = 10 + 55;  // window sums + upper-triangle products
constexpr int MOM_BLOCKS = 64;  // partial-sum blocks per item
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

constexpr int L0_FRAMES = 64;

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

// ---- 3. layers 1-6: strided conv as a GEMM -----------------------------

constexpr int BM = 128, BN = 128, BKT = 32;
constexpr int GEMM_THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int AP = BKT + 8;        // smem pitches (bf16 elements)
constexpr int BP = BN + 8;
constexpr int CP = BN + 4;         // epilogue pitch (floats)
constexpr int STAGE = BM * AP + BKT * BP;  // bf16 elements per stage
constexpr int GEMM_SMEM =
    (2 * STAGE * 2 > BM * CP * 4) ? 2 * STAGE * 2 : BM * CP * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// out[b, t, :] = gelu(h[b, 2t : 2t + k, :] (flattened) @ w), w: (k*512, 512)
__global__ void __launch_bounds__(GEMM_THREADS)
strided_conv_gemm(const __nv_bfloat16* __restrict__ h,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, int t_in, int t_out,
                  int k_taps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kdim = k_taps * C;
  const __nv_bfloat16* hb = h + (size_t)b * t_in * C;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* As = sm + stage * STAGE;
    __nv_bfloat16* Bs = As + BM * AP;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GEMM_THREADS;  // 512 chunks of 8 values in A
      int r = chunk / 4, c = chunk % 4;
      int t = m0 + r;
      bool ok = t < t_out;
      const __nv_bfloat16* src = hb + (size_t)(ok ? 2 * t : 0) * C + k0 + 8 * c;
      cp_async16(As + r * AP + 8 * c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GEMM_THREADS;  // 512 chunks of 8 values in B
      int r = chunk / 16, c = chunk % 16;
      const __nv_bfloat16* src = w + (size_t)(k0 + r) * C + n0 + 8 * c;
      cp_async16(Bs + r * BP + 8 * c, src, true);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = kdim / BKT;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BKT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* As = sm + (kt & 1) * STAGE;
    const __nv_bfloat16* Bs = As + BM * AP;
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + 16 * i) * AP + kk, AP);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * BP + wn * 32 + 16 * j, BP);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: accumulators -> smem -> GELU -> bf16, 16-byte stores
  float* Cs = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + 16 * i) * CP + wn * 32 + 16 * j,
                              acc[i][j], CP, wmma::mem_row_major);
  __syncthreads();
  for (int chunk = tid; chunk < BM * BN / 8; chunk += GEMM_THREADS) {
    int r = chunk / (BN / 8), c = chunk % (BN / 8);
    int t = m0 + r;
    if (t >= t_out) continue;
    const float* src = Cs + r * CP + 8 * c;
    __align__(16) __nv_bfloat162 v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = __floats2bfloat162_rn(gelu(src[2 * e]), gelu(src[2 * e + 1]));
    *reinterpret_cast<uint4*>(out + ((size_t)b * t_out + t) * C + n0 + 8 * c) =
        *reinterpret_cast<uint4*>(v);
  }
}

constexpr int KERNEL[7] = {10, 3, 3, 3, 3, 2, 2};

int out_len(int n, int k, int s) { return (n - k) / s + 1; }

}  // namespace

// x: (B, L) f32; feat_len: (B,) int32 valid layer-0 windows (each in
// [0, T0]); w0: (10, 512) f32; gn_scale/gn_bias: (512,) f32; w_stack: the
// layer 1-6 kernels, each (k, 512, 512) bf16, back to back; partials:
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

  err = cudaFuncSetAttribute(strided_conv_gemm,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(w_stack);
  __nv_bfloat16* bufs[2] = {static_cast<__nv_bfloat16*>(buf0),
                            static_cast<__nv_bfloat16*>(buf1)};
  int t_in = t0;
  for (int layer = 1; layer < 7; ++layer) {
    const int k = KERNEL[layer];
    const int t_out = out_len(t_in, k, 2);
    if (t_out < 1) return cudaErrorInvalidValue;
    const __nv_bfloat16* src = bufs[(layer + 1) % 2];
    __nv_bfloat16* dst = layer == 6 ? static_cast<__nv_bfloat16*>(out) : bufs[layer % 2];
    dim3 grid((t_out + BM - 1) / BM, C / BN, batch);
    strided_conv_gemm<<<grid, GEMM_THREADS, GEMM_SMEM, s>>>(src, w, dst, t_in, t_out, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    w += (size_t)k * C * C;
    t_in = t_out;
  }
  return cudaSuccess;
}

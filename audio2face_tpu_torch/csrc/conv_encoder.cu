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
//   3. conv_gemm_wgmma, once per layer 1-6: the layer is a GEMM whose A
//      row t is the slice h[2t : 2t + k] (k*512 values; the TPU's pairing
//      trick in general form) and B the kernel. A 128 x 256 output tile
//      per block, two warpgroups of 64 rows each issue Hopper wgmma
//      (m64n256k16, f32 accumulators in registers) on 64-deep tiles. The
//      tiles come by TMA into a four-stage ring, two tiles ahead, one
//      thread issuing each tile and an mbarrier reporting it: A as rows
//      2t + j of h (one box with a row stride of 2 for tap j), B from the
//      kernel transposed to K-major by the wrapper, both in the 128-byte
//      swizzle. (cp.async copies of the same tiles held layer 1 at 18% of
//      the tensor peak: they delivered ~9 bytes a clock to an SM.) Each
//      warpgroup keeps one group of products in flight while the next
//      tile's barrier passes; the GELU and the bf16 rounding run on the
//      accumulator registers, which are stored as they are. The two blocks
//      of an A tile run side by side, so A comes from device memory once.
// The GELU is the exact erf form (erff).

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

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

// ---- 3. layers 1-6: strided conv as a GEMM on wgmma ---------------------

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int GEMM_THREADS = 256;  // two warpgroups, 64 output rows each
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
// 1024 bytes of slack to align the ring for the 128-byte swizzle, then one
// mbarrier a stage
constexpr int GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + STAGES * 8;

// out[b, t, :] = gelu(sum_j h[b, 2t + j, :] @ w_j): k-tile kt is tap
// j = kt / 8, input channels 64 (kt % 8)... Its A tile is rows 2t + j of h
// (one TMA box with a row stride of 2), its B tile rows n0... of the
// transposed kernel (512, k*512), columns 64 kt...; both K-major in the
// 128-byte swizzle. Grid: (512 / BN, M tiles, batch), so the blocks that
// share an A tile run side by side and read it from L2.
__global__ void __launch_bounds__(GEMM_THREADS, 1)
conv_gemm_wgmma(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
                __nv_bfloat16* __restrict__ out, int t_out, int k_taps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // mbarrier of stage s at full + 8 s
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, wg = tid / 128;
  const int nk = k_taps * C / BK;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(full + 8 * st, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  auto issue = [&](int kt) {  // tile kt's two boxes into its stage, if there is one
    if (tid == 0 && kt < nk) {
      const uint32_t stage = ring + (kt % STAGES) * STAGE_BYTES, bar = full + 8 * (kt % STAGES);
      mbar_expect_tx(bar, STAGE_BYTES);
      tma_load_3d(stage, &tm_h, (kt % (C / BK)) * BK, 2 * m0 + kt / (C / BK), b, bar);
      tma_load_2d(stage + A_BYTES, &tm_w, kt * BK, n0, bar);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  issue(0);
  issue(1);
  // Tile kt: wait for its boxes (tile kt + 1's may still fly); one barrier
  // frees the stage of tile kt - 2, whose products both warpgroups retired
  // in the last iteration (each keeps one group of products in flight):
  // tile kt + 2 goes there.
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(full + 8 * (kt % STAGES), (kt / STAGES) & 1);
    __syncthreads();
    issue(kt + 2);
    const uint32_t stage = ring + (kt % STAGES) * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n256(acc, desc_sw128(stage + 64 * wg * BK * 2 + 32 * kk),
                    desc_sw128(stage + A_BYTES + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue on the registers: acc[4j + 2hh + e] is row 16 w + l/4 + 8 hh,
  // column 8j + 2(l % 4) + e of this warpgroup's 64 x BN tile
  const int wq = (tid % 128) / 32, l = tid % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = m0 + 64 * wg + 16 * wq + l / 4 + 8 * hh;
    if (t >= t_out) continue;
    __nv_bfloat16* orow = out + ((size_t)b * t_out + t) * C + n0 + 2 * (l % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(gelu(acc[4 * j + 2 * hh]), gelu(acc[4 * j + 2 * hh + 1]));
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess || found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with a 128-byte-swizzled box of `box` (elements, the
// first 64 wide) at `elem_stride`
bool encode(CUtensorMap* tm, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, const cuuint32_t* elem_stride) {
  EncodeTiled fn = encode_tiled();
  return fn && fn(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
                  box, elem_stride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one layer: h (batch, t_in, 512) -> out (batch, t_out, 512); w the
// transposed kernel (512, k*512)
cudaError_t conv_layer(const __nv_bfloat16* h, const __nv_bfloat16* w, __nv_bfloat16* out,
                       int batch, int t_in, int t_out, int k, cudaStream_t s) {
  CUtensorMap tm_h, tm_w;
  const cuuint64_t h_dims[3] = {C, (cuuint64_t)t_in, (cuuint64_t)batch};
  const cuuint64_t h_strides[2] = {C * 2, (cuuint64_t)t_in * C * 2};
  const cuuint32_t h_box[3] = {BK, 2 * BM, 1}, h_step[3] = {1, 2, 1};  // every other row
  const cuuint64_t w_dims[2] = {(cuuint64_t)k * C, C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)k * C * 2};
  const cuuint32_t w_box[2] = {BK, BN}, w_step[2] = {1, 1};
  if (!encode(&tm_h, h, 3, h_dims, h_strides, h_box, h_step) ||
      !encode(&tm_w, w, 2, w_dims, w_strides, w_box, w_step))
    return cudaErrorInvalidValue;
  dim3 grid(C / BN, (t_out + BM - 1) / BM, batch);
  conv_gemm_wgmma<<<grid, GEMM_THREADS, GEMM_SMEM, s>>>(tm_h, tm_w, out, t_out, k);
  return cudaGetLastError();
}

constexpr int KERNEL[7] = {10, 3, 3, 3, 3, 2, 2};

int out_len(int n, int k, int s) { return (n - k) / s + 1; }

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

  err = cudaFuncSetAttribute(conv_gemm_wgmma,
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
    if ((err = conv_layer(src, w, dst, batch, t_in, t_out, k, s)) != cudaSuccess) return err;
    w += (size_t)k * C * C;
    t_in = t_out;
  }
  return cudaSuccess;
}

// K2's shared part: the layer 1-6 GEMM of the conv feature encoder
// (conv_gemm_wgmma) in its two norm modes, and what both stacks take from
// it (constants, the exact GELU, tensor maps, the layer loop). Two
// libraries include it: conv_encoder.cu, the group-norm stack
// (wav2vec2-base), and conv_encoder_ln.cu, the layer-norm stack (WavLM
// Large). Each instantiates one mode: compiled in one module with the
// layer-norm GEMM, the group-norm GEMM comes out of ptxas with the same
// instructions in another order, so the modes keep to their own
// translation units and the group-norm code compiles as it did alone.
//
// conv_gemm_wgmma, once per layer 1-6: the layer is a GEMM whose A row t is
// the slice h[2t : 2t + k] (k*512 values; the TPU's pairing trick in
// general form) and B the kernel. A 128 x 256 output tile per block, two
// warpgroups of 64 rows each issue Hopper wgmma (m64n256k16, f32
// accumulators in registers) on 64-deep tiles. The tiles come by TMA into a
// four-stage ring, two tiles ahead, one thread issuing each tile and an
// mbarrier reporting it: A as rows 2t + j of h (one box with a row stride
// of 2 for tap j), B from the kernel transposed to K-major by the wrapper,
// both in the 128-byte swizzle. (cp.async copies of the same tiles held
// layer 1 at 18% of the tensor peak: they delivered ~9 bytes a clock to an
// SM.) Each warpgroup keeps one group of products in flight while the next
// tile's barrier passes; the epilogue runs on the accumulator registers,
// which are stored as they are. The two blocks of an A tile run side by
// side, so A comes from device memory once.
//   - group norm (LN false): the GELU and the bf16 rounding;
//   - layer norm (LN true): no block holds a whole 512-channel row, so the
//     two blocks of an A tile run as a thread-block cluster of 2. Each row
//     of a warpgroup's tile lives in one quad of lanes: a thread sums its 64
//     accumulators of the row, the quad adds by shuffles, and the two
//     blocks add each other's 128 row partials through distributed shared
//     memory after a cluster barrier: the mean first, then the squared
//     deviations from it (two passes, so the variance does not cancel).
//     Both blocks add the same two numbers, so they use the same
//     statistics. Then the affine, the GELU and one bf16 rounding. A conv
//     bias (the wav2vec2-Conformer's stack; null for WavLM's) is added to
//     the accumulators first, so the statistics are the biased output's.
// The GELU is the exact erf form (erff).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int C = 512;
constexpr int K0 = 10, S0 = 5;
constexpr float EPS = 1e-5f;
constexpr int L0_FRAMES = 64;  // layer-0 frames a block of either conv0 kernel

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- layers 1-6: strided conv as a GEMM on wgmma -----------------------

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int GEMM_THREADS = 256;  // two warpgroups, 64 output rows each
constexpr int A_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
// 1024 bytes of slack to align the ring for the 128-byte swizzle, then one
// mbarrier a stage
constexpr int GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + STAGES * 8;

// layer-norm mode: the cluster of the two blocks of an A tile
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the address of shared-memory address `addr` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// out[b, t, :] = gelu(sum_j h[b, 2t + j, :] @ w_j): k-tile kt is tap
// j = kt / 8, input channels 64 (kt % 8)... Its A tile is rows 2t + j of h
// (one TMA box with a row stride of 2), its B tile rows n0... of the
// transposed kernel (512, k*512), columns 64 kt...; both K-major in the
// 128-byte swizzle. Grid: (512 / BN, M tiles, batch), so the blocks that
// share an A tile run side by side and read it from L2. LN: the layer-norm
// epilogue (ln_scale, ln_bias: the layer's affine, f32; conv_bias: the
// conv's f32 bias or null), launched with those two blocks as a cluster;
// the group-norm stack passes nulls.
template <bool LN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
conv_gemm_wgmma(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
                __nv_bfloat16* __restrict__ out, int t_out, int k_taps,
                const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                const float* __restrict__ conv_bias) {
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
  if constexpr (!LN) {
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
  } else {
    // this block's partials of its 128 rows: [0] sums, [1] squared deviations
    __shared__ float part[2][BM];
    const int r0 = 64 * wg + 16 * wq + l / 4;  // the thread's rows r0 and r0 + 8
    const uint32_t peer = map_rank(smem_u32(&part[0][0]), cluster_rank() ^ 1u);
    float mean[2], rstd[2], own[2];
    if (conv_bias != nullptr) {
      const float2* cb = reinterpret_cast<const float2*>(conv_bias + n0) + l % 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 bj = cb[4 * j];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          acc[4 * j + 2 * hh] += bj.x;
          acc[4 * j + 2 * hh + 1] += bj.y;
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) s += acc[4 * j + 2 * hh] + acc[4 * j + 2 * hh + 1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      own[hh] = s;
      if (l % 4 == 0) part[0][r0 + 8 * hh] = s;
    }
    cluster_arrive();
    cluster_wait();  // both blocks' sums are written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mean[hh] = (own[hh] + ld_cluster(peer + 4 * (r0 + 8 * hh))) * (1.f / C);
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float d0 = acc[4 * j + 2 * hh] - mean[hh], d1 = acc[4 * j + 2 * hh + 1] - mean[hh];
        q = fmaf(d0, d0, fmaf(d1, d1, q));
      }
      q += __shfl_xor_sync(0xffffffffu, q, 1);
      q += __shfl_xor_sync(0xffffffffu, q, 2);
      own[hh] = q;
      if (l % 4 == 0) part[1][r0 + 8 * hh] = q;
    }
    cluster_arrive();
    cluster_wait();  // both blocks' squared deviations are written
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float var = (own[hh] + ld_cluster(peer + 4 * (BM + r0 + 8 * hh))) * (1.f / C);
      rstd[hh] = rsqrtf(var + EPS);
    }
    cluster_arrive();  // this block is done reading the peer's partials
    const float2* g2 = reinterpret_cast<const float2*>(ln_scale + n0) + l % 4;
    const float2* b2 = reinterpret_cast<const float2*>(ln_bias + n0) + l % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 g = g2[4 * j], bb = b2[4 * j];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = m0 + r0 + 8 * hh;
        if (t < t_out) {
          const float z0 = (acc[4 * j + 2 * hh] - mean[hh]) * rstd[hh];
          const float z1 = (acc[4 * j + 2 * hh + 1] - mean[hh]) * rstd[hh];
          *reinterpret_cast<uint32_t*>(out + ((size_t)b * t_out + t) * C + n0 + 2 * (l % 4) + 8 * j) =
              pack_bf16(gelu(fmaf(z0, g.x, bb.x)), gelu(fmaf(z1, g.y, bb.y)));
        }
      }
    }
    cluster_wait();  // the peer is done reading this block's partials before it leaves
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
// transposed kernel (512, k*512); LN: the layer's LayerNorm (ln_scale,
// ln_bias) after its conv bias (or null), each block pair along N a cluster
template <bool LN>
cudaError_t conv_layer(const __nv_bfloat16* h, const __nv_bfloat16* w, __nv_bfloat16* out,
                       int batch, int t_in, int t_out, int k, const float* ln_scale,
                       const float* ln_bias, const float* conv_bias, cudaStream_t s) {
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
  if constexpr (!LN) {
    conv_gemm_wgmma<false><<<grid, GEMM_THREADS, GEMM_SMEM, s>>>(tm_h, tm_w, out, t_out, k,
                                                                  nullptr, nullptr, nullptr);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(GEMM_THREADS);
    cfg.dynamicSmemBytes = GEMM_SMEM;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C / BN;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, conv_gemm_wgmma<true>, tm_h, tm_w, out, t_out, k,
                                         ln_scale, ln_bias, conv_bias);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
}

constexpr int KERNEL[7] = {10, 3, 3, 3, 3, 2, 2};

int out_len(int n, int k, int s) { return (n - k) / s + 1; }

// layers 1-6 from buf0 (layer 0's output, t0 rows) to out; LN: each
// layer's affine at ln_scale + 512 layer, ln_bias + 512 layer, and its conv
// bias at conv_bias + 512 layer (conv_bias null: none)
template <bool LN>
cudaError_t gemm_layers(const void* w_stack, void* buf0, void* buf1, void* out, int batch, int t0,
                        const float* ln_scale, const float* ln_bias, const float* conv_bias,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv_gemm_wgmma<LN>,
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
    err = conv_layer<LN>(src, w, dst, batch, t_in, t_out, k,
                         LN ? ln_scale + layer * C : nullptr, LN ? ln_bias + layer * C : nullptr,
                         LN && conv_bias ? conv_bias + layer * C : nullptr, s);
    if (err != cudaSuccess) return err;
    w += (size_t)k * C * C;
    t_in = t_out;
  }
  return cudaSuccess;
}

}  // namespace

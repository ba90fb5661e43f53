// The frame models' conv-block epilogue for Hopper (sm_90a): conv bias,
// BatchNorm with running statistics and ReLU in one pass over an NCHW
// tensor, each stage optional, in place or into another tensor.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into the convolution's consumer. PyTorch runs it as up to six
// passes over the conv's output (the bias add, a cast to f32, a subtract, a
// multiply, an add, a cast back, then ReLU): ~52 bytes of device traffic for
// each bf16 element.
//
// Bound: bytes. Each element is read once and written once (4 bytes in
// bf16, 8 in f32); the per-channel vectors are a few KB and stay in L1/L2.
// At Audio2Mesh's 1,024 rows a chunk the analysis convs write ~223 M
// elements, ~0.9 GB both ways in bf16: ~0.27 ms at 3.35 TB/s. Design:
//
// - grid.y walks the batch rows (a stride loop past 65,535), grid.x one
//   row's C x H x W elements, so the index inside a row fits 32 bits and the
//   channel is one 32-bit division;
// - where H x W is a multiple of a 16-byte vector (8 bf16, 4 f32) and both
//   pointers are 16-byte aligned, a thread moves one vector, whose elements
//   share a channel: one division and one set of per-channel loads a vector
//   (every Audio2Mesh analysis layer, H x W = 64 x 16 ... 64 x 1). Else one
//   element a thread (the articulation tail, H x W = 4 and 1).
//
// Numerics: the steps of PyTorch's composition in its order, with its
// roundings and no contraction into fused multiply-adds (the wrapper's plain
// version is that composition):
//   1. bias:  v = T(float(x) + float(bias))      (a T-typed add_)
//   2. BN:    v = T(((float(v) - mean) * mul) + beta), f32 throughout,
//             mul = rsqrt(var + eps) * weight computed by PyTorch
//   3. ReLU:  v = isnan(v) ? v : max(v, 0)        (clamp_min's NaN rule)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
struct Stages {
  const T* bias;      // (C,) or null
  const float* mean;  // (C,) each, or all null
  const float* mul;
  const float* beta;
  int relu;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// V consecutive elements of channel c of one row, x and y V-aligned. x and y
// may be one tensor (no __restrict__): each element is read once, then
// written by the thread that read it.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
frame_epilogue_kernel(const T* x, T* y, int rows, int row_len, int hw, Stages<T> s) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (j >= row_len) return;
  const int c = j / hw;
  const float b = s.bias ? to_float(s.bias[c]) : 0.f;
  float mean = 0.f, mul = 0.f, beta = 0.f;
  if (s.mean) {
    mean = s.mean[c];
    mul = s.mul[c];
    beta = s.beta[c];
  }
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const size_t off = (size_t)r * row_len + j;
    Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(x + off);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      T v = p.v[k];
      if (s.bias) v = from_float<T>(__fadd_rn(to_float(v), b));
      if (s.mean) v = from_float<T>(__fadd_rn(__fmul_rn(__fsub_rn(to_float(v), mean), mul), beta));
      if (s.relu) {
        const float f = to_float(v);
        if (!isnan(f)) v = from_float<T>(fmaxf(f, 0.f));
      }
      p.v[k] = v;
    }
    *reinterpret_cast<Pack<T, V>*>(y + off) = p;
  }
}

template <typename T, int V>
int launch(const void* x, void* y, int rows, int row_len, int hw, Stages<T> s,
           cudaStream_t stream) {
  const int per_row = row_len / V;
  const int threads = per_row < THREADS ? (per_row + 31) / 32 * 32 : THREADS;
  const dim3 grid((per_row + threads - 1) / threads, rows < MAX_GRID_Y ? rows : MAX_GRID_Y);
  frame_epilogue_kernel<T, V><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, row_len, hw, s);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, void* y, int rows, int channels, int hw, const void* bias,
             const float* mean, const float* mul, const float* beta, int relu, int vector,
             cudaStream_t stream) {
  const Stages<T> s{static_cast<const T*>(bias), mean, mul, beta, relu};
  const int row_len = channels * hw;
  if (vector) return launch<T, 16 / sizeof(T)>(x, y, rows, row_len, hw, s, stream);
  return launch<T, 1>(x, y, rows, row_len, hw, s, stream);
}

}  // namespace

// x, y: (rows, channels, hw) contiguous, y == x for in place; dtype 0 = f32,
// 1 = bf16; bias in x's dtype or null; mean, mul, beta f32 or null
// together; vector: 1 where hw is a multiple of 16 bytes' elements and both
// pointers are 16-byte aligned (the wrapper checks).
extern "C" int a2f_frame_epilogue(const void* x, void* y, int dtype, int rows, int channels,
                                  int hw, const void* bias, const float* mean, const float* mul,
                                  const float* beta, int relu, int vector, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, y, rows, channels, hw, bias, mean, mul, beta, relu, vector,
                                   st);
  return dispatch<float>(x, y, rows, channels, hw, bias, mean, mul, beta, relu, vector, st);
}

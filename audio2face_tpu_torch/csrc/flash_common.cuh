// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu): per-type traits, the ALiBi floor
// division and the dropout hash. One copy, so that the backward regenerates
// the forward's bias and keep mask bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int PAD = 8;  // keeps WMMA rows 32-byte aligned
  __device__ static float exp(float x) { return __expf(x); }
};

template <>
struct Traits<float> {
  static constexpr int PAD = 1;  // odd pitch: conflict-free scalar columns
  __device__ static float exp(float x) { return expf(x); }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;  // C truncates toward zero; floor for negative remainders
  return q - ((a % b != 0) && ((a < 0) != (b < 0)));
}

// Dropout keep multiplier (0 or keep_scale) of one position: the JAX
// package's _dropout_keep_tile bit for bit. Its int32 multiplies wrap and
// its right shifts are logical, which is plain uint32 arithmetic here.
__device__ __forceinline__ float dropout_keep(uint32_t seed, uint32_t bh, uint32_t row,
                                              uint32_t col, uint32_t thr, float keep_scale) {
  uint32_t h = (row * 0x9E3779B9u) ^ (col * 0x85EBCA6Bu) ^ (seed + bh * 0xC2B2AE35u);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x8363F812u;
  h ^= h >> 16;
  return (h & 0x7FFFFFFFu) >= thr ? keep_scale : 0.f;
}

}  // namespace

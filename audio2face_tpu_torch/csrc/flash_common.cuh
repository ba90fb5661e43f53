// Device helpers shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu): the ALiBi floor division and the
// dropout hash. One copy, so that the backward regenerates the forward's
// bias and keep mask bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x on the SFU (what __expf(x) computes after multiplying by log2 e);
// the bf16 kernels fold log2 e into the score scale instead
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

// The dropout hash's batch*head index of slice bh of a launch with `local`
// heads. A launch may compute a slice of a larger call: a data-parallel
// rank's rows (batch offset b0) and a tensor-parallel rank's heads (head
// offset h0 of `heads` in all). The hash then takes the whole call's index
// (b0 + b) * heads + h0 + h, so each rank drops what the whole call drops.
// {0, 0, local} is the identity.
struct HashIndex {
  int b0, h0, heads;
  __device__ __forceinline__ uint32_t of(int bh, int local) const {
    return (uint32_t)((bh / local + b0) * heads + h0 + bh % local);
  }
};

}  // namespace

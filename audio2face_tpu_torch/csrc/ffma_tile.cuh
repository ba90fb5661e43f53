// Register-tiled f32 products on CUDA cores for the f32 attention kernels:
// the general (long-key) forward path of flash_attention.cu and both f32
// backward kernels of flash_attention_bwd.cu. f32 keeps f32 accuracy (the
// JAX kernels compute f32 at Precision.HIGHEST), so no tensor core is used:
// single-pass TF32 keeps ~3 decimal digits.
//
// A block of FT_NT = 128 threads (4 warps) owns FT_ROWS = 64 rows (query
// rows, or keys in the dk/dv kernel) and walks tiles of FT_COLS = 32 rows
// of the other operand, which stream through a cp.async ring. Tiles sit in
// shared memory row-major with a pitch of D + 4 floats, so that the 16-byte
// loads below are free of bank conflicts.
//
// Thread map (warp w, lane l, rg = (l % 32) / 8, cg = l % 8):
//   owned rows      16 w + rg + 4 i,  i < 4
//   walked columns  cg + 8 j,         j < 4   (score micro-tile, 4 x 4)
//   accumulator     D >= 32: 32 m + 4 cg + e (m < D / 32, e < 4);
//   columns (d)     D = 16:  2 cg + e (e < 2) (accumulator micro-tile 4 x D/8)
// A row's eight threads are the eight lanes of one rg, so row reductions are
// three xor shuffles, and a warp's rows are its own: the P or dS tile it
// hands to the accumulating product crosses shared memory between
// __syncwarp()s only, with no block barrier.
//
// Shared-memory loads per FMA: the score product reads 4 + 4 float4 per 4 x
// 4 x 4 FMAs (0.5 floats per FMA); the accumulating product reads 4 float4
// of P and 4 x D/8 floats of V per 4 x 4 x D/8 FMAs (0.375 at D = 64).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int FT_ROWS = 64;           // owned rows a block
constexpr int FT_COLS = 32;           // rows of a walked tile
constexpr int FT_NT = 128;            // threads a block
constexpr int FT_XP = FT_COLS + 8;    // pitch (floats) of a P or dS tile: conflict-free stores

template <int D>
struct FTile {
  static constexpr int TP = D + 4;                    // pitch (floats) of a q/k/v/dO tile
  static constexpr int OWNED_BYTES = FT_ROWS * TP * 4;
  static constexpr int WALKED_BYTES = FT_COLS * TP * 4;
  static constexpr int X_BYTES = FT_ROWS * FT_XP * 4; // a P or dS tile
  static constexpr int NV = D / 8;                    // accumulator columns a thread
  static constexpr int VEC = D >= 32 ? 4 : 2;         // ... in chunks of VEC floats
  static constexpr int NCH = NV / VEC;
};

struct FMap {
  int w, rg, cg;
  __device__ FMap() : w(threadIdx.x / 32), rg((threadIdx.x % 32) / 8), cg(threadIdx.x % 8) {}
  __device__ __forceinline__ int row(int i) const { return 16 * w + rg + 4 * i; }
  __device__ __forceinline__ int col(int j) const { return cg + 8 * j; }
  template <int D>
  __device__ __forceinline__ int acc_col(int m) const { return D >= 32 ? 32 * m + 4 * cg : 2 * cg; }
};

// rows [row0, row0 + ROWS) of a (T, D) f32 slab into a pitched tile by
// 16-byte asynchronous copies; rows at or past `valid` are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void ft_load_async(uint32_t tile, const float* src, int row0, int valid,
                                              int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  static_assert(ROWS * CPR % FT_NT == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / FT_NT; ++it) {
    const int idx = tid + it * FT_NT;
    const int r = idx / CPR, c = idx % CPR;
    const int g = row0 + r;
    const bool ok = g < valid;
    cp_async16(tile + (r * FTile<D>::TP + 4 * c) * 4, src + (size_t)(ok ? g : 0) * D + 4 * c, ok);
  }
}

// s[i][j] = A[row(i)] . B[col(j)] over D: the scores q k^T (or their
// transpose k q^T) and dP = dO v^T
template <int D>
__device__ __forceinline__ void ft_scores(const float* A, const float* B, const FMap& mp,
                                          float (&s)[4][4]) {
  constexpr int TP = FTile<D>::TP;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + mp.row(i) * TP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + mp.col(j) * TP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = s[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        s[i][j] = fmaf(a[i].w, b[j].w, t);
      }
  }
}

// this thread's 4 x 4 micro-tile of a P or dS tile into shared memory
__device__ __forceinline__ void ft_store_x(float* X, const FMap& mp, const float (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) X[mp.row(i) * FT_XP + mp.col(j)] = p[i][j];
}

// acc[i][.] += sum over the tile's 32 walked rows c of X[row(i)][c] Y[c][acc_col]:
// O += P V, dQ += dS K, dV += (m P)^T dO, dK += dS^T Q
template <int D>
__device__ __forceinline__ void ft_accumulate(const float* X, const float* Y, const FMap& mp,
                                              float (&acc)[4][FTile<D>::NV]) {
  using T = FTile<D>;
#pragma unroll 2
  for (int c = 0; c < FT_COLS; c += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *reinterpret_cast<const float4*>(X + mp.row(i) * FT_XP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float y[T::NV];
      const float* yr = Y + (c + cc) * T::TP;
#pragma unroll
      for (int m = 0; m < T::NCH; ++m) {
        if constexpr (T::VEC == 4) {
          const float4 t = *reinterpret_cast<const float4*>(yr + mp.acc_col<D>(m));
          y[4 * m] = t.x, y[4 * m + 1] = t.y, y[4 * m + 2] = t.z, y[4 * m + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(yr + mp.acc_col<D>(m));
          y[2 * m] = t.x, y[2 * m + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = cc == 0 ? x[i].x : cc == 1 ? x[i].y : cc == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int e = 0; e < T::NV; ++e) acc[i][e] = fmaf(xv, y[e], acc[i][e]);
      }
    }
  }
}

// row r of an accumulator, scaled, to `dst` (the row's first element)
template <int D>
__device__ __forceinline__ void ft_store_row(float* dst, const FMap& mp, const float (&a)[FTile<D>::NV],
                                             float scale) {
  using T = FTile<D>;
#pragma unroll
  for (int m = 0; m < T::NCH; ++m) {
    if constexpr (T::VEC == 4) {
      *reinterpret_cast<float4*>(dst + mp.acc_col<D>(m)) =
          make_float4(a[4 * m] * scale, a[4 * m + 1] * scale, a[4 * m + 2] * scale, a[4 * m + 3] * scale);
    } else {
      *reinterpret_cast<float2*>(dst + mp.acc_col<D>(m)) = make_float2(a[2 * m] * scale, a[2 * m + 1] * scale);
    }
  }
}

}  // namespace

// Chunk-culled tile rasterizer for Hopper (sm_90a).
//
// Replaces the TPU kernel audio2face_tpu/ops/rasterizer.py rasterize_keys
// (_raster_kernel). Every pixel gets the maximum over triangles of the
// packed key
//
//   (clip(1/z * (2^22 - 1), 1, 2^22 - 1) << 8) | shade byte,  0 = background
//
// where a triangle's barycentrics w0, w1, its 1/z and shade/z are planes
// a + b*px + c*py over the screen (12 coefficients per triangle, rows of 16
// floats), and triangles come in chunks of 128 with one screen bounding box
// per chunk.
//
// Bound: operations. A frame of ~10^4 triangles at 800 x 800 moves 3.2 MB
// (0.64 MB of coefficients read, 2.56 MB of keys written: under 1 us at the
// card's memory rate) but tests every pixel of a tile against every triangle
// of every chunk whose box overlaps the tile, about 7 f32 operations a test.
// Design: one block per (frame, tile of 16 rows x 128 columns), one thread
// per column, the 16 running maxima of its pixels in registers. The block
// walks the frame's chunk boxes in device memory (the TPU kernel prefetches
// them into scalar memory, which caps its batch; here any number of frames
// is one launch), skips a chunk that misses its tile (block-uniform branch),
// stages an overlapping chunk's 128 x 12 coefficients in shared memory
// (6 KB, coefficient-major so that a read is one broadcast) and lets every
// thread loop over the 128 triangles. No atomics, no scatter: deterministic.
// The output is written once, coalesced along a row, straight into
// (F, H, W).
//
// The evaluation order is the plain version's (ops/rasterizer.py
// rasterize_keys_reference), so that the two agree exactly: row 0 of a tile
// is (a + b*px) + c*py0, each next row adds c, and every product and sum is
// a rounded __fmul_rn / __fadd_rn that the compiler may not contract into a
// fused multiply-add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TRI_CHUNK = 128, STRIP_H = 16, XBLOCK = 128, N_COEF = 12, COEF_ROW = 16;
constexpr float IZ_MAX = 4194303.f;  // 2^22 - 1

__global__ void __launch_bounds__(XBLOCK)
raster_kernel(const float* __restrict__ coefs, const int* __restrict__ bbox,
              int* __restrict__ out, int n_chunks, int height, int width) {
  __shared__ float sc[N_COEF][TRI_CHUNK];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * XBLOCK, y_top = blockIdx.y * STRIP_H, f = blockIdx.z;
  const float px = (float)(x0 + tid) + 0.5f;  // exact: an integer below 2^23 plus a half
  const float py0 = (float)y_top + 0.5f;
  const int4* boxes = reinterpret_cast<const int4*>(bbox) + (size_t)f * n_chunks;
  const float* cf = coefs + (size_t)f * n_chunks * TRI_CHUNK * COEF_ROW;

  int key[STRIP_H];
#pragma unroll
  for (int r = 0; r < STRIP_H; ++r) key[r] = 0;

  for (int c = 0; c < n_chunks; ++c) {
    const int4 b = boxes[c];  // xmin, xmax, ymin, ymax; the same for the whole block
    if (b.z > y_top + STRIP_H - 1 || b.w < y_top || b.x > x0 + XBLOCK - 1 || b.y < x0) continue;
    __syncthreads();  // the previous chunk's readers are done
    {
      const float4* row =
          reinterpret_cast<const float4*>(cf + ((size_t)c * TRI_CHUNK + tid) * COEF_ROW);
      const float4 r0 = row[0], r1 = row[1], r2 = row[2];
      sc[0][tid] = r0.x; sc[1][tid] = r0.y; sc[2][tid] = r0.z; sc[3][tid] = r0.w;
      sc[4][tid] = r1.x; sc[5][tid] = r1.y; sc[6][tid] = r1.z; sc[7][tid] = r1.w;
      sc[8][tid] = r2.x; sc[9][tid] = r2.y; sc[10][tid] = r2.z; sc[11][tid] = r2.w;
    }
    __syncthreads();
    for (int i = 0; i < TRI_CHUNK; ++i) {
      const float a0 = sc[0][i], b0 = sc[1][i], c0 = sc[2][i];
      // a culled triangle's w0 is -1 on every pixel: it can never be inside
      if (a0 == -1.f && b0 == 0.f && c0 == 0.f) continue;
      const float a1 = sc[3][i], b1 = sc[4][i], c1 = sc[5][i];
      const float az = sc[6][i], bz = sc[7][i], cz = sc[8][i];
      const float as = sc[9][i], bs = sc[10][i], cs = sc[11][i];
      float w0 = __fadd_rn(__fadd_rn(a0, __fmul_rn(b0, px)), __fmul_rn(c0, py0));
      float w1 = __fadd_rn(__fadd_rn(a1, __fmul_rn(b1, px)), __fmul_rn(c1, py0));
      float iz = __fadd_rn(__fadd_rn(az, __fmul_rn(bz, px)), __fmul_rn(cz, py0));
      float soz = __fadd_rn(__fadd_rn(as, __fmul_rn(bs, px)), __fmul_rn(cs, py0));
#pragma unroll
      for (int r = 0; r < STRIP_H; ++r) {
        if (r) {
          w0 = __fadd_rn(w0, c0);
          w1 = __fadd_rn(w1, c1);
          iz = __fadd_rn(iz, cz);
          soz = __fadd_rn(soz, cs);
        }
        const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
        // false for a NaN plane, so no NaN is ever converted to an integer
        if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
          const float s = __fdiv_rn(soz, fmaxf(iz, 1e-12f));
          const int izq = (int)fminf(fmaxf(__fmul_rn(iz, IZ_MAX), 1.f), IZ_MAX);
          const int sq = (int)fminf(fmaxf(fminf(__fmul_rn(s, 255.f), 254.f), 0.f), 254.f);
          key[r] = max(key[r], (izq << 8) | sq);
        }
      }
    }
  }

  const int col = x0 + tid;
  if (col < width) {
    int* o = out + ((size_t)f * height + y_top) * width + col;
#pragma unroll
    for (int r = 0; r < STRIP_H; ++r) o[(size_t)r * width] = key[r];
  }
}

}  // namespace

// coefs: (F, n_chunks * 128, 16) f32; bbox: (F, n_chunks, 4) i32 [xmin, xmax,
// ymin, ymax]; out: (F, height, width) i32, height a multiple of 16.
extern "C" int a2f_rasterize_keys(const float* coefs, const int* bbox, int* out,
                                  int n_frames, int n_chunks, int height, int width,
                                  void* stream) {
  const dim3 grid((width + XBLOCK - 1) / XBLOCK, height / STRIP_H, n_frames);
  raster_kernel<<<grid, XBLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      coefs, bbox, out, n_chunks, height, width);
  return cudaGetLastError();
}

// Tile rasterizer for Hopper (sm_90a): per-warp edge-function culling, chunk
// copies in flight.
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
// Bound: bytes. The inputs need each live triangle tested on the pixels of
// its own screen box, about 7 f32 operations a pixel: ~10^6 tests a frame of
// the 5,023-vertex head at 800 x 800, microseconds at the card's f32 rate.
// The keys written (4 B a pixel) and the coefficients read (64 B a
// triangle) take longer at the memory rate, so the least time is the bytes'.
// What costs time instead is work the inputs do not need: testing pixels
// against triangles that cannot cover them. Design:
//
// - one block per (frame, tile of 16 rows x 128 columns), four warps, each
//   warp owning a 16 x 32 sub-tile: one lane per column, the column's 16
//   running maxima in registers; a warp whose sub-tile lies wholly right of
//   `width` does nothing;
// - the block tests the frame's chunk boxes against its tile, one box a
//   thread, and compacts the overlapping chunks with a ballot (128 chunks a
//   round); a tile that no chunk overlaps writes zeros and nothing else;
// - an overlapping chunk's coefficients (128 x 64 B = 8 KB, contiguous)
//   arrive by one bulk asynchronous copy (cp.async.bulk) onto an mbarrier,
//   into one of two buffers: the next chunk's copy is in flight while the
//   current one is culled and evaluated;
// - each warp culls the chunk's 128 triangles against its sub-tile, 4 a
//   lane, with edge-function corner tests and x/y range tests (below),
//   conservative under rounding, and compacts the survivors with the rows
//   they may cover into a per-warp list (__ballot_sync / __popc); it then
//   evaluates only those, on those rows, one lane a column;
// - the output is written once, 16 rows of 32 int32 a warp (128 B a row).
// No atomics: a maximum does not depend on its order, so the keys are
// deterministic. What holds it back now is the evaluation (about 80% of its
// time, tools/torch_k5_ablation.py): a warp walks a survivor's rows in
// lock-step, and a triangle of the head, ~10 px across, leaves most of the
// 32 lanes idle on each of them.
//
// Exactness. The evaluation order is the plain version's (ops/rasterizer.py
// rasterize_keys_reference), so that the two agree on every pixel: a chunk
// is evaluated on a 16 x 128 tile iff its box overlaps the tile; pixel
// centres sit at x + 0.5; row 0 of a strip is (a + b*px) + c*py0 and each
// next row adds c; every product and sum is a rounded __fmul_rn / __fadd_rn
// that the compiler may not contract into a fused multiply-add, and the
// shade divides with __fdiv_rn. The cull only drops (triangle, sub-tile)
// pairs and rows in which no pixel's rounded evaluation passes the inside
// test, so it changes no key.
//
// The cull and its margin tau. For a sub-tile with pixel centres x in
// [xl, xh], y in [yl, yh] (all > 0), plane k (w0, w1, and w2 = 1 - w0 - w1
// with coefficients a2 = (1 - a0) - a1, b2 = -b0 - b1, c2 = -c0 - c1) is
// largest over the rectangle at a corner:
//
//   m_k = (a_k + max(b_k*xl, b_k*xh)) + max(c_k*yl, c_k*yh).
//
// A pair is culled when some m_k < -tau. Let u = 2^-24 (f32 unit roundoff),
// M_k = (|a_k| + |b_k|*xh) + |c_k|*yh for k = 0, 1, and S = (1 + M_0) + M_1.
// - Evaluating w0 or w1 on row r of the strip is a sum of the terms a,
//   b*px, c*py0 and r <= 15 times c: 2 products and at most 17 additions,
//   19 roundings, so its error is at most gamma_19 * (|a| + |b| px + |c|
//   (py0 + 15)) <= 19.01 u M_k (py0 + 15 = yh at most).
// - w2 = (1 - w0) - w1 adds both errors and its two subtractions' roundings,
//   at most 2.01 u (1 + |w0| + |w1|): in all at most 21.1 u S.
// - The corner test itself: for k = 0, 1 two products, a max and two
//   additions, at most gamma_4 M_k; for k = 2 the coefficients' own
//   roundings (gamma_2 (1 + |a0| + |a1|), u (|b0| + |b1|) xh, u (|c0| + |c1|)
//   yh) plus gamma_4 of the rounded plane: at most 6.1 u S.
// So a pair culled by a corner test has, at every pixel of the sub-tile, a
// rounded w_k below -tau + 27.2 u S. tau = 2^-17 S = 128 u S keeps a margin
// of 4.7x over that bound, with S itself rounded (relative error below
// 10 u). Tau costs nothing in culling: a pixel centre half a pixel outside
// an edge sits at about -0.5 |grad w|, far below -tau. Underflow adds at
// most ~30 * 2^-150, far below tau >= 2^-17.
//
// The corner tests alone keep a small triangle on every sub-tile that each
// of its three edges' half-planes reaches (three times the pairs on the
// head), so the x and y axes are tested too. A pixel whose rounded w0, w1,
// w2 all pass has exact W_k >= -tau by the bound above: it lies in the
// triangle widened by tau. With D = b0 c1 - b1 c0 (nonzero), the pixel's
// x = x2 + alpha W0 + beta W1 exactly, where x2 = (a1 c0 - a0 c1) / D is
// the vertex where W0 = W1 = 0, alpha = c1 / D, beta = -c0 / D (for y:
// (a0 b1 - a1 b0) / D, -b1 / D, b0 / D). Over the widened triangle (W0, W1)
// ranges over the corners (1 + 2t, -t), (-t, 1 + 2t), (-t, -t), so x lies
// within x2 + [min, max] of e0 = alpha + t (2 alpha - beta), e1 = beta +
// t (2 beta - alpha), e2 = -t (alpha + beta). That range, widened by a
// margin, gives the first and last column (row) of the sub-tile whose
// centre it holds; a pair with no such column or row is culled, and a kept
// pair evaluates only those rows (the rows before them still take their
// additions, so that the order stays the plain version's). The indices are
// ceil / floor of the rounded distance from the first centre, which can only
// widen them (rounding is monotone and integers are exact). The margin
// covers the rounding of all this: with cond =
// (|b0 c1| + |b1 c0|) / |D| the rounded D, 1 / D, alpha and beta are off by
// at most (2.01 cond + 2) u relative, x2 by 2.01 u spread + (2.01 cond + 3)
// u |x2| with spread = (|a1 c0| + |a0 c1|) / |D|, and the e's and the sum
// by a few u more; margin = 2^-18 (spread + (cond + 4)(|x2| + 3 |alpha| +
// 3 |beta|)) is 8x or more above that while cond <= 1024 and t <= 0.5 (so
// 1 + 3t <= 3). Outside those limits (slivers, whose D is mostly rounding)
// only the corner tests cull, and every row is evaluated.
//
// The exceptions: a pair is never culled when S > 2^100 (the bounds assume
// no overflow; such coefficients never come from plane_coefficients), and a
// NaN coefficient of w0 or w1 makes S NaN and the pair culled, which is
// sound because such a triangle's w0, w1 or w2 is NaN or infinite on every
// pixel and never passes the inside test. A culled triangle of the prepass
// (a0 = -1, b0 = c0 = 0) has m_0 = -1 < -tau and culls itself.
// ops/rasterizer.py subtile_cull is the same decision in the same float
// operations; tests/test_torch_rasterizer.py holds it sound on
// adversarial triangles, where dropping tau or the axis widening shows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int TRI_CHUNK = 128, STRIP_H = 16, XBLOCK = 128, SUB_W = 32, COEF_ROW = 16;
constexpr int N_WARPS = XBLOCK / SUB_W;
// 10 resident blocks an SM (48 registers, a few bytes spilled) read ~5%
// faster than the compiler's own choice of 8 (tools/torch_k5_ablation.py)
constexpr int MIN_BLOCKS = 10;
constexpr int CHUNK_BYTES = TRI_CHUNK * COEF_ROW * 4;
constexpr float IZ_MAX = 4194303.f;       // 2^22 - 1
constexpr float TAU_PER_S = 0x1p-17f;     // tau = 2^-17 S (the note above)
constexpr float NO_CULL_ABOVE = 0x1p100f;
constexpr float AXIS_COND_MAX = 1024.f, AXIS_TAU_MAX = 0.5f, AXIS_MARGIN = 0x1p-18f;

// `bytes` contiguous bytes of global memory into shared memory, completing on
// the mbarrier `bar` (which must expect them)
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the largest value of the plane a + b x + c y over the rectangle of pixel
// centres [xl, xh] x [yl, yh]
__device__ __forceinline__ float corner_max(float a, float b, float c, float xl, float xh,
                                            float yl, float yh) {
  return __fadd_rn(__fadd_rn(a, fmaxf(__fmul_rn(b, xl), __fmul_rn(b, xh))),
                   fmaxf(__fmul_rn(c, yl), __fmul_rn(c, yh)));
}

__device__ __forceinline__ float abs_plane(float a, float b, float c, float xh, float yh) {
  return __fadd_rn(__fadd_rn(fabsf(a), __fmul_rn(fabsf(b), xh)), __fmul_rn(fabsf(c), yh));
}

// the first and last index k in [0, n) whose centre first + k lies in the
// range of the coordinate vertex + alpha w0 + beta w1 over the triangle
// widened by t, widened again by the rounding margin (the note above); a
// NaN gives the whole range
__device__ __forceinline__ void centres(float vertex, float alpha, float beta, float spread,
                                        float cond, float t, float first, float n, float& k_lo,
                                        float& k_hi) {
  const float e0 = __fadd_rn(alpha, __fmul_rn(t, __fsub_rn(__fmul_rn(2.f, alpha), beta)));
  const float e1 = __fadd_rn(beta, __fmul_rn(t, __fsub_rn(__fmul_rn(2.f, beta), alpha)));
  const float e2 = -__fmul_rn(t, __fadd_rn(alpha, beta));
  const float margin = __fmul_rn(
      AXIS_MARGIN,
      __fadd_rn(spread, __fmul_rn(__fadd_rn(cond, 4.f),
                                  __fadd_rn(__fadd_rn(fabsf(vertex), __fmul_rn(3.f, fabsf(alpha))),
                                            __fmul_rn(3.f, fabsf(beta))))));
  const float hi = __fadd_rn(__fadd_rn(vertex, fmaxf(fmaxf(e0, e1), e2)), margin);
  const float lo = __fsub_rn(__fadd_rn(vertex, fminf(fminf(e0, e1), e2)), margin);
  k_lo = fmaxf(ceilf(fminf(fmaxf(__fsub_rn(lo, first), -1.f), 1e6f)), 0.f);
  k_hi = fminf(floorf(fmaxf(fminf(__fsub_rn(hi, first), 1e6f), -1.f)), n - 1.f);
}

constexpr int CULLED = -1, ALL_ROWS = (STRIP_H - 1) << 4;

// the cull of the triangle whose coefficient row is `tri` against the
// sub-tile of pixel centres [xl, xh] x [yl, yh] (the note above): CULLED if
// no pixel of it can pass the inside test, else the first and last row that
// can, r_lo | r_hi << 4
__device__ __forceinline__ int cull(const float* tri, float xl, float xh, float yl, float yh) {
  const float4 r0 = reinterpret_cast<const float4*>(tri)[0];
  const float4 r1 = reinterpret_cast<const float4*>(tri)[1];
  const float a0 = r0.x, b0 = r0.y, c0 = r0.z, a1 = r0.w, b1 = r1.x, c1 = r1.y;
  const float s = __fadd_rn(__fadd_rn(1.f, abs_plane(a0, b0, c0, xh, yh)),
                            abs_plane(a1, b1, c1, xh, yh));
  if (s > NO_CULL_ABOVE) return ALL_ROWS;
  const float neg_tau = -__fmul_rn(s, TAU_PER_S);
  const float a2 = __fsub_rn(__fsub_rn(1.f, a0), a1), b2 = __fsub_rn(-b0, b1),
              c2 = __fsub_rn(-c0, c1);
  if (!(corner_max(a0, b0, c0, xl, xh, yl, yh) >= neg_tau &&
        corner_max(a1, b1, c1, xl, xh, yl, yh) >= neg_tau &&
        corner_max(a2, b2, c2, xl, xh, yl, yh) >= neg_tau))
    return CULLED;
  const float p = __fmul_rn(b0, c1), q = __fmul_rn(b1, c0);
  const float inv = __fdiv_rn(1.f, __fsub_rn(p, q));
  const float cond = __fmul_rn(__fadd_rn(fabsf(p), fabsf(q)), fabsf(inv));
  const float t = -neg_tau;
  if (!(cond <= AXIS_COND_MAX && t <= AXIS_TAU_MAX)) return ALL_ROWS;
  float c_lo, c_hi, r_lo, r_hi;
  centres(__fmul_rn(__fsub_rn(__fmul_rn(a1, c0), __fmul_rn(a0, c1)), inv), __fmul_rn(c1, inv),
          -__fmul_rn(c0, inv),
          __fmul_rn(__fadd_rn(fabsf(__fmul_rn(a1, c0)), fabsf(__fmul_rn(a0, c1))), fabsf(inv)),
          cond, t, xl, __fadd_rn(__fsub_rn(xh, xl), 1.f), c_lo, c_hi);
  centres(__fmul_rn(__fsub_rn(__fmul_rn(a0, b1), __fmul_rn(a1, b0)), inv), -__fmul_rn(b1, inv),
          __fmul_rn(b0, inv),
          __fmul_rn(__fadd_rn(fabsf(__fmul_rn(a0, b1)), fabsf(__fmul_rn(a1, b0))), fabsf(inv)),
          cond, t, yl, (float)STRIP_H, r_lo, r_hi);
  if (c_lo > c_hi || r_lo > r_hi) return CULLED;
  return (int)r_lo | (int)r_hi << 4;
}

__global__ void __launch_bounds__(XBLOCK, MIN_BLOCKS)
raster_subtile_kernel(const float* __restrict__ coefs, const int* __restrict__ bbox,
                      int* __restrict__ out, int n_chunks, int height, int width) {
  __shared__ __align__(128) float sbuf[2][TRI_CHUNK * COEF_ROW];
  __shared__ __align__(8) uint64_t sbar[2];
  __shared__ int clist[XBLOCK];  // this round's overlapping chunks, ascending
  __shared__ int wcount[N_WARPS];
  __shared__ int survivors[N_WARPS][TRI_CHUNK];  // triangle | its rows << 8

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * XBLOCK, y_top = blockIdx.y * STRIP_H, f = blockIdx.z;
  const int sx = x0 + warp * SUB_W;
  const bool active = sx < width;  // warp-uniform
  // exact: integers below 2^23 plus a half
  const float px = (float)(sx + lane) + 0.5f, py0 = (float)y_top + 0.5f;
  const float xl = (float)sx + 0.5f, xh = (float)min(sx + SUB_W, width) - 0.5f;
  const float yh = (float)(y_top + STRIP_H) - 0.5f;
  const int4* boxes = reinterpret_cast<const int4*>(bbox) + (size_t)f * n_chunks;
  const char* cf = reinterpret_cast<const char*>(coefs) + (size_t)f * n_chunks * CHUNK_BYTES;
  // buffer `slot` and its mbarrier
  const uint32_t buf0 = smem_u32(&sbuf[0][0]), bar0 = smem_u32(&sbar[0]);
  auto bar = [&](int slot) { return bar0 + 8u * slot; };
  if (tid == 0) {
    mbar_init(bar(0), 1);
    mbar_init(bar(1), 1);
    fence_mbarrier_init();
  }
  auto fetch = [&](int chunk, int slot) {  // thread 0 only
    fence_proxy_async();
    mbar_expect_tx(bar(slot), CHUNK_BYTES);
    bulk_copy_g2s(buf0 + CHUNK_BYTES * slot, cf + (size_t)chunk * CHUNK_BYTES, CHUNK_BYTES,
                  bar(slot));
  };

  int key[STRIP_H];
#pragma unroll
  for (int r = 0; r < STRIP_H; ++r) key[r] = 0;

  int g = 0;  // chunks taken so far: buffer g & 1, that buffer's phase (g >> 1) & 1
  for (int base = 0; base < n_chunks; base += XBLOCK) {
    __syncthreads();  // the mbarriers' init is visible; the last round's list is read
    const int c = base + tid;
    bool hit = false;
    if (c < n_chunks) {
      const int4 b = boxes[c];  // xmin, xmax, ymin, ymax
      hit = !(b.z > y_top + STRIP_H - 1 || b.w < y_top || b.x > x0 + XBLOCK - 1 || b.y < x0);
    }
    const unsigned m = __ballot_sync(~0u, hit);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < N_WARPS; ++w) {
      off += w < warp ? wcount[w] : 0;
      n += wcount[w];
    }
    if (hit) clist[off + __popc(m & ((1u << lane) - 1))] = c;
    __syncthreads();
    if (tid == 0 && n > 0) fetch(clist[0], g & 1);

    for (int j = 0; j < n; ++j, ++g) {
      // the other buffer was last read in the previous iteration, which
      // ended in a block barrier
      if (tid == 0 && j + 1 < n) fetch(clist[j + 1], (g + 1) & 1);
      mbar_wait(bar(g & 1), (g >> 1) & 1);
      if (active) {
        const float* tri = sbuf[g & 1];
        int n_surv = 0;
#pragma unroll
        for (int k = 0; k < TRI_CHUNK / 32; ++k) {
          const int i = lane + 32 * k;
          const int rows = cull(tri + i * COEF_ROW, xl, xh, py0, yh);
          const unsigned mk = __ballot_sync(~0u, rows != CULLED);
          if (rows != CULLED) survivors[warp][n_surv + __popc(mk & ((1u << lane) - 1))] = i | rows << 8;
          n_surv += __popc(mk);
        }
        __syncwarp();
        for (int s = 0; s < n_surv; ++s) {
          const int e = survivors[warp][s];  // warp-uniform
          const int r_lo = (e >> 8) & 15, r_hi = e >> 12;
          const float4* t = reinterpret_cast<const float4*>(tri + (e & 0xff) * COEF_ROW);
          const float4 r0 = t[0], r1 = t[1], r2 = t[2];
          const float a0 = r0.x, b0 = r0.y, c0 = r0.z, a1 = r0.w, b1 = r1.x, c1 = r1.y;
          const float az = r1.z, bz = r1.w, cz = r2.x, as = r2.y, bs = r2.z, cs = r2.w;
          float w0 = __fadd_rn(__fadd_rn(a0, __fmul_rn(b0, px)), __fmul_rn(c0, py0));
          float w1 = __fadd_rn(__fadd_rn(a1, __fmul_rn(b1, px)), __fmul_rn(c1, py0));
          float iz = __fadd_rn(__fadd_rn(az, __fmul_rn(bz, px)), __fmul_rn(cz, py0));
          float soz = __fadd_rn(__fadd_rn(as, __fmul_rn(bs, px)), __fmul_rn(cs, py0));
#pragma unroll
          for (int r = 0; r < STRIP_H; ++r) {
            if (r > r_hi) break;
            if (r) {
              w0 = __fadd_rn(w0, c0);
              w1 = __fadd_rn(w1, c1);
              iz = __fadd_rn(iz, cz);
              soz = __fadd_rn(soz, cs);
            }
            if (r < r_lo) continue;
            const float w2 = __fsub_rn(__fsub_rn(1.f, w0), w1);
            // false for a NaN plane, so no NaN is ever converted to an integer
            if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
              const float sh = __fdiv_rn(soz, fmaxf(iz, 1e-12f));
              const int izq = (int)fminf(fmaxf(__fmul_rn(iz, IZ_MAX), 1.f), IZ_MAX);
              const int sq = (int)fminf(fmaxf(fminf(__fmul_rn(sh, 255.f), 254.f), 0.f), 254.f);
              key[r] = max(key[r], (izq << 8) | sq);
            }
          }
        }
      }
      __syncthreads();  // this buffer and the survivor lists are free again
    }
  }

  const int col = sx + lane;
  if (active && col < width) {
    int* o = out + ((size_t)f * height + y_top) * width + col;
#pragma unroll
    for (int r = 0; r < STRIP_H; ++r) o[(size_t)r * width] = key[r];
  }
}

}  // namespace

// coefs: (F, n_chunks * 128, 16) f32, 16-byte aligned; bbox: (F, n_chunks, 4)
// i32 [xmin, xmax, ymin, ymax]; out: (F, height, width) i32, height a
// multiple of 16.
extern "C" int a2f_rasterize_keys(const float* coefs, const int* bbox, int* out,
                                  int n_frames, int n_chunks, int height, int width,
                                  void* stream) {
  const dim3 grid((width + XBLOCK - 1) / XBLOCK, height / STRIP_H, n_frames);
  raster_subtile_kernel<<<grid, XBLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      coefs, bbox, out, n_chunks, height, width);
  return cudaGetLastError();
}

"""Tile rasterizer: a hand-written CUDA kernel + its plain version.

Port of ``audio2face_tpu/ops/rasterizer.py``. There is no per-fragment
scatter: each triangle's barycentrics, depth and shade are affine in screen
(px, py), so ``plane_coefficients`` (torch ops, batched over frames) turns
the projected mesh into 12 plane coefficients per triangle (w0, w1, 1/z,
shade/z as a + b*px + c*py) and one screen bounding box per chunk of 128
triangles (mesh order is spatially coherent). ``rasterize_keys`` then gives
every pixel the maximum over triangles of the packed key

    (clip(1/z * (2^22 - 1), 1, 2^22 - 1) << 8) | shade byte,   0 = background

so the depth test and the colour selection are one ``max``; fragments whose
quantized depths tie resolve to the brightest shade. For CUDA tensors it is
one launch of ``csrc/rasterizer.cu`` for any number of frames (the chunk
boxes are read from device memory, so there is no cap on the batch); for CPU
tensors it is ``rasterize_keys_reference``, the same keys with torch ops,
chunk by chunk.

Kernel and plain version share one evaluation order, so that they can be
held to each other exactly: the screen is cut into tiles of 16 rows by 128
columns; a chunk is evaluated on a tile iff its box overlaps the tile; row 0
of a tile is ``(a + b*px) + c*py0`` and each next row adds ``c``; no product
and sum contract into a fused multiply-add. The kernel evaluates a triangle
of an overlapping chunk only on the 16 x 32 sub-tiles, and the rows of
them, that ``subtile_cull`` keeps (edge-function corner tests and x/y range
tests, with margins that make them conservative under rounding), which
changes no key; the plain version evaluates every triangle of the chunk and
is the unculled oracle. ``subtile_pairs`` and ``triangle_box_pixels`` count
the kernel's work and the work the inputs need.
"""

from __future__ import annotations

import ctypes

import torch

from audio2face_tpu_torch.ops import _build

TRI_CHUNK = 128  # triangles per culling chunk
STRIP_H = 16  # image rows per tile
XBLOCK = 128  # image columns per tile
SUB_W = 32  # image columns per sub-tile: one warp of the kernel
TAU_PER_S = 2.0**-17  # the cull's margin over its scale S (csrc/rasterizer.cu)
NO_CULL_ABOVE = 2.0**100
AXIS_COND_MAX = 1024.0  # the axis tests' limits and margin (csrc/rasterizer.cu)
AXIS_TAU_MAX = 0.5
AXIS_MARGIN = 2.0**-18

IZ_BITS = 22
IZ_MAX = float((1 << IZ_BITS) - 1)


def plane_coefficients(
    u: torch.Tensor,  # (..., V) screen x per vertex
    v: torch.Tensor,  # (..., V) screen y
    z: torch.Tensor,  # (..., V) camera-space depth (positive)
    shade: torch.Tensor,  # (..., V) Gouraud intensity in [0, 1]
    visible: torch.Tensor,  # (..., V) bool
    faces: torch.Tensor,  # (T, 3) integer, T % TRI_CHUNK == 0
    face_valid: torch.Tensor,  # (T,) bool
    *,
    height: int,
    width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Projected vertices -> per-triangle plane coefficients + chunk bboxes,
    for any leading (frame) dimensions.

    Returns ``(coefs (..., T, 16) f32, chunk_bbox (..., T // TRI_CHUNK, 4) i32)``.
    coefs columns: [a0, b0, c0, a1, b1, c1, az, bz, cz, as_, bs, cs, 0...]
    such that w0 = a0 + b0*px + c0*py (likewise w1), 1/z = az + bz*px +
    cz*py, shade/z = as_ + bs*px + cs*py, and w2 = 1 - w0 - w1. Culled
    triangles (a vertex outside the frustum, padding, off screen, |area| <=
    1e-12, which also drops NaN geometry because the comparison is false) get
    a0 = -1, b0 = c0 = 0 so the inside test can never pass. chunk_bbox
    columns: [xmin, xmax, ymin, ymax] in pixel units over the chunk's live
    triangles (empty chunk: xmin > xmax).
    """
    if faces.shape[0] % TRI_CHUNK:
        raise ValueError(f"{faces.shape[0]} triangles: pad to a multiple of {TRI_CHUNK}")
    faces = faces.long()
    uu, vv = u[..., faces], v[..., faces]  # (..., T, 3)
    izv = 1.0 / z[..., faces]
    soz = shade[..., faces] * izv

    x0, x1, x2 = uu.unbind(-1)
    y0, y1, y2 = vv.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    xmin, xmax = uu.amin(-1), uu.amax(-1)
    ymin, ymax = vv.amin(-1), vv.amax(-1)
    onscreen = (xmax >= 0) & (ymax >= 0) & (xmin < width) & (ymin < height)
    ok = visible[..., faces].all(dim=-1) & face_valid & onscreen & (area.abs() > 1e-12)
    one, zero = torch.ones_like(area), torch.zeros_like(area)
    inv = torch.where(ok, 1.0 / torch.where(ok, area, one), zero)

    a0 = (x1 * y2 - x2 * y1) * inv
    b0 = (y1 - y2) * inv
    c0 = (x2 - x1) * inv
    a1 = (x2 * y0 - x0 * y2) * inv
    b1 = (y2 - y0) * inv
    c1 = (x0 - x2) * inv

    dz0, dz1 = izv[..., 0] - izv[..., 2], izv[..., 1] - izv[..., 2]
    az = izv[..., 2] + a0 * dz0 + a1 * dz1
    bz = b0 * dz0 + b1 * dz1
    cz = c0 * dz0 + c1 * dz1
    ds0, ds1 = soz[..., 0] - soz[..., 2], soz[..., 1] - soz[..., 2]
    as_ = soz[..., 2] + a0 * ds0 + a1 * ds1
    bs = b0 * ds0 + b1 * ds1
    cs = c0 * ds0 + c1 * ds1

    # culled triangles: w0 == -1 everywhere => never inside
    cols = [torch.where(ok, a0, -one)] + [
        torch.where(ok, t, zero) for t in (b0, c0, a1, b1, c1, az, bz, cz, as_, bs, cs)
    ]
    coefs = torch.stack(cols + [zero] * 4, dim=-1).float()  # (..., T, 16)

    lead = area.shape[:-1]
    n_chunks = faces.shape[0] // TRI_CHUNK
    big = float(4 * max(height, width))

    def chunked(t, fill):
        return torch.where(ok, t, torch.full_like(t, fill)).reshape(*lead, n_chunks, TRI_CHUNK)

    bbox = torch.stack(
        [
            torch.floor(chunked(xmin, big).amin(-1)),
            torch.ceil(chunked(xmax, -big).amax(-1)),
            torch.floor(chunked(ymin, big).amin(-1)),
            torch.ceil(chunked(ymax, -big).amax(-1)),
        ],
        dim=-1,
    ).to(torch.int32)
    return coefs, bbox


def _check(coefs: torch.Tensor, chunk_bbox: torch.Tensor, height: int, width: int) -> None:
    if coefs.ndim != 3 or coefs.shape[2] != 16 or coefs.shape[1] % TRI_CHUNK:
        raise ValueError(f"coefs {tuple(coefs.shape)}: want (F, T, 16) with T % {TRI_CHUNK} == 0")
    if tuple(chunk_bbox.shape) != (coefs.shape[0], coefs.shape[1] // TRI_CHUNK, 4):
        raise ValueError(f"chunk_bbox {tuple(chunk_bbox.shape)} does not match coefs {tuple(coefs.shape)}")
    if coefs.dtype != torch.float32 or chunk_bbox.dtype != torch.int32:
        raise ValueError(f"coefs {coefs.dtype} (want float32), chunk_bbox {chunk_bbox.dtype} (want int32)")
    if chunk_bbox.device != coefs.device:
        raise ValueError(f"coefs on {coefs.device}, chunk_bbox on {chunk_bbox.device}")
    if height % STRIP_H or height <= 0 or width <= 0:
        raise ValueError(f"height {height} must be a positive multiple of {STRIP_H}, width {width} positive")


def tile_range(lo: int, hi: int, size: int, n_tiles: int) -> tuple[int, int]:
    """First and last tile index (``size`` pixels each, ``n_tiles`` of them)
    that the pixel interval [lo, hi] overlaps; empty when first > last."""
    return max(lo // size, 0), min(hi // size, n_tiles - 1)


def rasterize_keys_reference(
    coefs: torch.Tensor,  # (F, T, 16) f32 from plane_coefficients
    chunk_bbox: torch.Tensor,  # (F, T // TRI_CHUNK, 4) i32
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """Plain version of ``rasterize_keys``: the same keys with torch ops, one
    chunk at a time on the rectangle of tiles its box overlaps (an ``amax``
    over the triangle axis), in the kernel's evaluation order. Returns
    (F, height, width) int32."""
    _check(coefs, chunk_bbox, height, width)
    n_frames, n_tri, _ = coefs.shape
    dev = coefs.device
    out = torch.zeros((n_frames, height, width), dtype=torch.int32, device=dev)
    boxes = chunk_bbox.cpu().tolist()  # one read of all boxes, then a host loop
    n_strips, n_xblocks = height // STRIP_H, -(-width // XBLOCK)
    cols = torch.arange(width, device=dev, dtype=torch.float32) + 0.5
    for f in range(n_frames):
        for c, (xmin, xmax, ymin, ymax) in enumerate(boxes[f]):
            s0, s1 = tile_range(ymin, ymax, STRIP_H, n_strips)
            b0, b1 = tile_range(xmin, xmax, XBLOCK, n_xblocks)
            if s0 > s1 or b0 > b1:
                continue
            x_lo, x_hi = b0 * XBLOCK, min((b1 + 1) * XBLOCK, width)
            ck = coefs[f, c * TRI_CHUNK : (c + 1) * TRI_CHUNK, :12]  # (128, 12)
            a0, b0_, c0, a1, b1_, c1, az, bz, cz, as_, bs, cs = (
                ck[:, j].reshape(TRI_CHUNK, 1, 1) for j in range(12))
            px = cols[x_lo:x_hi].reshape(1, 1, -1)
            py0 = (torch.arange(s0, s1 + 1, device=dev, dtype=torch.float32) * STRIP_H
                   + 0.5).reshape(1, -1, 1)
            # row-0 plane values of every tile; each next row adds the y slope
            w0 = a0 + b0_ * px + c0 * py0  # (128, strips, columns)
            w1 = a1 + b1_ * px + c1 * py0
            iz = az + bz * px + cz * py0
            soz = as_ + bs * px + cs * py0
            rows = []
            for r in range(STRIP_H):
                if r:
                    w0, w1, iz, soz = w0 + c0, w1 + c1, iz + cz, soz + cs
                w2 = 1.0 - w0 - w1
                inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
                # only inside fragments are converted: a NaN plane is never inside
                izi = torch.where(inside, iz, torch.ones_like(iz))
                s = torch.where(inside, soz, torch.zeros_like(soz)) / izi.clamp(min=1e-12)
                izq = (izi * IZ_MAX).clamp(1.0, IZ_MAX).to(torch.int32)
                sq = (s * 255.0).clamp(max=254.0).clamp(0.0, 254.0).to(torch.int32)
                key = torch.where(inside, (izq << 8) | sq, torch.zeros_like(izq))
                rows.append(key.amax(dim=0))  # (strips, columns)
            acc = torch.stack(rows, dim=1).reshape((s1 - s0 + 1) * STRIP_H, x_hi - x_lo)
            region = out[f, s0 * STRIP_H : (s1 + 1) * STRIP_H, x_lo:x_hi]
            torch.maximum(region, acc, out=region)
    return out


def subtile_cull(
    coefs: torch.Tensor,  # (..., T, 16) f32 from plane_coefficients
    y0,  # sub-tile top rows (int or tensor), broadcast together with x0 and tw
    x0,  # sub-tile left columns
    th: int,  # rows of a sub-tile
    tw,  # columns of a sub-tile (int or tensor: clipped at the frame's width)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's cull, in the same float operations: for every (triangle,
    sub-tile [x0, x0 + tw) x [y0, y0 + th)) pair, whether a pixel centre of
    the sub-tile may pass the inside test in the kernel's rounded evaluation
    order, and the first and last row (0 .. th - 1) that may.

    Returns ``(keep, row_lo, row_hi)``, each (..., T, *G), G the broadcast
    shape of y0, x0 and tw. Each of w0, w1 and w2 = 1 - w0 - w1 is largest
    over the rectangle of pixel centres at a corner; a pair is culled when
    one of the three corner maxima is below -tau, with tau = 2^-17 S and S =
    1 + sum over w0, w1 of |a| + |b| xh + |c| yh, 4.7 times the rounding
    bound of evaluation and test. Then the x and y ranges of the triangle
    widened by tau (computed from the planes), widened again by a rounding
    margin, give the columns and rows whose centres they hold; a pair with
    none is culled, and a kept pair evaluates only those rows. The range
    tests are skipped for ill-conditioned planes (all rows). Both are
    derived in ``csrc/rasterizer.cu``. NaN coefficients cull; S above 2^100
    culls nothing. Only the tests and the work counts call it.
    """
    dev = coefs.device
    y0, x0, tw = (torch.as_tensor(t, device=dev, dtype=torch.float32) for t in (y0, x0, tw))
    grid = torch.broadcast_shapes(y0.shape, x0.shape, tw.shape)
    shape = coefs.shape[:-1] + (1,) * len(grid)
    a0, b0, c0, a1, b1, c1 = (coefs[..., j].reshape(shape) for j in range(6))
    xl, xh = x0 + 0.5, (x0 + tw) - 0.5  # exact: integers plus a half
    yl, yh = y0 + 0.5, (y0 + th) - 0.5

    def abs_plane(a, b, c):
        return (a.abs() + b.abs() * xh) + c.abs() * yh

    def corner_max(a, b, c):
        return (a + torch.fmax(b * xl, b * xh)) + torch.fmax(c * yl, c * yh)

    s = (1.0 + abs_plane(a0, b0, c0)) + abs_plane(a1, b1, c1)
    neg_tau = -(s * TAU_PER_S)
    a2, b2, c2 = (1.0 - a0) - a1, (-b0) - b1, (-c0) - c1
    edges = ((corner_max(a0, b0, c0) >= neg_tau) & (corner_max(a1, b1, c1) >= neg_tau)
             & (corner_max(a2, b2, c2) >= neg_tau))
    # the axes: x and y are affine in (w0, w1), x = x2 + alpha w0 + beta w1
    # (x2 the vertex where w0 = w1 = 0); their range over the triangle
    # widened by tau, plus a margin for the rounding of all this
    p, q = b0 * c1, b1 * c0
    inv = 1.0 / (p - q)
    cond = (p.abs() + q.abs()) * inv.abs()
    t = -neg_tau
    well = (cond <= AXIS_COND_MAX) & (t <= AXIS_TAU_MAX)

    def centres(vertex, alpha, beta, spread, first, n):
        """First and last index k in [0, n) whose centre first + k the range holds."""
        e0 = alpha + t * (2.0 * alpha - beta)
        e1 = beta + t * (2.0 * beta - alpha)
        e2 = -(t * (alpha + beta))
        margin = AXIS_MARGIN * (
            spread + (cond + 4.0) * ((vertex.abs() + 3.0 * alpha.abs()) + 3.0 * beta.abs()))
        hi = (vertex + torch.fmax(torch.fmax(e0, e1), e2)) + margin
        lo = (vertex + torch.fmin(torch.fmin(e0, e1), e2)) - margin
        # clamped so that a NaN gives the whole range (fmin / fmax drop a NaN)
        neg, big = torch.tensor(-1.0, device=dev), torch.tensor(1e6, device=dev)
        k_lo = torch.ceil(torch.fmin(torch.fmax(lo - first, neg), big)).clamp(min=0.0)
        k_hi = torch.floor(torch.fmax(torch.fmin(hi - first, big), neg))
        return k_lo, torch.minimum(k_hi, torch.as_tensor(n - 1.0, device=dev))

    col_lo, col_hi = centres((a1 * c0 - a0 * c1) * inv, c1 * inv, -(c0 * inv),
                             ((a1 * c0).abs() + (a0 * c1).abs()) * inv.abs(), xl, tw)
    row_lo, row_hi = centres((a0 * b1 - a1 * b0) * inv, -(b1 * inv), b0 * inv,
                             ((a0 * b1).abs() + (a1 * b0).abs()) * inv.abs(), yl, th)
    empty = (col_lo > col_hi) | (row_lo > row_hi)  # false where NaN: not `well` then
    keep = (s > NO_CULL_ABOVE) | (edges & ~(well & empty))
    use = keep & well & (s <= NO_CULL_ABOVE)
    row_lo = torch.where(use, row_lo, torch.zeros_like(row_lo)).to(torch.int64)
    row_hi = torch.where(use, row_hi, torch.full_like(row_hi, th - 1.0)).to(torch.int64)
    return keep, row_lo, row_hi


def _chunk_tiles(chunk_bbox: torch.Tensor, height: int, width: int):
    """Per chunk, the first and last strip and x block its box overlaps
    (``tile_range`` on tensors)."""
    n_strips, n_xblocks = height // STRIP_H, -(-width // XBLOCK)
    xmin, xmax, ymin, ymax = chunk_bbox.long().unbind(-1)
    return ((ymin // STRIP_H).clamp(min=0), (ymax // STRIP_H).clamp(max=n_strips - 1),
            (xmin // XBLOCK).clamp(min=0), (xmax // XBLOCK).clamp(max=n_xblocks - 1))


def tile_chunk_pairs(chunk_bbox: torch.Tensor, *, height: int, width: int) -> torch.Tensor:
    """(F,) int64: the (chunk, 16 x 128 tile) pairs whose box and tile
    overlap, on which both versions evaluate a chunk."""
    s0, s1, b0, b1 = _chunk_tiles(chunk_bbox, height, width)
    return ((s1 - s0 + 1).clamp(min=0) * (b1 - b0 + 1).clamp(min=0)).sum(-1)


def subtile_pairs(coefs: torch.Tensor, chunk_bbox: torch.Tensor, *, height: int,
                  width: int) -> torch.Tensor:
    """(F,) int64: the (triangle, 16 x 32 sub-tile) pairs the kernel
    evaluates: sub-tiles left of ``width`` in a tile that the triangle's
    chunk box overlaps, kept by ``subtile_cull``."""
    _check(coefs, chunk_bbox, height, width)
    dev = coefs.device
    strip = torch.arange(height // STRIP_H, device=dev)  # (S,)
    sx = torch.arange(0, width, SUB_W, device=dev)  # (X,)
    xb = sx // XBLOCK
    s0, s1, b0, b1 = _chunk_tiles(chunk_bbox, height, width)  # (F, C) each
    counts = []
    for f in range(coefs.shape[0]):
        # (C, S, X): does chunk c's box overlap the tile of sub-tile (s, x)
        over = (((s0[f, :, None] <= strip) & (strip <= s1[f, :, None]))[:, :, None]
                & ((b0[f, :, None] <= xb) & (xb <= b1[f, :, None]))[:, None, :])
        keep = subtile_cull(coefs[f], strip[:, None] * STRIP_H, sx[None, :], STRIP_H,
                            (width - sx).clamp(max=SUB_W)[None, :])[0]  # (T, S, X)
        counts.append((keep.reshape(*over.shape[:1], TRI_CHUNK, *keep.shape[1:]) & over[:, None]).sum())
    return torch.stack(counts) if counts else torch.zeros(0, dtype=torch.int64, device=dev)


def triangle_box_pixels(
    u: torch.Tensor,  # (F, V) screen x per vertex
    v: torch.Tensor,  # (F, V) screen y
    faces: torch.Tensor,  # (T, 3)
    coefs: torch.Tensor,  # (F, T, 16) from plane_coefficients: which triangles live
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """(F,) int64: the work the inputs need, the pixels whose centres lie in
    a live triangle's screen box, inside the frame, summed over the live
    triangles (those the prepass did not cull to a0 = -1, b0 = c0 = 0)."""
    faces = faces.long()
    uu, vv = u[:, faces].double(), v[:, faces].double()  # (F, T, 3)

    def span(lo, hi, n):  # pixels p with lo <= p + 0.5 <= hi, 0 <= p < n
        first = torch.ceil(lo - 0.5).clamp(min=0)
        last = torch.floor(hi - 0.5).clamp(max=n - 1)
        return (last - first + 1).clamp(min=0)

    live = ~((coefs[..., 0] == -1) & (coefs[..., 1] == 0) & (coefs[..., 2] == 0))
    pix = span(uu.amin(-1), uu.amax(-1), width) * span(vv.amin(-1), vv.amax(-1), height)
    return torch.where(live, pix, torch.zeros_like(pix)).sum(-1).long()


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rasterize_keys(
    coefs: torch.Tensor,  # (F, T, 16) f32 from plane_coefficients
    chunk_bbox: torch.Tensor,  # (F, T // TRI_CHUNK, 4) i32
    *,
    height: int,
    width: int,
) -> torch.Tensor:
    """Rasterize to packed (1/z << 8 | shade) int32 keys, (F, height, width).

    Key 0 = background (never produced by a drawn fragment: quantized 1/z is
    clamped to >= 1). CUDA tensors launch the kernel (one launch for all F
    frames), CPU tensors run ``rasterize_keys_reference``."""
    _check(coefs, chunk_bbox, height, width)
    if coefs.device.type == "cpu":
        return rasterize_keys_reference(coefs, chunk_bbox, height=height, width=width)
    if coefs.device.type != "cuda":
        raise ValueError(f"rasterize_keys runs on cuda or cpu, not {coefs.device}")
    n_frames, n_tri, _ = coefs.shape
    if n_frames > 65535:
        raise ValueError(f"{n_frames} frames in one launch: at most 65535")
    coefs, chunk_bbox = coefs.contiguous(), chunk_bbox.contiguous()
    if coefs.data_ptr() % 16:  # the kernel's bulk copies read 16-byte aligned chunks
        coefs = coefs.clone()
    out = torch.empty((n_frames, height, width), dtype=torch.int32, device=coefs.device)
    if n_frames == 0:
        return out
    fn = _build.function("rasterizer", "a2f_rasterize_keys", _ARGTYPES)
    rc = fn(
        coefs.data_ptr(), chunk_bbox.data_ptr(), out.data_ptr(), n_frames,
        n_tri // TRI_CHUNK, height, width, torch.cuda.current_stream(coefs.device).cuda_stream,
    )
    _build.check(rc, "rasterize_keys")
    rasterize_keys.launches += 1
    return out


rasterize_keys.launches = 0

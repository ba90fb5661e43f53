"""Chunk-culled tile rasterizer: a hand-written CUDA kernel + its plain version.

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
and sum contract into a fused multiply-add.
"""

from __future__ import annotations

import ctypes

import torch

from audio2face_tpu_torch.ops import _build

TRI_CHUNK = 128  # triangles per culling chunk
STRIP_H = 16  # image rows per tile
XBLOCK = 128  # image columns per tile

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

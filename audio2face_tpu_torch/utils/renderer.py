"""Offscreen mesh renderer: a software z-buffer rasterizer (no EGL/OpenGL).

Port of ``audio2face_tpu/utils/renderer.py``. Scene parity with the
reference's pyrender scene: the same intrinsics camera (f=4754.98/2,
c=(400,400), 800x800, near 0.01 / far 3.0), camera at z=1 looking at the
origin, ambient 0.2 with five white point lights of intensity 1.5 placed at
the camera position rotated +-30 degrees about the x/y axes, white
background, double-sided shading, smooth per-vertex normals.

Three rasterizers share the projection and Gouraud shading
(``project_and_shade``, torch ops batched over frames):

- the tile rasterizer (``render_frames_tiled*``): plane coefficients and
  chunk boxes as torch ops, then ``ops/rasterizer.rasterize_keys``, the
  hand-written kernel. Exact at any triangle size. ``Renderer.render`` takes
  it on a CUDA device, pipelined: batches of ``TRANSFER_BATCH`` frames are
  rasterized, cropped to the face's window and packed into one uint8 buffer
  on the device, copied into pinned host buffers on a side stream, and pasted
  into full frames on the host while later batches compute;
- the scatter path (``render_frames_u8``): each triangle rasterized on a
  small pixel patch, resolved with one ``scatter_reduce_(amax)`` of the same
  packed keys; triangles larger than the patch are reported, not drawn;
- the exact banded oracle (``rasterize_bands`` + ``Renderer._render_frame``):
  the host buckets triangles into row bands and each band is z-buffered
  against its triangles. ``Renderer.render`` on the CPU takes the scatter path
  and, for frames it cannot hold, this one, with the reference's per-frame
  fault tolerance: a frame that fails repeats the previous frame's image.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from audio2face_tpu_torch.ops.rasterizer import plane_coefficients, rasterize_keys
from audio2face_tpu_torch.utils.device import resolve_device
from audio2face_tpu_torch.utils.facemesh import FaceMesh
from audio2face_tpu_torch.utils.shapes import round_up as _round_up

CAMERA_F = 4754.97941935 / 2
CAMERA_C = (400.0, 400.0)
FRUSTUM = {"near": 0.01, "far": 3.0, "height": 800, "width": 800}
AMBIENT = 0.2
LIGHT_INTENSITY = 1.5
BG_COLOR = 255

ROW_BLOCK = 50
TRI_CHUNK = 256

# Scatter path: per-triangle local-patch rasterization (see render_frames_u8).
# FLAME-scale triangles project to ~10 px bboxes at this camera; tier 1
# covers those, tier 2 catches coarser meshes, anything bigger goes to the
# banded rasterizer (exact at any triangle size).
PATCH_TIERS = ((16, 24), (32, 48))
FRAME_BATCH = 16
_FLAT_CHUNK = 2048
_IZ_BITS = 22
_IZ_SCALE = float((1 << _IZ_BITS) - 1) * FRUSTUM["near"]  # iz <= 1/near

# Device-to-host crop window of the pipelined tiled path: the FLAME-scale face
# projects to a ~410x560 px window of the 800x800 frame at this camera, so a
# (CROP_H, CROP_W) slice plus its per-frame offset is 2.4x fewer bytes than
# the full frame. Exactness holds by construction (the crop covers the
# projected-vertex bbox, and every drawn fragment lies inside some triangle's
# vertex hull); frames whose geometry exceeds the window report fit=False and
# are rendered again full-frame.
CROP_H = 640
CROP_W = 512


def _rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """Rotation matrix from an axis-angle vector (cv2.Rodrigues equivalent,
    used by the reference to place lights)."""
    theta = np.linalg.norm(axis_angle)
    if theta < 1e-12:
        return np.eye(3)
    k = axis_angle / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def light_positions() -> np.ndarray:
    """Five point lights: camera position rotated +-30 degrees about x then y."""
    angle = np.pi / 6.0
    pos = np.array([0.0, 0.0, 1.0])
    out = [pos]
    for axis_angle in ([angle, 0, 0], [-angle, 0, 0], [0, -angle, 0], [0, angle, 0]):
        out.append(_rodrigues(np.asarray(axis_angle, np.float64)) @ pos)
    return np.stack(out).astype(np.float32)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Smooth per-vertex normals of (..., V, 3) vertices: area-weighted
    face-normal accumulation.

    The accumulation is a segment sum over the face corners sorted by vertex
    (differences of an f64 running sum), not ``index_add_``: on a GPU that
    adds with atomics in an order that changes from run to run, and two
    renders of one frame could then differ in a shade byte."""
    faces = faces.long()
    v0, v1, v2 = (verts[..., faces[:, i], :] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # area-weighted, (..., T, 3)
    # corner k of the flat (3T,) list belongs to face k % T
    corner_vertex, order = torch.sort(faces.T.reshape(-1), stable=True)
    running = torch.cumsum(fn[..., order % faces.shape[0], :].double(), dim=-2)
    running = torch.nn.functional.pad(running, (0, 0, 1, 0))
    bounds = torch.searchsorted(
        corner_vertex, torch.arange(verts.shape[-2] + 1, device=verts.device))
    vn = (running[..., bounds[1:], :] - running[..., bounds[:-1], :]).to(verts.dtype)
    norm = torch.linalg.norm(vn, dim=-1, keepdim=True)
    return vn / norm.clamp(min=1e-12)


def project_and_shade(verts: torch.Tensor, faces: torch.Tensor, lights: torch.Tensor):
    """(..., V, 3) world verts -> screen (u, v), depth, per-vertex shade and
    visibility, each (..., V)."""
    verts = verts.float()
    normals = vertex_normals(verts, faces)
    shade = torch.full(verts.shape[:-1], AMBIENT, dtype=torch.float32, device=verts.device)
    for li in range(5):
        d = lights[li] - verts
        dist2 = (d * d).sum(dim=-1)
        ldir = d * torch.rsqrt(dist2.clamp(min=1e-12))[..., None]
        lambert = (normals * ldir).sum(dim=-1).abs()  # double-sided
        shade = shade + LIGHT_INTENSITY * lambert / dist2.clamp(min=1e-6)
    shade = (shade / (1.0 + LIGHT_INTENSITY * 5.0)).clamp(0.0, 1.0)

    # camera at (0, 0, 1), axes = identity, looking along -z
    z_cam = -(verts[..., 2] - 1.0)
    z_safe = z_cam.clamp(min=1e-6)
    u = CAMERA_F * verts[..., 0] / z_safe + CAMERA_C[0]
    v = CAMERA_C[1] - CAMERA_F * verts[..., 1] / z_safe
    visible = (z_cam > FRUSTUM["near"]) & (z_cam < FRUSTUM["far"])
    return u, v, z_safe, shade, visible


def rasterize_bands(
    tri: torch.Tensor,  # (B, cap, 3, 4): per-corner (u, v, 1/z, shade/z)
    valid: torch.Tensor,  # (B, cap) bool
    row0: torch.Tensor,  # (B,) first row of each band
    col0: float,  # leftmost rendered column
    *,
    row_block: int = ROW_BLOCK,
    width: int = FRUSTUM["width"],
) -> torch.Tensor:
    """Rasterize each row band against its bucketed triangles, TRI_CHUNK
    triangles at a time.

    Returns (B, row_block, width) shade in [0,1], background -1.
    """
    n_bands, cap = tri.shape[:2]
    dev = tri.device
    px = (col0 + torch.arange(width, dtype=torch.float32, device=dev) + 0.5).reshape(1, 1, -1)
    out = []
    for b in range(n_bands):
        py = ((row0[b] + torch.arange(row_block, device=dev)).float() + 0.5).reshape(1, -1, 1)
        izbuf = torch.zeros((row_block, width), dtype=torch.float32, device=dev)  # best 1/z
        cbuf = torch.full((row_block, width), -1.0, dtype=torch.float32, device=dev)
        for c0 in range(0, cap, TRI_CHUNK):
            t = tri[b, c0 : c0 + TRI_CHUNK]
            ok = valid[b, c0 : c0 + TRI_CHUNK]
            x0, x1, x2 = (t[:, i, 0, None, None] for i in range(3))
            y0, y1, y2 = (t[:, i, 1, None, None] for i in range(3))
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            inv_area = torch.where(area.abs() < 1e-12, torch.zeros_like(area), 1.0 / area)
            w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
            w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & ok[:, None, None]
            iz = (w0 * t[:, 0, 2, None, None] + w1 * t[:, 1, 2, None, None]
                  + w2 * t[:, 2, 2, None, None])
            soz = (w0 * t[:, 0, 3, None, None] + w1 * t[:, 1, 3, None, None]
                   + w2 * t[:, 2, 3, None, None])
            iz = torch.where(inside, iz, torch.zeros_like(iz))
            iz_best, best = iz.max(dim=0)  # the first of tied maxima
            s_best = soz.gather(0, best[None])[0] / iz_best.clamp(min=1e-12)
            closer = iz_best > izbuf
            izbuf = torch.where(closer, iz_best, izbuf)
            cbuf = torch.where(closer, s_best, cbuf)
        out.append(cbuf)
    return torch.stack(out)


def render_frames_u8(
    verts: torch.Tensor,  # (F, V, 3) float32
    faces: torch.Tensor,  # (T, 3) integer, T a multiple of tri_chunk
    face_valid: torch.Tensor,  # (T,) bool (False on padding rows)
    lights: torch.Tensor,  # (5, 3)
    *,
    patch_h: int,
    patch_w: int,
    height: int = FRUSTUM["height"],
    width: int = FRUSTUM["width"],
    tri_chunk: int = _FLAT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render a whole batch of frames by scatter-max, with no host work per
    frame.

    Returns ((F, height, width) uint8 images, (F,) bool all_fit). Each
    triangle is rasterized only against a (patch_h, patch_w) pixel window
    anchored at its own screen bbox, and z-resolution is one int32
    ``scatter_reduce_(amax)`` per chunk: key = (quantized 1/z) << 8 | shade
    byte, so depth test and colour selection are one associative reduction.

    Triangles whose bbox exceeds the patch are NOT drawn; the per-frame
    ``all_fit`` flag reports that, and the caller escalates to a larger patch
    tier or the exact banded path. Frames with NaN/degenerate vertices render
    as background (the banded path does the same).

    Tie-break semantics: fragments whose quantized depths tie resolve to the
    BRIGHTEST shade, not a fixed triangle, so surfaces within ~1
    depth-quantization step of each other can differ from the exact banded
    path (which picks the argmax triangle) by up to the shade difference of
    the tied fragments: in practice a handful of silhouette pixels, covered
    by the 1 %-of-pixels golden tolerance."""
    f32 = torch.float32
    dev = verts.device
    faces = faces.long()
    n_frames, n_tri = verts.shape[0], faces.shape[0]
    u, v, z, shade, visible = project_and_shade(verts.to(f32), faces, lights)
    uu, vv = u[:, faces], v[:, faces]  # (F, T, 3)
    izv = 1.0 / z[:, faces]
    soz = shade[:, faces] * izv
    ok3 = visible[:, faces].all(dim=-1) & face_valid
    xmin, xmax = uu.amin(-1), uu.amax(-1)
    ymin, ymax = vv.amin(-1), vv.amax(-1)
    fits = (xmax - xmin <= patch_w - 1.0) & (ymax - ymin <= patch_h - 1.0)
    onscreen = (xmax >= 0) & (ymax >= 0) & (xmin < width) & (ymin < height)
    ok = ok3 & onscreen & fits
    all_fit = ~(ok3 & onscreen & ~fits).any(dim=1)
    # culled triangles never reach the conversion: NaN or huge corners become 0
    zero = torch.zeros_like(xmin)
    x0 = torch.floor(torch.where(ok, xmin, zero)).to(torch.int32).reshape(-1)
    y0 = torch.floor(torch.where(ok, ymin, zero)).to(torch.int32).reshape(-1)
    tri = torch.stack([uu, vv, izv, soz], dim=3).reshape(-1, 3, 4)  # (F*T, 3, 4)
    ok = ok.reshape(-1)

    # flatten (frame, triangle) -> one scatter stream over a per-frame
    # framebuffer block; the last slot is the dump target for culled pixels
    n_px = height * width
    frame_base = (torch.arange(n_frames, dtype=torch.int64, device=dev) * n_px).repeat_interleave(n_tri)
    n = tri.shape[0]
    if n % tri_chunk:
        raise ValueError(f"{n} triangles over all frames: not a multiple of tri_chunk={tri_chunk}")
    dx = torch.arange(patch_w, dtype=torch.int32, device=dev)
    dy = torch.arange(patch_h, dtype=torch.int32, device=dev)
    fb = torch.zeros((n_frames * n_px + 1,), dtype=torch.int32, device=dev)
    for c0 in range(0, n, tri_chunk):
        sl = slice(c0, c0 + tri_chunk)
        t, okc = tri[sl], ok[sl]
        xi = x0[sl, None, None] + dx[None, None, :]  # (C, 1, PW)
        yi = y0[sl, None, None] + dy[None, :, None]  # (C, PH, 1)
        px = xi.to(f32) + 0.5
        py = yi.to(f32) + 0.5
        ax, ay = t[:, 0, 0, None, None], t[:, 0, 1, None, None]
        bx, by = t[:, 1, 0, None, None], t[:, 1, 1, None, None]
        cx, cy = t[:, 2, 0, None, None], t[:, 2, 1, None, None]
        area = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
        inv_area = torch.where(area.abs() < 1e-12, torch.zeros_like(area), 1.0 / area)
        w0 = ((bx - px) * (cy - py) - (cx - px) * (by - py)) * inv_area
        w1 = ((cx - px) * (ay - py) - (ax - px) * (cy - py)) * inv_area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & okc[:, None, None]
        valid = inside & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        iz = (w0 * t[:, 0, 2, None, None] + w1 * t[:, 1, 2, None, None]
              + w2 * t[:, 2, 2, None, None])
        s = (w0 * t[:, 0, 3, None, None] + w1 * t[:, 1, 3, None, None]
             + w2 * t[:, 2, 3, None, None]) / iz.clamp(min=1e-12)
        # only valid fragments are converted to integers
        iz = torch.where(valid, iz, torch.ones_like(iz))
        s = torch.where(valid, s, torch.zeros_like(s))
        izq = (iz * _IZ_SCALE).clamp(1.0, float((1 << _IZ_BITS) - 1)).to(torch.int32)
        sq = (s * 255.0).clamp(max=254.0).clamp(0.0, 254.0).to(torch.int32)
        key = torch.where(valid, (izq << 8) | sq, torch.zeros_like(izq))
        ids = torch.where(
            valid, frame_base[sl, None, None] + (yi * width + xi).long(),
            torch.full_like(frame_base[sl, None, None], n_frames * n_px))
        fb.scatter_reduce_(0, ids.reshape(-1), key.reshape(-1), "amax")
    fb = fb[: n_frames * n_px].reshape(n_frames, height, width)
    return keys_to_image(fb), all_fit


def keys_to_image(keys: torch.Tensor) -> torch.Tensor:
    """Packed keys -> uint8 grey image: the shade byte, background 255."""
    return torch.where(keys == 0, torch.full_like(keys, BG_COLOR), keys & 0xFF).to(torch.uint8)


def _crop_window(u, v, visible, *, height, width, crop_h, crop_w):
    """Per-frame crop offset + fit flag from projected vertices (F, V).

    Returns ((F, 2) int32 [y_off, x_off], (F,) bool fit). The crop
    [y_off:y_off+crop_h, x_off:x_off+crop_w] covers every drawn pixel when
    fit is True: drawn fragments lie inside a triangle whose three vertices
    are all visible and finite (plane_coefficients culls the rest), so the
    bbox of visible finite vertices, clipped to the screen, bounds them.
    An all-culled frame (NaN verts, everything behind the camera) renders
    as pure background: any window is correct, so fit stays True."""
    valid = visible & torch.isfinite(u) & torch.isfinite(v)
    big = float(4 * max(height, width))

    def lo(t, limit):
        return torch.floor(torch.where(valid, t, torch.full_like(t, big)).amin(-1)).clamp(0, limit)

    def hi(t, limit):
        return (torch.ceil(torch.where(valid, t, torch.full_like(t, -big)).amax(-1)) + 1).clamp(0, limit)

    u_lo, u_hi = lo(u, width), hi(u, width)
    v_lo, v_hi = lo(v, height), hi(v, height)
    any_valid = valid.any(dim=-1)
    fit = ~any_valid | ((u_hi - u_lo <= crop_w) & (v_hi - v_lo <= crop_h))
    zero = torch.zeros_like(u_lo)
    y_off = torch.where(any_valid, v_lo.clamp(max=height - crop_h), zero)
    x_off = torch.where(any_valid, u_lo.clamp(max=width - crop_w), zero)
    return torch.stack([y_off, x_off], dim=-1).to(torch.int32), fit


def _tiled_keys(verts, faces, face_valid, lights, height, width):
    """Projection, plane coefficients and the tile rasterizer for a batch."""
    u, v, z, shade, vis = project_and_shade(verts.float(), faces, lights)
    coefs, bbox = plane_coefficients(
        u, v, z, shade, vis, faces, face_valid, height=height, width=width)
    return rasterize_keys(coefs, bbox, height=height, width=width), (u, v, vis)


def render_frames_tiled_cropped(
    verts: torch.Tensor,  # (F, V, 3) float32
    faces: torch.Tensor,  # (T, 3) integer, T a multiple of rasterizer.TRI_CHUNK
    face_valid: torch.Tensor,  # (T,) bool
    lights: torch.Tensor,  # (5, 3)
    *,
    height: int = FRUSTUM["height"],
    width: int = FRUSTUM["width"],
    crop_h: int = CROP_H,
    crop_w: int = CROP_W,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tile-rasterize a batch and return only the face's crop window.

    Returns ((F, crop_h, crop_w) uint8 crops, (F, 2) int32 [y, x] offsets,
    (F,) bool fit). Rasterization is identical to render_frames_tiled (the
    full framebuffer is computed on the device); only the payload that goes
    to the host shrinks. When fit[i] is False the crop may miss drawn pixels:
    the caller must render that frame again full-frame. Pixels outside the
    crop are background whenever fit is True."""
    # the packed layout stores 5 metadata bytes in row crop_h and 16-bit
    # offsets; offsets are bounded by the screen size, so pin both here
    # where every cropped/packed render passes through
    if not (5 <= crop_w <= width and 0 < crop_h <= height and height < 2**16 and width < 2**16):
        raise ValueError(f"crop {crop_h}x{crop_w} of a {height}x{width} screen")
    keys, (u, v, vis) = _tiled_keys(verts, faces, face_valid, lights, height, width)
    offs, fit = _crop_window(u, v, vis, height=height, width=width, crop_h=crop_h, crop_w=crop_w)
    img = keys_to_image(keys)
    dev = verts.device
    rows = offs[:, 0, None].long() + torch.arange(crop_h, device=dev)  # (F, crop_h)
    cols = offs[:, 1, None].long() + torch.arange(crop_w, device=dev)  # (F, crop_w)
    frame = torch.arange(verts.shape[0], device=dev)[:, None, None]
    crops = img[frame, rows[:, :, None], cols[:, None, :]]
    return crops, offs, fit


def render_frames_tiled_packed(
    verts: torch.Tensor,  # (F, V, 3) float32
    faces: torch.Tensor,
    face_valid: torch.Tensor,
    lights: torch.Tensor,
    *,
    height: int = FRUSTUM["height"],
    width: int = FRUSTUM["width"],
    crop_h: int = CROP_H,
    crop_w: int = CROP_W,
) -> torch.Tensor:
    """Cropped render with offsets+fit packed into one uint8 buffer.

    Returns (F, crop_h + 1, crop_w) uint8: rows [0, crop_h) are the crop,
    row crop_h carries per-frame metadata bytes
    [y_off >> 8, y_off & 255, x_off >> 8, x_off & 255, fit]. One device
    tensor per batch means one device-to-host copy per drain. Unpack with
    unpack_rendered."""
    crops, offs, fit = render_frames_tiled_cropped(
        verts, faces, face_valid, lights,
        height=height, width=width, crop_h=crop_h, crop_w=crop_w,
    )
    meta = torch.zeros((verts.shape[0], 1, crop_w), dtype=torch.uint8, device=verts.device)
    meta[:, 0, :5] = torch.stack(
        [offs[:, 0] >> 8, offs[:, 0] & 0xFF, offs[:, 1] >> 8, offs[:, 1] & 0xFF,
         fit.to(torch.int32)], dim=1).to(torch.uint8)
    return torch.cat([crops, meta], dim=1)


def unpack_rendered(buf: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side inverse of render_frames_tiled_packed's metadata row.

    Returns ((F, crop_h, crop_w) crops, (F, 2) int32 offsets, (F,) bool fit).
    """
    crops = buf[:, :-1, :]
    m = buf[:, -1, :5].astype(np.int32)
    offs = np.stack([(m[:, 0] << 8) | m[:, 1], (m[:, 2] << 8) | m[:, 3]], axis=1)
    return crops, offs, m[:, 4].astype(bool)


def render_frames_tiled(
    verts: torch.Tensor,  # (F, V, 3) float32
    faces: torch.Tensor,  # (T, 3) integer, T a multiple of rasterizer.TRI_CHUNK
    face_valid: torch.Tensor,  # (T,) bool
    lights: torch.Tensor,  # (5, 3)
    *,
    height: int = FRUSTUM["height"],
    width: int = FRUSTUM["width"],
) -> torch.Tensor:
    """Render a batch of frames through the tile rasterizer.

    Returns (F, height, width) uint8. Exact at any triangle size (no patch
    tiers, no fit flags: see ops/rasterizer.py). NaN or degenerate geometry
    is culled per triangle, so a NaN frame renders as background, matching
    the scatter and banded paths."""
    keys, _ = _tiled_keys(verts, faces, face_valid, lights, height, width)
    return keys_to_image(keys)


class Renderer:
    """API parity with the reference Renderer. Runs on the card unless
    ``device="cpu"`` is asked for."""

    # device batches kept in flight before draining one (the copy and host
    # paste of batch i overlap the compute of the batches behind it)
    PIPELINE_DEPTH = 3
    # frames per pipelined device batch and device-to-host copy
    TRANSFER_BATCH = 64

    def __init__(self, texture_mesh: FaceMesh, device="cuda"):
        self.device = resolve_device(device, "Renderer")
        self.texture_mesh = texture_mesh
        self.faces_np = np.asarray(texture_mesh.faces, np.int32)
        self.faces = torch.as_tensor(self.faces_np, device=self.device)
        self.lights = torch.as_tensor(light_positions(), device=self.device)
        # triangle stream padded to the scatter chunk size (a multiple of the
        # tile rasterizer's chunk too)
        n_tri = len(self.faces_np)
        n_pad = _round_up(max(n_tri, 1), _FLAT_CHUNK)
        fp = np.zeros((n_pad, 3), np.int32)
        fp[:n_tri] = self.faces_np
        self._faces_padded = torch.as_tensor(fp, device=self.device)
        self._face_valid = torch.as_tensor(np.arange(n_pad) < n_tri, device=self.device)
        self.camera_params = {
            "c": np.array(CAMERA_C),
            "k": np.array([-0.19816071, 0.92822711, 0, 0, 0]),  # stored, unused (as in the reference)
            "f": np.array([CAMERA_F, CAMERA_F]),
        }
        self.frustum = dict(FRUSTUM)

    def _to_device(self, verts: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(verts, np.float32)).to(self.device)

    @torch.no_grad()
    def _render_frame(self, verts: np.ndarray) -> np.ndarray:
        """One frame through the exact banded path: host bucketing of the
        triangles into row bands, then rasterize_bands."""
        height, width = FRUSTUM["height"], FRUSTUM["width"]
        u, v, z, shade, visible = (
            t.cpu().numpy() for t in project_and_shade(self._to_device(verts), self.faces, self.lights)
        )

        f = self.faces_np
        tri_ok = visible[f].all(axis=1)
        uu, vv = u[f], v[f]  # (T, 3)
        iz = 1.0 / z[f]
        soz = shade[f] * iz
        tri = np.stack([uu, vv, iz, soz], axis=2).astype(np.float32)  # (T, 3, 4)

        # screen-space bbox culling + row-band bucketing (host, cheap)
        vmin, vmax = vv.min(1), vv.max(1)
        umin, umax = uu.min(1), uu.max(1)
        tri_ok &= (vmax >= 0) & (vmin < height) & (umax >= 0) & (umin < width)
        idx = np.nonzero(tri_ok)[0]
        if len(idx) == 0:
            return np.full((height, width, 3), BG_COLOR, np.uint8)

        b0 = np.clip(vmin[idx].astype(np.int64) // ROW_BLOCK, 0, height // ROW_BLOCK - 1)
        b1 = np.clip(vmax[idx].astype(np.int64) // ROW_BLOCK, 0, height // ROW_BLOCK - 1)
        band_lo, band_hi = int(b0.min()), int(b1.max())
        n_bands = band_hi - band_lo + 1
        c_lo = int(np.clip(umin[idx].min(), 0, width - 1)) // 128 * 128
        c_hi = min(_round_up(int(umax[idx].max()) + 1, 128), width)
        win_w = c_hi - c_lo

        # bucket triangle ids per band (each triangle lands in b0..b1)
        band_ids = [idx[(b0 <= b) & (b1 >= b)] for b in range(band_lo, band_hi + 1)]
        cap = _round_up(max(max(len(a) for a in band_ids), 1), TRI_CHUNK)
        tri_bands = np.zeros((n_bands, cap, 3, 4), np.float32)
        valid = np.zeros((n_bands, cap), bool)
        for i, ids in enumerate(band_ids):
            tri_bands[i, : len(ids)] = tri[ids]
            valid[i, : len(ids)] = True
        row0 = (band_lo + np.arange(n_bands)) * ROW_BLOCK

        bands = rasterize_bands(
            torch.as_tensor(tri_bands, device=self.device),
            torch.as_tensor(valid, device=self.device),
            torch.as_tensor(row0.astype(np.float32), device=self.device),
            float(c_lo), width=win_w,
        ).cpu().numpy()
        img = np.full((height, width), -1.0, np.float32)
        img[band_lo * ROW_BLOCK : (band_hi + 1) * ROW_BLOCK, c_lo:c_hi] = bands.reshape(-1, win_w)
        return shade_to_image(img)

    @torch.no_grad()
    def _render_frames_tiled(self, verts: np.ndarray) -> list[np.ndarray]:
        """Batched tile-rasterizer path, full frames: exact at any triangle
        size, no tiers. Returns RGB uint8 frames."""
        gray = render_frames_tiled(
            self._to_device(verts), self._faces_padded, self._face_valid, self.lights
        ).cpu().numpy()
        return [np.repeat(g[..., None], 3, axis=2) for g in gray]

    @torch.no_grad()
    def _render_frames_fast(self, verts: np.ndarray) -> list[np.ndarray]:
        """Batched scatter path: escalate through PATCH_TIERS per FRAME
        (frames already complete at a smaller tier keep their image; only
        unfit frames pay the larger patches), then raise if every frame's
        triangles are too coarse for every tier (the caller takes the exact
        banded rasterizer for those frames)."""
        n = len(verts)
        vd = self._to_device(verts)
        done: dict[int, np.ndarray] = {}
        for patch_h, patch_w in PATCH_TIERS:
            imgs, fit = render_frames_u8(
                vd, self._faces_padded, self._face_valid, self.lights,
                patch_h=patch_h, patch_w=patch_w,
            )
            fit = fit.cpu().numpy()
            for i in range(n):
                if i not in done and fit[i]:
                    done[i] = imgs[i].cpu().numpy()
            if len(done) == n:
                break
        if not done:
            raise ValueError(
                f"triangles exceed the {PATCH_TIERS[-1]} px patch; "
                "using the banded rasterizer"
            )
        # frames no tier could hold render exactly on the banded path;
        # fitting frames keep their (cheaper-tier) images
        return [
            np.repeat(done[i][..., None], 3, axis=2) if i in done else self._render_frame(verts[i])
            for i in range(n)
        ]

    def _render_serial(self, target_verts, images, prev, n_success):
        """Per-frame exact path with the reference's frame-level fault
        tolerance: a failed frame repeats the previous one."""
        for vert in target_verts:
            try:
                img = self._render_frame(np.asarray(vert))
                n_success += 1
            except Exception as e:
                print("Failed rendering frame " + str(e))
                img = prev
            prev = img
            images.append(img)
        return images, prev, n_success

    def render(self, target_verts: np.ndarray) -> list[np.ndarray]:
        """(T, V, 3) vertex animation -> T RGB uint8 (800, 800, 3) frames.

        On a CUDA device: the pipelined tile-rasterizer path, which raises if
        it fails. On the CPU: the scatter path per batch of FRAME_BATCH
        frames and, where that fails, the banded path per frame."""
        n_frames = target_verts.shape[0]
        tic = time.time()
        print(f"Rendering {n_frames} frames...")
        if self.device.type == "cuda":
            images = self._render_pipelined(np.asarray(target_verts, np.float32))
            toc = time.time()
            print(
                f"Rendered {n_frames}/{n_frames} frames in {toc - tic:.2f}s, "
                f"avg: {(toc - tic) / max(n_frames, 1):.3f}s/frame"
            )
            return images
        prev = None
        images = []
        n_success = 0
        for lo in range(0, n_frames, FRAME_BATCH):
            chunk = np.asarray(target_verts[lo : lo + FRAME_BATCH], np.float32)
            try:
                batch = self._render_frames_fast(chunk)
                images.extend(batch)
                prev = batch[-1]
                n_success += len(batch)
            except Exception as e:  # coarse meshes, NaNs mid-bucketing, etc.
                print(
                    f"Fast rasterizer failed on frames {lo}.."
                    f"{lo + len(chunk) - 1} ({type(e).__name__}: {e}); "
                    "using the banded rasterizer"
                )
                images, prev, n_success = self._render_serial(chunk, images, prev, n_success)
        toc = time.time()
        if n_success:
            print(
                f"Rendered {n_success}/{n_frames} frames in {toc - tic:.2f}s, "
                f"avg: {(toc - tic) / n_success:.3f}s/frame"
            )
        return images

    @torch.no_grad()
    def _render_pipelined(self, target_verts: np.ndarray) -> list[np.ndarray]:
        """Tiled path with copy/compute overlap: up to PIPELINE_DEPTH packed
        uint8 device batches are in flight; each is copied with
        ``non_blocking=True`` into a pinned host buffer on a side stream
        behind an event, and the oldest is drained (unpacked and pasted into
        full frames on the host) while the newer ones compute. Each batch
        carries only the face's (CROP_H, CROP_W) window + per-frame offsets.
        Frames whose geometry exceeds the crop window (fit=False) are
        rendered again full-frame, exactly, and only those."""
        height, width = FRUSTUM["height"], FRUSTUM["width"]
        n_frames = len(target_verts)
        tb = self.TRANSFER_BATCH
        dev = self.device
        copy_stream = torch.cuda.Stream(dev)
        # one buffer more than the depth: a batch is queued before the oldest drains
        host_bufs = [
            torch.empty((tb, CROP_H + 1, CROP_W), dtype=torch.uint8, pin_memory=True)
            for _ in range(self.PIPELINE_DEPTH + 1)
        ]
        pending: list[tuple] = []
        images: list[np.ndarray] = []

        def drain():
            host, copied, n, chunk = pending.pop(0)
            copied.synchronize()
            crops, offs, fit = unpack_rendered(host.numpy())
            fit = fit[:n]
            full: dict[int, np.ndarray] = {}
            if not fit.all():
                # oversized geometry: a full-frame render of ONLY the unfit frames
                bad = np.flatnonzero(~fit)
                full = dict(zip(bad.tolist(), self._render_frames_tiled(chunk[bad])))
            images.extend(
                full[i] if i in full else paste_crop(crops[i], offs[i], height, width)
                for i in range(n)
            )

        for k, lo in enumerate(range(0, n_frames, tb)):
            chunk = target_verts[lo : lo + tb]
            n = len(chunk)
            if n < tb:  # one batch shape: the last batch repeats its last frame
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], tb - n, axis=0)])
            buf = render_frames_tiled_packed(
                self._to_device(chunk), self._faces_padded, self._face_valid, self.lights)
            rendered = torch.cuda.Event()
            rendered.record(torch.cuda.current_stream(dev))
            host = host_bufs[k % len(host_bufs)]
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(rendered)
                host.copy_(buf, non_blocking=True)
                buf.record_stream(copy_stream)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            pending.append((host, copied, n, chunk))
            if len(pending) > self.PIPELINE_DEPTH:
                drain()
        while pending:
            drain()
        return images


def paste_crop(crop: np.ndarray, off: np.ndarray, height: int, width: int) -> np.ndarray:
    """Reassemble a full (height, width, 3) uint8 frame from a
    render_frames_tiled_cropped window: background outside the crop."""
    canvas = np.full((height, width), BG_COLOR, np.uint8)
    y, x = int(off[0]), int(off[1])
    canvas[y : y + crop.shape[0], x : x + crop.shape[1]] = crop
    return np.repeat(canvas[..., None], 3, axis=2)


def shade_to_image(shade: np.ndarray) -> np.ndarray:
    """[0,1] intensity (background -1) -> (H, W, 3) uint8, white background.

    Rendered pixels cap at 254 so geometry coverage is always distinguishable
    from the 255 background."""
    img = np.where(shade < 0.0, float(BG_COLOR), np.minimum(shade * 255.0, 254.0))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


def images_to_video(images: list, output: str, fps: int = 60) -> str:
    """Write frames to ``{output}/tmp.mp4`` (cv2, mp4v): the same contract as
    the reference (the argument is a directory)."""
    import cv2

    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "tmp.mp4")
    h, w, _ = images[0].shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    video = cv2.VideoWriter(path, fourcc, fps, (w, h), True)
    for img in images:
        video.write(np.asarray(img))
    video.release()
    print(f"Wrote {len(images)} frames to {path}")
    return path


def verts_to_npy(verts: np.ndarray, output: str) -> None:
    np.save(output, verts)
    print(f"Saved verts to {output}")


def save_audio(audio: np.ndarray, output: str, sample_rate: int = 16000) -> str:
    """int16 wav at 16 kHz (via scipy)."""
    import scipy.io.wavfile as wavfile

    os.makedirs(output, exist_ok=True)
    path = os.path.join(output, "audio.wav")
    audio = np.asarray(audio)
    if audio.ndim == 2:
        audio = audio[0]
    wavfile.write(path, sample_rate, (audio * 32767).astype(np.int16))
    return path

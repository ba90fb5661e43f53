"""The port's tile rasterizer on the CPU vs the JAX package: the prepass
``plane_coefficients`` (rtol 1e-5, boxes equal) and the plain version
``rasterize_keys_reference`` against the Pallas kernel in interpret mode on
the same coefficients.

The plain version evaluates the planes in the Pallas kernel's order (row 0
of a 16-row strip, then one addition per row), so the two differ only where
XLA's CPU code contracts a product and a sum into one fused multiply-add:
the 22-bit depth of a pixel then moves by a few units (reading: at most 4 of
4,194,303) and a pixel on a triangle's edge can fall on the other side. The
bar: a pixel agrees when its quantized depths are within ``DEPTH_STEPS`` and
its shade bytes within 1, and at most ``DISAGREE_SHARE`` of the pixels may
disagree (readings: none on the small screen, 2 of 640,000 on the head); far
below the JAX package's own bar for its rasterizers against each other (1%
of pixels off by more than 3 grey levels).

The kernel evaluates a triangle only on the 16 x 32 sub-tiles that
``subtile_cull`` keeps. The tests below hold that cull sound (no
culled pair has a pixel whose rounded evaluation is inside, on adversarial
triangles), the culled evaluation equal to the unculled plain version key
for key, the work counts to a count by hand, and the C entry point to its
ctypes binding."""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.ops import rasterizer as jrz
from audio2face_tpu.utils import renderer as jrender
from audio2face_tpu_torch.data.synthetic import adversarial_screen_triangles, generate_synthetic_face_obj
from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops import rasterizer as rz
from audio2face_tpu_torch.utils import renderer as render
from audio2face_tpu_torch.utils.facemesh import FaceMesh
from tests.test_torch_attention_abi import c_parameters, kind_of_c, kind_of_ctypes

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores
torch.set_num_threads(1)

DEPTH_STEPS = 16
DISAGREE_SHARE = 2e-5


def _screen_triangles(rng, n_tri, height, width):
    """Random screen-space triangles, three vertices each, with the cases the
    prepass must cull: a zero-area triangle, a NaN vertex, a vertex outside
    the frustum, an off-screen triangle, padding rows."""
    centre = rng.uniform([-20, -10], [width + 20, height + 10], size=(n_tri, 1, 2))
    xy = centre + rng.normal(0, 12, size=(n_tri, 3, 2))
    xy[0] = [[10, 10], [20, 20], [30, 30]]  # collinear: zero area
    xy[1, 0, 0] = np.nan
    xy[2] += 5000.0  # off screen
    xy[3] = [[-30, -30], [width + 30, 5], [40, height + 30]]  # huge: leaves the screen
    n_v = 3 * n_tri
    u, v = xy[..., 0].reshape(n_v).astype(np.float32), xy[..., 1].reshape(n_v).astype(np.float32)
    z = rng.uniform(0.5, 1.5, n_v).astype(np.float32)
    shade = rng.uniform(0, 1, n_v).astype(np.float32)
    visible = np.ones(n_v, bool)
    visible[3 * 4] = False  # one corner of triangle 4 outside the frustum
    faces = np.arange(n_v, dtype=np.int32).reshape(n_tri, 3)
    face_valid = np.arange(n_tri) < n_tri - 10
    return u, v, z, shade, visible, faces, face_valid


def _both_prepasses(args, height, width):
    u, v, z, shade, visible, faces, face_valid = args
    ref = jrz.plane_coefficients(*(jnp.asarray(a) for a in args), height=height, width=width)
    got = rz.plane_coefficients(*(torch.tensor(a) for a in args), height=height, width=width)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_plane_coefficients_match_jax_small_screen():
    args = _screen_triangles(np.random.default_rng(0), 256, 64, 200)
    (rc, rb), (gc, gb) = _both_prepasses(args, 64, 200)
    assert gc.shape == rc.shape == (256, 16) and gb.shape == rb.shape == (2, 4)
    np.testing.assert_allclose(gc, rc, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gb, rb)
    # the culled triangles: a0 = -1 and every other coefficient 0
    for t in (0, 1, 2, 4, 250):
        np.testing.assert_array_equal(gc[t], [-1.0] + [0.0] * 15)
    assert gc[3, 0] != -1.0  # the huge triangle stays


@pytest.fixture(scope="module")
def head():
    with tempfile.TemporaryDirectory() as d:
        mesh = FaceMesh.load(generate_synthetic_face_obj(d + "/face.obj"))
    r = render.Renderer(mesh, device="cpu")
    verts = np.asarray(mesh.verts, np.float32)
    frames = np.stack([verts, np.full_like(verts, np.nan), verts * 4.0])  # NaN; leaves the screen
    proj = render.project_and_shade(torch.tensor(frames), r._faces_padded, r.lights)
    return r, frames, proj


def test_plane_coefficients_match_jax_on_the_head_batched(head):
    """Batched over frames in the port, one frame at a time in JAX, on the
    same projected vertices (a NaN frame and one that leaves the screen)."""
    r, frames, proj = head
    gc, gb = rz.plane_coefficients(*proj, r._faces_padded, r._face_valid, height=800, width=800)
    assert gc.shape == (3, 10240, 16) and gb.shape == (3, 80, 4)
    for i in range(3):
        rc, rb = jrz.plane_coefficients(
            *(jnp.asarray(p[i].numpy()) for p in proj), jnp.asarray(r._faces_padded.numpy()),
            jnp.asarray(r._face_valid.numpy()), height=800, width=800)
        rc = np.asarray(rc)
        scale = np.abs(rc).max(axis=0, keepdims=True)
        np.testing.assert_allclose(gc[i].numpy(), rc, rtol=1e-5, atol=1e-6 * scale.max())
        np.testing.assert_array_equal(gb[i].numpy(), np.asarray(rb))
    assert (gc[1, :, 0] == -1).all() and (gb[1, :, 0] > gb[1, :, 1]).all()  # NaN frame: all culled


def _disagree_share(got, ref):
    depth = np.abs((got >> 8) - (ref >> 8))
    shade = np.abs((got & 0xFF) - (ref & 0xFF))
    return float(((depth > DEPTH_STEPS) | (shade > 1)).mean())


def test_reference_matches_pallas_small_screen():
    """64 x 200 (the width is no multiple of 128), 256 triangles in two
    chunks, two frames of which the second is all padding."""
    h, w = 64, 200
    args = _screen_triangles(np.random.default_rng(1), 256, h, w)
    (rc, rb), _ = _both_prepasses(args, h, w)
    coefs = np.stack([rc, np.tile(np.asarray([-1.0] + [0.0] * 15, np.float32), (256, 1))])
    bbox = np.stack([rb, np.tile(np.asarray([1, 0, 1, 0], np.int32), (2, 1))])
    ref = np.asarray(jrz.rasterize_keys(
        jnp.asarray(coefs), jnp.asarray(bbox), height=h, width=w, interpret=True))
    rz.rasterize_keys.launches = 0
    got = rz.rasterize_keys(torch.tensor(coefs), torch.tensor(bbox), height=h, width=w).numpy()
    assert got.shape == ref.shape == (2, h, w) and got.dtype == np.int32
    assert rz.rasterize_keys.launches == 0 and not _build._libs  # CPU tensors: the plain version
    assert _disagree_share(got, ref) <= DISAGREE_SHARE
    assert (got[0] != 0).mean() > 0.3 and (got[1] == 0).all()
    # the zero-area triangle (pixels around (10..30, 10..30)) draws nothing of its own:
    # with it marked as padding the keys are the same
    solo = list(args)
    solo[6] = args[6].copy()
    solo[6][0] = False
    sc, sb = rz.plane_coefficients(*(torch.tensor(a) for a in solo), height=h, width=w)
    np.testing.assert_array_equal(
        rz.rasterize_keys(sc[None], sb[None], height=h, width=w).numpy()[0], got[0])


def test_reference_matches_pallas_on_the_head_800(head):
    """One 800 x 800 frame of the synthetic 5,023-vertex head, on the JAX
    prepass's coefficients; the NaN frame renders as background and the
    enlarged frame (triangles leave the screen) stays finite."""
    r, frames, proj = head
    coefs, bbox = rz.plane_coefficients(*proj, r._faces_padded, r._face_valid, height=800, width=800)
    ref = np.asarray(jrz.rasterize_keys(
        jnp.asarray(coefs[:1].numpy()), jnp.asarray(bbox[:1].numpy()),
        height=800, width=800, interpret=True))
    got = rz.rasterize_keys(coefs, bbox, height=800, width=800).numpy()
    assert _disagree_share(got[:1], ref) <= DISAGREE_SHARE
    assert (got[0] != 0).mean() > 0.05 and (got[1] == 0).all()
    assert (got[2] != 0).mean() > (got[0] != 0).mean()
    iz, sq = got[got != 0] >> 8, got[got != 0] & 0xFF
    assert iz.min() >= 1 and iz.max() <= (1 << 22) - 1 and sq.max() <= 254


def test_rasterize_keys_checks_its_inputs():
    coefs, bbox = torch.zeros(1, 128, 16), torch.zeros(1, 1, 4, dtype=torch.int32)
    for bad, match in [
        (dict(coefs=torch.zeros(1, 100, 16)), "T % 128"),
        (dict(bbox=torch.zeros(1, 2, 4, dtype=torch.int32)), "does not match"),
        (dict(coefs=coefs.double()), "float32"),
        (dict(height=70), "multiple of 16"),
    ]:
        kw = {**dict(coefs=coefs, bbox=bbox, height=64, width=100), **bad}
        with pytest.raises(ValueError, match=match):
            rz.rasterize_keys(kw["coefs"], kw["bbox"], height=kw["height"], width=kw["width"])
    with pytest.raises(ValueError, match="multiple of 128"):
        rz.plane_coefficients(*(torch.zeros(3),) * 4, torch.ones(3, dtype=torch.bool),
                              torch.zeros(1, 3, dtype=torch.int64), torch.ones(1, dtype=torch.bool),
                              height=64, width=64)
    assert rz.tile_range(-5, 40, 16, 4) == (0, 2) and rz.tile_range(3200, -3200, 128, 7) == (25, -25)
    assert jrender.RASTER_BATCH == 16  # the JAX kernel's batch cap; the port has none


def _strip_planes(coefs, height, width):
    """Per row r of every 16-row strip, the rounded (w0, w1, w2) of every
    triangle at every pixel centre, in the kernel's evaluation order:
    yields (r, w0, w1, w2), each (T, strips, width)."""
    n_tri = coefs.shape[0]
    a0, b0, c0, a1, b1, c1 = (coefs[:, j].reshape(n_tri, 1, 1) for j in range(6))
    px = (torch.arange(width, dtype=torch.float32) + 0.5).reshape(1, 1, -1)
    py0 = (torch.arange(height // rz.STRIP_H, dtype=torch.float32) * rz.STRIP_H + 0.5).reshape(1, -1, 1)
    w0, w1 = a0 + b0 * px + c0 * py0, a1 + b1 * px + c1 * py0
    for r in range(rz.STRIP_H):
        if r:
            w0, w1 = w0 + c0, w1 + c1
        yield r, w0, w1, 1.0 - w0 - w1


def _subtile_grid(height, width):
    sx = torch.arange(0, width, rz.SUB_W)
    ys = torch.arange(height // rz.STRIP_H) * rz.STRIP_H
    return ys[:, None], sx[None, :], (width - sx).clamp(max=rz.SUB_W)[None, :]


def _inside_by_subtile(coefs, height, width):
    """(T, strips, sub-tiles) bool: does any pixel of the sub-tile pass the
    inside test in the rounded evaluation order."""
    n_sub = -(-width // rz.SUB_W)
    found = torch.zeros(coefs.shape[0], height // rz.STRIP_H, n_sub, dtype=torch.bool)
    for _, w0, w1, w2 in _strip_planes(coefs, height, width):
        inside = torch.nn.functional.pad((w0 >= 0) & (w1 >= 0) & (w2 >= 0), (0, n_sub * rz.SUB_W - width))
        found |= inside.reshape(*inside.shape[:2], n_sub, rz.SUB_W).any(-1)
    return found


def _inside_by_row(coefs, height, width):
    """Per row r of the strips, (T, strips, sub-tiles) bool: does any pixel
    of row r of the sub-tile pass the inside test."""
    n_sub = -(-width // rz.SUB_W)
    for _, w0, w1, w2 in _strip_planes(coefs, height, width):
        inside = torch.nn.functional.pad((w0 >= 0) & (w1 >= 0) & (w2 >= 0), (0, n_sub * rz.SUB_W - width))
        yield inside.reshape(*inside.shape[:2], n_sub, rz.SUB_W).any(-1)


def _adversarial_coefs(seed, height, width, nan=False):
    args = [torch.tensor(a) for a in adversarial_screen_triangles(seed, height, width)]
    if nan:
        args[0], args[1] = torch.full_like(args[0], float("nan")), torch.full_like(args[1], float("nan"))
    return rz.plane_coefficients(*args, height=height, width=width)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cull_is_sound_on_adversarial_triangles(seed):
    """Slivers of 1e-9 to 1e-3 px^2, triangles 10^5 px across, vertices and
    edges on pixel centres and sub-tile borders, prepass-culled rows, on a
    96 x 200 screen (the last sub-tile 8 columns wide): no pair that
    ``subtile_cull`` culls has an inside pixel. Without the margin
    (tau = 0) these frames hold such pairs."""
    h, w = 96, 200
    coefs, _ = _adversarial_coefs(seed, h, w)
    ys, sx, tw = _subtile_grid(h, w)
    cover, row_lo, row_hi = rz.subtile_cull(coefs, ys, sx, rz.STRIP_H, tw)
    found = _inside_by_subtile(coefs, h, w)
    assert cover.shape == found.shape == (coefs.shape[0], 6, 7)
    assert not (found & ~cover).any()
    # nor has a kept pair an inside pixel on a row outside its row range
    for r, found_r in enumerate(_inside_by_row(coefs, h, w)):
        assert not (found_r & cover & ((r < row_lo) | (r > row_hi))).any()
    assert (row_hi - row_lo)[cover].float().mean() < 15  # the ranges do cut rows
    assert found.sum() > 1000 and cover.float().mean() < 0.2  # the frames draw, and the cull culls
    live = coefs[:, 0] != -1
    assert not cover[~live].any()  # rows the prepass culled cull themselves


def test_cull_is_sound_on_random_triangles_and_the_small_screen():
    h, w = 64, 200
    args = _screen_triangles(np.random.default_rng(5), 512, h, w)
    coefs, _ = rz.plane_coefficients(*(torch.tensor(a) for a in args), height=h, width=w)
    ys, sx, tw = _subtile_grid(h, w)
    cover = rz.subtile_cull(coefs, ys, sx, rz.STRIP_H, tw)[0]
    found = _inside_by_subtile(coefs, h, w)
    assert not (found & ~cover).any() and found.any()
    # the cull is tight: a kept pair is, in nearly all cases, one with an inside pixel
    assert cover.sum() <= 2 * found.sum()


def test_cull_of_nan_infinite_and_prepass_culled_coefficients():
    ys, sx, tw = _subtile_grid(32, 64)
    culled = torch.tensor([[-1.0] + [0.0] * 15])
    nan = culled.clone()
    nan[0, :6] = float("nan")
    nan_b = torch.tensor([[0.5, float("nan"), 0.0, 0.25, 0.0, 0.0] + [0.0] * 10])
    huge = torch.tensor([[2.0**110, 0.0, 0.0, -2.0**110, 0.0, 0.0] + [0.0] * 10])
    inf = torch.tensor([[float("inf"), 0.0, 0.0, 0.0, 0.0, 0.0] + [0.0] * 10])
    whole = torch.tensor([[0.25, 0.0, 0.0, 0.25, 0.0, 0.0] + [0.0] * 10])  # inside everywhere
    cover = rz.subtile_cull(torch.cat([culled, nan, nan_b, huge, inf, whole]), ys, sx, 16, tw)[0]
    assert cover.shape == (6, 2, 2)
    assert not cover[:3].any()  # the prepass's marker and NaN planes cull
    assert cover[3:].all()  # S above 2^100 or infinite: never culled; a covering plane is kept
    # the NaN frame of the prepass: every row culled, every chunk box empty
    coefs, bbox = _adversarial_coefs(0, 96, 200, nan=True)
    assert (coefs[:, 0] == -1).all() and (bbox[:, 0] > bbox[:, 1]).all()
    assert rz.subtile_pairs(coefs[None], bbox[None], height=96, width=200).tolist() == [0]


def culled_keys(coefs, chunk_bbox, *, height, width):
    """The kernel's design in torch ops: ``rasterize_keys_reference``'s loop,
    each triangle of a chunk evaluated only on the 16 x 32 sub-tiles and the
    rows of them that ``subtile_cull`` keeps."""
    n_frames = coefs.shape[0]
    out = torch.zeros((n_frames, height, width), dtype=torch.int32)
    n_strips, n_xblocks = height // rz.STRIP_H, -(-width // rz.XBLOCK)
    cols = torch.arange(width, dtype=torch.float32) + 0.5
    for f in range(n_frames):
        for c, (xmin, xmax, ymin, ymax) in enumerate(chunk_bbox[f].tolist()):
            s0, s1 = rz.tile_range(ymin, ymax, rz.STRIP_H, n_strips)
            b0, b1 = rz.tile_range(xmin, xmax, rz.XBLOCK, n_xblocks)
            if s0 > s1 or b0 > b1:
                continue
            x_lo, x_hi = b0 * rz.XBLOCK, min((b1 + 1) * rz.XBLOCK, width)
            ck = coefs[f, c * rz.TRI_CHUNK:(c + 1) * rz.TRI_CHUNK, :12]
            sx = torch.arange(x_lo, x_hi, rz.SUB_W)
            per_subtile = rz.subtile_cull(
                ck, (torch.arange(s0, s1 + 1) * rz.STRIP_H)[:, None], sx[None, :], rz.STRIP_H,
                (width - sx).clamp(max=rz.SUB_W)[None, :])  # (128, strips, sub-tiles) each
            cover, row_lo, row_hi = (
                t_.repeat_interleave(rz.SUB_W, dim=2)[:, :, :x_hi - x_lo] for t_ in per_subtile)
            a0, b0_, c0, a1, b1_, c1, az, bz, cz, as_, bs, cs = (
                ck[:, j].reshape(rz.TRI_CHUNK, 1, 1) for j in range(12))
            px = cols[x_lo:x_hi].reshape(1, 1, -1)
            py0 = (torch.arange(s0, s1 + 1, dtype=torch.float32) * rz.STRIP_H + 0.5).reshape(1, -1, 1)
            w0, w1 = a0 + b0_ * px + c0 * py0, a1 + b1_ * px + c1 * py0
            iz, soz = az + bz * px + cz * py0, as_ + bs * px + cs * py0
            rows = []
            for r in range(rz.STRIP_H):
                if r:
                    w0, w1, iz, soz = w0 + c0, w1 + c1, iz + cz, soz + cs
                w2 = 1.0 - w0 - w1
                inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & cover & (row_lo <= r) & (r <= row_hi)
                izi = torch.where(inside, iz, torch.ones_like(iz))
                s = torch.where(inside, soz, torch.zeros_like(soz)) / izi.clamp(min=1e-12)
                izq = (izi * rz.IZ_MAX).clamp(1.0, rz.IZ_MAX).to(torch.int32)
                sq = (s * 255.0).clamp(max=254.0).clamp(0.0, 254.0).to(torch.int32)
                rows.append(torch.where(inside, (izq << 8) | sq, torch.zeros_like(izq)).amax(dim=0))
            acc = torch.stack(rows, dim=1).reshape((s1 - s0 + 1) * rz.STRIP_H, x_hi - x_lo)
            region = out[f, s0 * rz.STRIP_H:(s1 + 1) * rz.STRIP_H, x_lo:x_hi]
            torch.maximum(region, acc, out=region)
    return out


def test_culled_evaluation_equals_the_plain_version_on_the_head_800(head):
    """Frame 0 of the synthetic head, its NaN frame and its enlarged frame
    (triangles leave the screen), at 800 x 800: key for key."""
    r, frames, proj = head
    coefs, bbox = rz.plane_coefficients(*proj, r._faces_padded, r._face_valid, height=800, width=800)
    want = rz.rasterize_keys_reference(coefs, bbox, height=800, width=800)
    got = culled_keys(coefs, bbox, height=800, width=800)
    assert torch.equal(got, want) and (want[0] != 0).any() and not want[1].any()


@pytest.mark.parametrize("case", ["small_screen", "adversarial"])
def test_culled_evaluation_equals_the_plain_version(case):
    """The small screen of ``test_reference_matches_pallas_small_screen``
    (64 x 200, a padding frame), and three adversarial frames with a NaN
    frame on 96 x 200: key for key."""
    if case == "small_screen":
        h, w = 64, 200
        args = _screen_triangles(np.random.default_rng(1), 256, h, w)
        c, b = rz.plane_coefficients(*(torch.tensor(a) for a in args), height=h, width=w)
        coefs = torch.stack([c, torch.tensor([-1.0] + [0.0] * 15).expand(256, 16)])
        bbox = torch.stack([b, torch.tensor([1, 0, 1, 0], dtype=torch.int32).expand(2, 4)])
    else:
        h, w = 96, 200
        pairs = [_adversarial_coefs(s, h, w, nan=(s == 3)) for s in range(4)]
        coefs, bbox = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    want = rz.rasterize_keys_reference(coefs, bbox, height=h, width=w)
    assert torch.equal(culled_keys(coefs, bbox, height=h, width=w), want)
    assert (want[0] != 0).float().mean() > 0.3 and not want[-1].any()


def test_work_counts_match_a_count_by_hand():
    """Two triangles in one chunk on a 48 x 128 screen. A: (0, 0), (40, 0),
    (0, 20): pixel centres x 0.5..39.5 and y 0.5..19.5 in its box, 40 x 20 =
    800; it may cover the sub-tiles (rows 0-15, columns 0-31), (0-15, 32-63)
    and (16-31, 0-31), not (16-31, 32-63), whose nearest centre (32.5, 16.5)
    lies past the hypotenuse (32.5 / 40 + 16.5 / 20 > 1). B: (100, 40),
    (110, 40), (100, 45): 10 x 5 = 50 box pixels in the one sub-tile (32-47,
    96-127). The chunk's box [0, 110] x [0, 45] overlaps the strips 0-2 of
    the one x block: 3 tile-chunk pairs."""
    xy = np.array([[[0, 0], [40, 0], [0, 20]], [[100, 40], [110, 40], [100, 45]]], np.float32)
    u = np.zeros(384, np.float32)
    v = np.zeros(384, np.float32)
    u[:6], v[:6] = xy[..., 0].reshape(6), xy[..., 1].reshape(6)
    faces = torch.arange(384, dtype=torch.int32).reshape(128, 3)
    valid = torch.arange(128) < 2
    args = (torch.tensor(u)[None], torch.tensor(v)[None], torch.ones(1, 384), torch.ones(1, 384),
            torch.ones(1, 384, dtype=torch.bool))
    coefs, bbox = rz.plane_coefficients(*args, faces, valid, height=48, width=128)
    assert bbox.tolist() == [[[0, 110, 0, 45]]]
    assert rz.triangle_box_pixels(args[0], args[1], faces, coefs, height=48, width=128).tolist() == [850]
    assert rz.tile_chunk_pairs(bbox, height=48, width=128).tolist() == [3]
    assert rz.subtile_pairs(coefs, bbox, height=48, width=128).tolist() == [4]
    ys, sx, tw = _subtile_grid(48, 128)
    cover = rz.subtile_cull(coefs[0, :2], ys, sx, rz.STRIP_H, tw)[0]
    assert cover[0].nonzero().tolist() == [[0, 0], [0, 1], [1, 0]]
    assert cover[1].nonzero().tolist() == [[2, 3]]


def test_rasterize_keys_c_signature_matches_ctypes():
    params = c_parameters("rasterizer.cu", "a2f_rasterize_keys")
    assert [kind_of_c(p) for p in params] == [kind_of_ctypes(t) for t in rz._ARGTYPES], params
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names == ["coefs", "bbox", "out", "n_frames", "n_chunks", "height", "width", "stream"]

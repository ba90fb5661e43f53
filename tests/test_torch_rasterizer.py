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
of pixels off by more than 3 grey levels)."""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.ops import rasterizer as jrz
from audio2face_tpu.utils import renderer as jrender
from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj
from audio2face_tpu_torch.ops import _build
from audio2face_tpu_torch.ops import rasterizer as rz
from audio2face_tpu_torch.utils import renderer as render
from audio2face_tpu_torch.utils.facemesh import FaceMesh

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

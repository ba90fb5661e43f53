"""The port's renderer on the CPU vs the JAX renderer and the golden PNG.

Projection, shading and normals to 1e-5; rendered images at the JAX tests'
own bar (fewer than 1% of the pixels off by more than 3 grey levels: depth
keys are quantized to 22 bits and sums round in another order, which flips
a handful of silhouette pixels); the cropped and packed forms exactly against
the port's own full frames, as the JAX tests hold theirs."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.utils import renderer as jrender
from audio2face_tpu.utils.facemesh import FaceMesh as JaxFaceMesh
from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj
from audio2face_tpu_torch.ops.rasterizer import rasterize_keys
from audio2face_tpu_torch.utils import renderer as render
from audio2face_tpu_torch.utils.facemesh import FaceMesh

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "render_golden.png")


def _off_share(a, b):
    """Share of pixels off by more than 3 grey levels (the JAX tests' measure)."""
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    if diff.ndim == 3:
        diff = diff.max(axis=-1)
    return float((diff > 3).mean())


@pytest.fixture(scope="module")
def head():
    with tempfile.TemporaryDirectory() as d:
        path = generate_synthetic_face_obj(d + "/face.obj")
        mesh, jmesh = FaceMesh.load(path), JaxFaceMesh.load(path)
    return (render.Renderer(mesh, device="cpu"), jrender.Renderer(jmesh),
            np.asarray(mesh.verts, np.float32))


def _double_triangle_mesh():
    # a large triangle centred on the optical axis, 0.5 m from the camera,
    # plus a back triangle that must be occluded
    verts = np.array(
        [[-0.05, -0.05, 0.5], [0.05, -0.05, 0.5], [0.0, 0.05, 0.5],
         [-0.05, -0.05, 0.3], [0.05, -0.05, 0.3], [0.0, 0.05, 0.3]], np.float32)
    return FaceMesh(verts, np.array([[0, 1, 2], [3, 4, 5]]))


def test_lights_and_constants_match_jax():
    np.testing.assert_array_equal(render.light_positions(), jrender.light_positions())
    for aa in ([0.5, 0, 0], [0, -0.5236, 0], [0.1, 0.2, 0.3], [0, 0, 0]):
        np.testing.assert_array_equal(
            render._rodrigues(np.asarray(aa, np.float64)), jrender._rodrigues(np.asarray(aa, np.float64)))
    for name in ("CAMERA_F", "CAMERA_C", "FRUSTUM", "AMBIENT", "LIGHT_INTENSITY", "BG_COLOR",
                 "ROW_BLOCK", "TRI_CHUNK", "PATCH_TIERS", "FRAME_BATCH", "_FLAT_CHUNK", "_IZ_SCALE",
                 "CROP_H", "CROP_W"):
        assert getattr(render, name) == getattr(jrender, name), name
    assert (render.Renderer.PIPELINE_DEPTH, render.Renderer.TRANSFER_BATCH) == (
        jrender.Renderer.PIPELINE_DEPTH, jrender.Renderer.TRANSFER_BATCH)


def test_project_and_shade_and_normals_match_jax(head):
    r, jr, verts = head
    frames = np.stack([verts, verts * 1.3 + 0.01])
    got_n = render.vertex_normals(torch.tensor(frames), r.faces).numpy()
    got = [t.numpy() for t in render.project_and_shade(torch.tensor(frames), r.faces, r.lights)]
    for i in range(2):
        ref_n = np.asarray(jrender.vertex_normals(jnp.asarray(frames[i]), jr.faces))
        np.testing.assert_allclose(got_n[i], ref_n, atol=1e-5, rtol=0)
        ref = jrender.project_and_shade(jnp.asarray(frames[i]), jr.faces, jr.lights)
        for g, w, name in zip(got, ref, ("u", "v", "z", "shade", "visible")):
            w = np.asarray(w)
            if w.dtype == bool:
                np.testing.assert_array_equal(g[i], w, err_msg=name)
            else:
                np.testing.assert_allclose(g[i], w, rtol=1e-5, atol=1e-5, err_msg=name)
    # the unreferenced vertices at the south pole get a zero normal, not NaN
    assert np.isfinite(got_n).all()
    quad = torch.tensor([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=torch.float32)
    n = render.vertex_normals(quad, torch.tensor([[0, 1, 2], [0, 2, 3]])).numpy()
    np.testing.assert_allclose(np.abs(n[:, 2]), 1.0, atol=1e-6)


def test_banded_frame_matches_jax_and_the_golden(head):
    import cv2

    r, jr, verts = head
    img = r._render_frame(verts)
    assert img.shape == (800, 800, 3) and img.dtype == np.uint8
    assert _off_share(img, jr._render_frame(verts)) < 0.01
    want = cv2.imread(GOLDEN, cv2.IMREAD_COLOR)
    assert want is not None and img.shape == want.shape
    assert _off_share(img, want) < 0.01
    assert (img.max(axis=-1) < 250).mean() > 0.05  # the face covers a real part of the frame


def test_banded_zbuffer_and_empty_frame():
    mesh = _double_triangle_mesh()
    r = render.Renderer(mesh, device="cpu")
    jr = jrender.Renderer(JaxFaceMesh(mesh.verts, mesh.faces))
    img = r._render_frame(mesh.verts)
    np.testing.assert_array_equal(img, jr._render_frame(mesh.verts))
    ys, xs = np.where(img[:, :, 0] != 255)
    assert len(xs) > 500 and 300 < xs.mean() < 500 and 300 < ys.mean() < 500
    behind = mesh.verts + np.asarray([0, 0, 5.0], np.float32)  # behind the camera: nothing drawn
    assert (r._render_frame(behind) == 255).all()


def test_scatter_path_matches_jax(head):
    r, jr, verts = head
    frames = np.stack([verts, np.full_like(verts, np.nan)])
    imgs, fit = render.render_frames_u8(
        torch.tensor(frames), r._faces_padded, r._face_valid, r.lights, patch_h=16, patch_w=24)
    ref, ref_fit = jrender.render_frames_u8(
        jnp.asarray(frames), jr._faces_padded, jr._face_valid, jr.lights, patch_h=16, patch_w=24)
    assert imgs.dtype == torch.uint8 and fit.tolist() == np.asarray(ref_fit).tolist() == [True, True]
    assert _off_share(imgs.numpy()[0], np.asarray(ref)[0]) < 0.01
    assert (imgs[0] != 255).float().mean() > 0.05 and (imgs[1] == 255).all()
    assert _off_share(imgs.numpy()[0], r._render_frame(verts)[:, :, 0]) < 0.01
    # a patch smaller than the triangles: reported, not drawn
    _, small = render.render_frames_u8(
        torch.tensor(frames[:1]).repeat(2, 1, 1), r._faces_padded, r._face_valid, r.lights,
        patch_h=2, patch_w=2)
    assert small.tolist() == [False, False]


def test_tiled_paths_match_jax_and_each_other(head):
    r, jr, verts = head
    frames = np.stack([verts, np.full_like(verts, np.nan)])
    args = (torch.tensor(frames), r._faces_padded, r._face_valid, r.lights)
    rasterize_keys.launches = 0
    full = render.render_frames_tiled(*args).numpy()
    ref = np.asarray(jrender.render_frames_tiled(
        jnp.asarray(frames[:1]), jr._faces_padded, jr._face_valid, jr.lights, interpret=True))
    assert full.shape == (2, 800, 800) and full.dtype == np.uint8
    assert _off_share(full[0], ref[0]) < 0.01
    assert _off_share(full[0], r._render_frame(verts)[:, :, 0]) < 0.01  # the banded oracle
    assert (full[0] != 255).mean() > 0.05 and (full[1] == 255).all()

    crops, offs, fit = (t.numpy() for t in render.render_frames_tiled_cropped(*args))
    assert fit.tolist() == [True, True]  # NaN frame: all culled -> any window
    assert crops.shape == (2, render.CROP_H, render.CROP_W) and offs.dtype == np.int32
    for i in range(2):
        np.testing.assert_array_equal(render.paste_crop(crops[i], offs[i], 800, 800)[:, :, 0], full[i])
    assert (crops[0] != 255).mean() > 0.10 and (crops[1] == 255).all()
    _, _, small_fit = render.render_frames_tiled_cropped(*args, crop_h=64, crop_w=128)
    assert small_fit.tolist() == [False, True]

    buf = render.render_frames_tiled_packed(*args).numpy()
    assert buf.shape == (2, render.CROP_H + 1, render.CROP_W) and buf.dtype == np.uint8
    for got, want in zip(render.unpack_rendered(buf), (crops, offs, fit)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(jrender.unpack_rendered(buf), (crops, offs, fit)):
        np.testing.assert_array_equal(got, want)
    rgb = r._render_frames_tiled(frames)
    np.testing.assert_array_equal(rgb[0], np.repeat(full[0][..., None], 3, axis=2))
    assert rasterize_keys.launches == 0  # CPU tensors: the plain version throughout
    with pytest.raises(ValueError, match="crop"):
        render.render_frames_tiled_cropped(*args, crop_w=4)


def test_crop_window_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.uniform(-100, 900, size=(5, 40)).astype(np.float32)
    v = rng.uniform(-100, 900, size=(5, 40)).astype(np.float32)
    vis = rng.random((5, 40)) > 0.2
    u[1], v[1] = rng.uniform(300, 500, 40), rng.uniform(200, 700, 40)  # fits
    u[2, 3] = np.nan
    vis[3] = False  # nothing valid: fit, offset 0
    u[4], v[4] = rng.uniform(700, 790, 40), rng.uniform(750, 799, 40)  # clamps at the corner
    kw = dict(height=800, width=800, crop_h=640, crop_w=512)
    offs, fit = render._crop_window(torch.tensor(u), torch.tensor(v), torch.tensor(vis), **kw)
    for i in range(5):
        ro, rf = jrender._crop_window(jnp.asarray(u[i]), jnp.asarray(v[i]), jnp.asarray(vis[i]), **kw)
        np.testing.assert_array_equal(offs[i].numpy(), np.asarray(ro))
        assert bool(fit[i]) == bool(rf)
    assert fit.tolist() == [False, True, False, True, True]


def test_host_helpers_match_jax():
    rng = np.random.default_rng(1)
    crop = rng.integers(0, 255, size=(64, 48), dtype=np.uint8)
    np.testing.assert_array_equal(
        render.paste_crop(crop, np.asarray([30, 100]), 128, 160),
        jrender.paste_crop(crop, np.asarray([30, 100]), 128, 160))
    shade = rng.uniform(-1, 1.2, size=(32, 32)).astype(np.float32)
    np.testing.assert_array_equal(render.shade_to_image(shade), jrender.shade_to_image(shade))
    keys = torch.tensor([[0, (5 << 8) | 17], [(9 << 8) | 254, 0]], dtype=torch.int32)
    assert render.keys_to_image(keys).tolist() == [[255, 17], [254, 255]]


def test_cpu_render_coarse_mesh_takes_the_banded_path():
    """Triangles bigger than every patch tier raise in the scatter path and
    come out pixel-equal through render()'s banded path; two equal frames
    give two equal images."""
    mesh = _double_triangle_mesh()
    r = render.Renderer(mesh, device="cpu")
    with pytest.raises(ValueError, match="banded"):
        r._render_frames_fast(np.stack([mesh.verts]))
    images = r.render(np.stack([mesh.verts, mesh.verts]))
    assert len(images) == 2
    np.testing.assert_array_equal(images[0], r._render_frame(mesh.verts))
    np.testing.assert_array_equal(images[0], images[1])


def test_cpu_render_nan_frame_is_background_and_failed_frame_repeats(head, monkeypatch):
    r, _, verts = head
    bad = np.full_like(verts, np.nan)
    fast = r._render_frames_fast(np.stack([verts, bad]))
    assert (fast[1] == 255).all() and (fast[0][:, :, 0] != 255).mean() > 0.05
    images = r.render(np.stack([verts, bad]))
    assert len(images) == 2 and images[0].shape == (800, 800, 3) and (images[1] == 255).all()
    np.testing.assert_array_equal(images[0], fast[0])
    # the reference's frame-level fault tolerance: a frame whose render fails
    # repeats the previous frame's image
    mesh = _double_triangle_mesh()
    coarse = render.Renderer(mesh, device="cpu")
    real, calls = coarse._render_frame, []

    def flaky(v):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("boom")
        return real(v)

    monkeypatch.setattr(coarse, "_render_frame", flaky)
    images = coarse.render(np.stack([mesh.verts, mesh.verts * 0.5]))
    assert len(calls) == 2
    np.testing.assert_array_equal(images[1], images[0])


def test_images_to_video_and_audio(tmp_path):
    img = np.full((64, 64, 3), 255, np.uint8)
    path = render.images_to_video([img, img, img], str(tmp_path), fps=30)
    assert path.endswith("tmp.mp4") and os.path.getsize(path) > 0
    wav = render.save_audio(np.zeros(1600, np.float32), str(tmp_path))
    assert os.path.getsize(wav) > 0
    render.verts_to_npy(np.zeros((2, 3, 3), np.float32), str(tmp_path / "v.npy"))
    assert np.load(tmp_path / "v.npy").shape == (2, 3, 3)

"""Port FaceFormer and its DSP helpers vs the JAX package.

The whole model runs in f32 with weights carried from a JAX init (motion
maps randomized: the init zeroes them, which would make the output equal
the template) and is held to the repo's conversion bar, max per-vertex L2
< 1e-4 (BASELINE.md)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models import faceformer as jff
from audio2face_tpu.ops import dsp as jdsp
from audio2face_tpu_torch.compat.jax_params import faceformer_state_dict_from_jax
from audio2face_tpu_torch.models import faceformer as ff
from audio2face_tpu_torch.ops import dsp

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

N_VERTS = 300


def test_frame_count_int32_near_wrap():
    lens = [38_400_000, 60 * 16000, 127, 0, 2**31 - 1]
    ref = np.asarray(jff.frame_count(jnp.asarray(lens, jnp.int32)))
    got = ff.frame_count(torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ref, [n * 60 // 16000 for n in lens])
    assert ff.frame_count(16000) == 60


def test_normalize_waveform_masked():
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(3, 4000)) * 0.3 + 0.05).astype(np.float32)
    lengths = np.asarray([4000, 2500, 0], np.int32)
    for lens in (None, lengths):
        ref = np.asarray(jff.normalize_waveform(
            jnp.asarray(audio), None if lens is None else jnp.asarray(lens)))
        got = ff.normalize_waveform(
            torch.tensor(audio), None if lens is None else torch.tensor(lens)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_interp_linear_per_item():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 49, 8)).astype(np.float32)
    in_l = np.asarray([49, 30, 2], np.int32)
    out_l = np.asarray([60, 37, 3], np.int32)
    ref = np.asarray(jdsp.interp_linear_per_item(
        jnp.asarray(x), 60, jnp.asarray(in_l), jnp.asarray(out_l)))
    got = dsp.interp_linear_per_item(
        torch.tensor(x), 60, torch.tensor(in_l), torch.tensor(out_l)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
def test_interp_linear(align_corners):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 49, 5)).astype(np.float32)
    ref = np.asarray(jdsp.interp_linear(jnp.asarray(x), 60, axis=1, align_corners=align_corners))
    got = dsp.interp_linear(torch.tensor(x), 60, axis=1, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_resample_from_22050():
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(2, 11025)) * 0.1).astype(np.float32)
    ref = np.asarray(jdsp.resample(jnp.asarray(a), 22050, 16000))
    got = dsp.resample(torch.tensor(a), 22050, 16000).numpy()
    assert got.shape == ref.shape == (2, 8000)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_wav2vec2_normalization_and_int16():
    pcm = np.asarray([[-32768, 0, 16384, 32767]], np.int16)
    np.testing.assert_array_equal(
        dsp.normalize_int16(torch.tensor(pcm)).numpy(),
        np.asarray(jdsp.normalize_int16(jnp.asarray(pcm))),
    )
    x = np.linspace(-1, 2, 50, dtype=np.float32)[None]
    np.testing.assert_allclose(
        dsp.wav2vec2_zero_mean_unit_var(torch.tensor(x)).numpy(),
        np.asarray(jdsp.wav2vec2_zero_mean_unit_var(jnp.asarray(x))), rtol=1e-5, atol=1e-6,
    )


def test_select_decode_impl(monkeypatch):
    assert ff.select_decode_impl(torch.device("cpu")) == "loop"
    assert ff.select_decode_impl(torch.device("cpu"), dataset="biwi") == "loop"
    with pytest.raises(ValueError, match="unknown dataset"):
        ff.select_decode_impl(torch.device("cpu"), dataset="mead")
    # CUDA picks the kernel (BIWI: its 2-way cross-softmax variant, which
    # needs more shared memory), and raises (no fallback) where its weights
    # do not fit one block's shared memory
    monkeypatch.setattr(ff.decode_kernel, "smem_fits", lambda device, biwi=False: True)
    assert ff.select_decode_impl(torch.device("cuda")) == "fused"
    assert ff.select_decode_impl(torch.device("cuda"), dataset="biwi") == "fused"
    assert ff.select_decode_impl(torch.device("cuda"), dataset="biwi", train=True) == "steps"
    monkeypatch.setattr(ff.decode_kernel, "smem_fits", lambda device, biwi=False: not biwi)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "a small card")
    assert ff.select_decode_impl(torch.device("cuda")) == "fused"
    with pytest.raises(RuntimeError, match=str(ff.decode_kernel.SMEM_BYTES_BIWI)):
        ff.select_decode_impl(torch.device("cuda"), dataset="biwi")
    monkeypatch.setattr(ff.decode_kernel, "smem_fits", lambda device, biwi=False: False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "a small card")
    with pytest.raises(RuntimeError, match="shared"):
        ff.select_decode_impl(torch.device("cuda"))


def jax_faceformer_params(rng, audio, one_hot, template):
    """Random JAX FaceFormer params with randomized motion maps."""
    model = jff.FaceFormer(n_verts=N_VERTS, n_onehot=12, decode_impl="scan")
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), audio, one_hot, template)
    params = dict(jax.tree.map(np.asarray, variables["params"]))
    for name, shape in [("vertice_map_kernel", (N_VERTS, 64)), ("vertice_map_bias", (64,)),
                        ("vertice_map_r_kernel", (64, N_VERTS)), ("vertice_map_r_bias", (N_VERTS,))]:
        params[name] = rng.normal(0, 0.05, shape).astype(np.float32)
    return model, params


def test_whole_faceformer_matches_jax():
    rng = np.random.default_rng(4)
    b, s = 2, 16000
    audio = (rng.normal(size=(b, s)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[1, 5]]
    template = rng.normal(size=(b, N_VERTS // 3, 3)).astype(np.float32)
    lengths = np.asarray([s, 11000], np.int32)
    model, params = jax_faceformer_params(rng, audio, one_hot, template)
    ref, ref_mask = jax.jit(lambda p, a, o, t, l: model.apply({"params": p}, a, o, t, l))(
        params, audio, one_hot, template, lengths)
    ref, ref_mask = np.asarray(ref), np.asarray(ref_mask)

    port = ff.FaceFormer(N_VERTS, 12)
    port.load_state_dict(faceformer_state_dict_from_jax(params))
    port.eval()
    with torch.no_grad():
        out, mask = port(torch.tensor(audio), torch.tensor(one_hot), torch.tensor(template),
                         torch.tensor(lengths))
    out, mask = out.numpy(), mask.numpy()
    assert out.shape == ref.shape == (b, 60, N_VERTS // 3, 3)
    np.testing.assert_array_equal(mask, ref_mask)
    for i in range(b):
        n = int(mask[i].sum())
        assert n == lengths[i] * 60 // 16000
        l2 = np.linalg.norm(out[i, :n] - ref[i, :n], axis=-1).max()
        assert l2 < 1e-4, (i, l2)

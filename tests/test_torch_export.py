"""The port's outbound checkpoint export (``compat/torch_export.py`` and
``export_wav2vec2``) against the JAX package's exporter on the same weights,
for the three frame models and FaceFormer (vocaset and BIWI); reference
mirrors (``tests/torch_mirrors.py``) through the port's converters and back;
the positional conv's weight norm rebuilt by torch's own parametrization."""

import numpy as np
import pytest
import torch

from audio2face_tpu.compat.torch_export import export_state_dict as jax_export_state_dict
from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
from audio2face_tpu_torch.compat.jax_params import (
    faceformer_jax_tree_from_state_dict,
    frame_model_jax_variables_from_state_dict,
)
from audio2face_tpu_torch.compat.torch_convert import convert_state_dict, state_dict_to_numpy
from audio2face_tpu_torch.compat.torch_export import export_state_dict
from audio2face_tpu_torch.compat.wav2vec2_convert import convert_wav2vec2, export_wav2vec2
from audio2face_tpu_torch.registry import get_model
from tests import torch_mirrors

torch.set_num_threads(1)

N_VERTS = 300
ATOL = 1e-7
POS = "encoder.pos_conv_embed.conv.parametrizations.weight"
MIRRORS = {"audio2mesh": "TorchAudio2Mesh", "voca": "TorchVoca", "song2face": "TorchSong2Face"}


def _port_state_dict(name: str, seed: int) -> dict:
    """A port model's state dict with every float entry drawn from a seeded
    normal (running variances positive), so that no exported leaf is a
    trivial init value."""
    kw = {"dataset": "biwi", "period": 25} if name == "faceformer_biwi" else {}
    model = get_model(name.split("_")[0])(n_verts=N_VERTS, n_onehot=12, **kw)
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        x = torch.randn(v.shape, generator=g) * 0.1
        sd[k] = x.abs() + 0.5 if k.endswith("running_var") else x
    return sd


def _contiguous(tree):
    """A parameter tree's leaves as contiguous arrays, as JAX holds them."""
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree)


@pytest.mark.parametrize("name", ["audio2mesh", "voca", "song2face", "faceformer",
                                  "faceformer_biwi"])
def test_export_equals_jax_exporter(name):
    sd = _port_state_dict(name, seed=1)
    modelname = name.split("_")[0]
    if modelname == "faceformer":
        variables = {"params": faceformer_jax_tree_from_state_dict(sd)}
    else:
        variables = frame_model_jax_variables_from_state_dict(modelname, sd)
    variables = _contiguous(variables)
    want = jax_export_state_dict(modelname, variables)
    got = export_state_dict(modelname, sd)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0, atol=ATOL, err_msg=k)
    if name == "faceformer":  # the inert vocaset cross q/k leave as zeros
        cross = got["transformer_decoder.layers.0.multihead_attn.in_proj_weight"]
        assert not cross[:128].any() and cross[128:].any()
    if modelname in ("audio2mesh", "song2face"):
        counts = [v for k, v in got.items() if k.endswith("num_batches_tracked")]
        assert counts and all(c.dtype == np.int64 and c == 0 for c in counts)


@pytest.mark.parametrize("name", ["audio2mesh", "voca", "song2face"])
def test_reference_frame_model_converts_and_exports_back_unchanged(name):
    torch.manual_seed(0)
    mirror = getattr(torch_mirrors, MIRRORS[name])(N_VERTS, 12)
    for m in mirror.modules():  # statistics off their init values
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-1.0, 1.0)
            m.running_var.uniform_(0.5, 2.0)
    ref = state_dict_to_numpy(mirror)
    back = export_state_dict(name, convert_state_dict(name, ref))
    assert set(back) == set(ref)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # the port's model loads the converted weights strictly
    model = get_model(name)(n_verts=N_VERTS, n_onehot=12)
    model.load_state_dict(convert_state_dict(name, ref))


def _weight_norm_conv(g: np.ndarray, v: np.ndarray) -> torch.Tensor:
    """The reference's positional conv (HF wav2vec2-base: 768 channels, 16
    groups, kernel 128, weight norm over dim 2) loaded with ``g`` and ``v``;
    its effective weight."""
    conv = torch.nn.Conv1d(768, 768, kernel_size=128, padding=64, groups=16)
    conv = torch.nn.utils.parametrizations.weight_norm(conv, name="weight", dim=2)
    conv.load_state_dict({
        "bias": conv.bias.detach(),
        "parametrizations.weight.original0": torch.as_tensor(g),
        "parametrizations.weight.original1": torch.as_tensor(v),
    })
    with torch.no_grad():
        return conv.weight.detach()


@pytest.mark.parametrize("dataset", ["vocaset", "biwi"])
def test_reference_faceformer_converts_and_exports_back(dataset):
    """A mirror with the HF encoder: every tensor comes back exactly but the
    positional conv, whose weight norm is re-derived (g = ||w||, v = w) and
    rebuilds the same kernel to 1e-6; vocaset's inert cross q/k come back as
    zeros, BIWI's round-trip."""
    torch.manual_seed(3)
    mirror = torch_mirrors.TorchFaceFormer(N_VERTS, 12)
    ref = state_dict_to_numpy(mirror)
    port = convert_faceformer(ref, dataset=dataset)
    back = export_state_dict("faceformer", port)
    assert set(ref) - set(back) <= {"biased_mask", "ppe"}, set(ref) - set(back)
    assert set(back) <= set(ref)
    cross = "transformer_decoder.layers.0.multihead_attn.in_proj_"
    for k, v in back.items():
        if k.startswith(f"audio_encoder.{POS}"):
            continue
        want = ref[k]
        if dataset == "vocaset" and k.startswith(cross):
            want = want.copy()
            want[:128] = 0.0
        np.testing.assert_array_equal(v, want, err_msg=k)
    w = _weight_norm_conv(back[f"audio_encoder.{POS}.original0"],
                          back[f"audio_encoder.{POS}.original1"])
    w_ref = _weight_norm_conv(ref[f"audio_encoder.{POS}.original0"],
                              ref[f"audio_encoder.{POS}.original1"])
    torch.testing.assert_close(w, w_ref, rtol=1e-6, atol=1e-6 * float(w_ref.abs().max()))
    # and the exported dict loads into the mirror (buffers aside)
    missing, unexpected = mirror.load_state_dict(
        {k: torch.as_tensor(v) for k, v in back.items()}, strict=False)
    assert set(missing) <= {"biased_mask", "ppe"} and not unexpected


def test_positional_conv_rebuilds_to_1e6_with_zero_slices():
    """The exported g and v fold back (``convert_wav2vec2``) into the port's
    kernel to 1e-6 of each weight; an all-zero kernel position gets a unit
    direction (no 0/0) and rebuilds as zeros, as the JAX exporter does.
    torch's own weight-norm parametrization rebuilds it too, to 1e-5 of the
    largest weight: it sums ||v|| over 36,864 weights a position in f32."""
    sd = {k[len("audio_encoder."):]: v for k, v in _port_state_dict("faceformer", 2).items()
          if k.startswith("audio_encoder.")}
    w = sd["pos_conv_embed.conv.weight"].clone()
    w[:, :, 5] = 0.0
    w[:, :, 77] = 0.0
    sd["pos_conv_embed.conv.weight"] = w
    out = export_wav2vec2(sd)
    g, v = out[f"{POS}.original0"], out[f"{POS}.original1"]
    assert g.shape == (1, 1, 128) and g[0, 0, 5] == 0 and g[0, 0, 77] == 0
    assert np.isfinite(v).all() and v[0, 0, 5] == 1.0
    folded = convert_wav2vec2(out)["pos_conv_embed.conv.weight"]
    assert not folded[:, :, [5, 77]].any()
    torch.testing.assert_close(folded, w, rtol=1e-6, atol=0)
    rebuilt = _weight_norm_conv(g, v)
    assert torch.isfinite(rebuilt).all() and not rebuilt[:, :, [5, 77]].any()
    torch.testing.assert_close(rebuilt, w, rtol=0, atol=1e-5 * float(w.abs().max()))
    # the JAX exporter's g and v on the same kernel
    from audio2face_tpu.compat.wav2vec2_convert import export_wav2vec2 as jax_export_wav2vec2

    tree = _contiguous(faceformer_jax_tree_from_state_dict(
        {f"audio_encoder.{k}": x for k, x in sd.items()} | _decoder_stub())["audio_encoder"])
    want = jax_export_wav2vec2(tree)
    np.testing.assert_allclose(g, want[f"{POS}.original0"], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(v, want[f"{POS}.original1"])
    assert set(out) == set(want)


def _decoder_stub() -> dict:
    """The decoder leaves of a port FaceFormer state dict, for the tree map
    (only the encoder is read)."""
    return {k: v for k, v in _port_state_dict("faceformer", 0).items()
            if not k.startswith("audio_encoder.")}


def test_export_state_dict_names_the_models():
    with pytest.raises(KeyError, match="No exporter"):
        export_state_dict("wav2lip", {})

"""Checkpoint I/O: one reference-named Lightning ``.ckpt`` (random-init
mirrors of the reference modules from ``tests/torch_mirrors.py``, saved
with the LightningModule's ``model.`` prefix) loaded by the JAX package's
``from_torch_checkpoint`` and by the port's gives the same vertices, max
per-vertex L2 < 1e-4 (BASELINE.md's bar), for the three frame models and
for FaceFormer in vocaset and BIWI mode; the port trainer's own checkpoints
round-trip into both predictors."""

import argparse

import jax
import numpy as np
import pytest
import torch

from audio2face_tpu.compat.wav2vec2_convert import _pos_conv_kernel
from audio2face_tpu.config import ExpConfig as JaxExpConfig
from audio2face_tpu.serving import FaceFormerPredictor as JaxFaceFormerPredictor
from audio2face_tpu.serving import FramePredictor as JaxFramePredictor
from audio2face_tpu_torch.compat import torch_convert
from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
from audio2face_tpu_torch.compat.wav2vec2_convert import convert_wav2vec2, strip_prefix
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor
from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment
from tests import torch_mirrors

torch.set_num_threads(1)

N_VERTS = 300
VERTEX_L2_BAR = 1e-4
MIRRORS = {"audio2mesh": "TorchAudio2Mesh", "voca": "TorchVoca", "song2face": "TorchSong2Face"}


def _max_l2(a, b):
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b, axis=-1).max())


def _save_lightning(module, path, **extra) -> str:
    """A Lightning-style checkpoint: the LightningModule's ``model.`` prefix,
    an extractor buffer beside the model, epoch and step counters."""
    sd = {f"model.{k}": v for k, v in module.state_dict().items()}
    sd["feature_extractor.T.MelSpectrogram.spectrogram.window"] = torch.hann_window(440)
    torch.save({"state_dict": sd, "epoch": 3, "global_step": 99, **extra}, path)
    return str(path)


def _frame_cfg(modelname, cls=ExpConfig):
    base = dict(batch_size=4, modelname=modelname, vertex_count=N_VERTS, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=1e-3)
    if modelname == "voca":
        base.update(n_feature=16, out_dim=29, win_length=790)
    return cls(**base)


@pytest.mark.parametrize("modelname", ["audio2mesh", "voca", "song2face"])
def test_frame_model_reference_checkpoint_matches_jax(modelname, tmp_path):
    torch.manual_seed(0)
    mirror = getattr(torch_mirrors, MIRRORS[modelname])(N_VERTS, 12)
    with torch.no_grad():  # trained-like BatchNorm statistics
        for m in mirror.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    path = _save_lightning(mirror, tmp_path / "epoch=3-step=99.ckpt")
    kw = dict(max_batch=2, frame_batch=16, bucket_seconds=0.5)
    ref = JaxFramePredictor.from_torch_checkpoint(path, _frame_cfg(modelname, JaxExpConfig), **kw)
    port = FramePredictor.from_torch_checkpoint(path, _frame_cfg(modelname), device="cpu", **kw)
    rng = np.random.default_rng(0)
    audios = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in (7000, 12345)]
    one_hot = np.eye(12, dtype=np.float32)[[3, 8]]
    template = (rng.normal(size=(N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    for got, want in zip(port(audios, one_hot, template), ref(audios, one_hot, template)):
        assert _max_l2(got, want) < VERTEX_L2_BAR
        assert np.abs(got - template).max() > 1e-3


def test_load_torch_checkpoint_strips_the_prefix_and_reads_pickled_extras(tmp_path):
    torch.manual_seed(1)
    mirror = torch_mirrors.TorchVoca(N_VERTS, 12)
    plain = _save_lightning(mirror, tmp_path / "plain.ckpt")
    sd = torch_convert.load_torch_checkpoint(plain)
    assert "time_conv.0.weight" in sd and all(v.dtype == torch.float32 for v in sd.values())
    # hyper-parameters pickled as a Python object: the safe loader refuses
    # them, and the file is read again with weights_only=False
    extras = _save_lightning(mirror, tmp_path / "extras.ckpt",
                             hyper_parameters=argparse.Namespace(lr=1e-4))
    with pytest.warns(UserWarning, match="weights_only=False"):
        again = torch_convert.load_torch_checkpoint(extras)
    assert all(torch.equal(again[k], v) for k, v in sd.items())
    port = torch_convert.convert_state_dict("voca", sd)
    assert all(torch.equal(port[f"time_conv{i}.conv.weight"], sd[f"time_conv.{j}.weight"])
               for i, j in enumerate((0, 2, 4, 6)))
    with pytest.raises(KeyError, match="No converter"):
        torch_convert.convert_state_dict("nope", {})


def test_frame_trainer_load_torch_checkpoint_resets_adam(tmp_path):
    torch.manual_seed(2)
    mirror = torch_mirrors.TorchAudio2Mesh(N_VERTS, 12)
    path = _save_lightning(mirror, tmp_path / "a2m.ckpt")
    exp = Audio2FaceExperiment(_frame_cfg("audio2mesh"), log_dir=str(tmp_path / "run"), device="cpu")
    rng = np.random.default_rng(2)
    template = (rng.normal(size=(2, N_VERTS // 3, 3)) * 0.1).astype(np.float32)
    batch = {"audio": (rng.normal(size=(2, 11440)) * 0.1).astype(np.float32),
             "one_hot": np.eye(12, dtype=np.float32)[[1, 2]],
             "verts": template.reshape(2, -1), "template_vert": template}
    exp.train_step(batch)
    assert exp.optimizer.state
    exp.load_torch_checkpoint(path)
    want = torch_convert.convert_audio2mesh(torch_convert.load_torch_checkpoint(path))
    assert all(torch.equal(exp.model.state_dict()[k], v) for k, v in want.items())
    assert not exp.optimizer.state and exp.step == 1
    exp.train_step(batch)  # the new optimizer holds the model's parameters
    assert exp.step == 2 and len(exp.optimizer.state) == len(list(exp.model.parameters()))


@pytest.fixture(scope="module")
def hf_state_dict():
    """The reference FaceFormer mirror's HF wav2vec2 weights (numpy), with
    the newer weight-norm naming of the positional conv."""
    torch.manual_seed(3)
    mirror = torch_mirrors.TorchFaceFormer(N_VERTS, 12)
    return torch_convert.state_dict_to_numpy(mirror)


def test_positional_conv_weight_norm_namings_fold_alike(hf_state_dict):
    sd = strip_prefix(hf_state_dict, "audio_encoder.")
    base = "encoder.pos_conv_embed.conv"
    new = convert_wav2vec2(sd)["pos_conv_embed.conv.weight"]
    old_sd = {k: v for k, v in sd.items() if ".parametrizations." not in k}
    old_sd[f"{base}.weight_g"] = sd[f"{base}.parametrizations.weight.original0"]
    old_sd[f"{base}.weight_v"] = sd[f"{base}.parametrizations.weight.original1"]
    old = convert_wav2vec2(old_sd)["pos_conv_embed.conv.weight"]
    torch.testing.assert_close(old, new, rtol=0, atol=0)
    np.testing.assert_allclose(new.numpy(), _pos_conv_kernel(sd).transpose(2, 1, 0), rtol=1e-6,
                               atol=1e-7)
    plain = {k: v for k, v in old_sd.items() if not k.startswith(f"{base}.weight_")}
    plain[f"{base}.weight"] = new.numpy()
    torch.testing.assert_close(convert_wav2vec2(plain)["pos_conv_embed.conv.weight"], new)


def test_faceformer_converter_splits_in_proj(hf_state_dict):
    d = 64
    layer = "transformer_decoder.layers.0"
    for dataset in ("vocaset", "biwi"):
        port = convert_faceformer(hf_state_dict, dataset=dataset)
        w = hf_state_dict[f"{layer}.self_attn.in_proj_weight"]
        for i, name in enumerate(("dec_q", "dec_k", "dec_v")):
            np.testing.assert_array_equal(port[f"{name}.weight"].numpy(), w[i * d : (i + 1) * d])
        cw = hf_state_dict[f"{layer}.multihead_attn.in_proj_bias"]
        np.testing.assert_array_equal(port["cross_v.bias"].numpy(), cw[2 * d :])
        assert ("cross_q.weight" in port) == (dataset == "biwi")
        if dataset == "biwi":
            np.testing.assert_array_equal(port["cross_k.bias"].numpy(), cw[d : 2 * d])


@pytest.mark.parametrize("dataset", ["vocaset", "biwi"])
def test_faceformer_reference_checkpoint_matches_jax_and_round_trips(dataset, tmp_path):
    """The reference FaceFormer checkpoint through JAX and the port; then
    through the port trainer (``load_torch_checkpoint``, ``save_checkpoint``)
    into ``FaceFormerPredictor.from_checkpoint``, which detects the dataset
    and gives the same vertices."""
    biwi = dataset == "biwi"
    torch.manual_seed(4)
    mirror = torch_mirrors.TorchFaceFormer(
        N_VERTS, 12, dataset="BIWI" if biwi else "vocaset", period=25 if biwi else 60)
    path = _save_lightning(mirror, tmp_path / "ff.ckpt")
    del mirror
    kw = dict(n_verts=N_VERTS, bf16=False, max_batch=2, bucket_seconds=0.5, dataset=dataset)
    ref = JaxFaceFormerPredictor.from_torch_checkpoint(path, decode_impl="scan", **kw)
    port = FaceFormerPredictor.from_torch_checkpoint(path, device="cpu", **kw)
    rng = np.random.default_rng(5)
    audios = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in (6400, 4000)]
    one_hot = np.eye(12, dtype=np.float32)[[2, 9]]
    template = (rng.normal(size=(N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    got = port(audios, one_hot, template)
    for g, w in zip(got, ref(audios, one_hot, template)):
        assert _max_l2(g, w) < VERTEX_L2_BAR
    del ref
    jax.clear_caches()

    cfg = ExpConfig(batch_size=1, modelname="faceformer", one_hot_size=12, feature_extractor=None,
                    sample_rate=16000, vertex_count=N_VERTS, split_frame=False, n_feature=32,
                    out_dim=52, win_length=440, percision="32", dataset=dataset)
    exp = Audio2FaceExperiment(cfg, log_dir=str(tmp_path / "run"), device="cpu")
    exp.load_torch_checkpoint(path)
    saved = exp.save_checkpoint(epoch=0)
    del exp
    loaded = FaceFormerPredictor.from_checkpoint(
        saved, n_verts=N_VERTS, bf16=False, max_batch=2, bucket_seconds=0.5, device="cpu")
    assert loaded.dataset == dataset
    for a, b in zip(loaded(audios, one_hot, template), got):
        np.testing.assert_array_equal(a, b)

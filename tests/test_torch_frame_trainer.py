"""The port's trainer on the frame models (CPU, f32, tiny head) against the
JAX trainer with carried variables: one train step's loss, its gradients
leaf by leaf against ``jax.grad`` and the BatchNorm statistics it leaves;
the extractor's output detached; checkpoints that carry the BatchNorm
statistics into ``FramePredictor.from_checkpoint``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.config import ExpConfig as JaxExpConfig
from audio2face_tpu.data.vocaset import batch_audio_fragments
from audio2face_tpu.training.trainer import Audio2FaceExperiment as JaxExperiment
from audio2face_tpu_torch.compat.jax_params import (
    frame_model_jax_variables_from_state_dict,
    frame_model_state_dict_from_jax,
)
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.serving import FramePredictor
from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

torch.set_num_threads(1)

SR = 22000
N_VERTS = 300
WINDOW = 11440
# gradients per leaf: the largest |difference| over the leaf's largest
# |value| (f32, another summation order through the convs, BNs and LSTMs)
# (floored at 1e-3 of the largest leaf's largest |value|)
GRAD_LEAF_TOL, GRAD_FLOOR = 1e-4, 1e-3
ZERO_LEAF = 1e-5  # of the largest leaf: a leaf whose gradient vanishes analytically
STATS_TOL = 1e-5  # BatchNorm statistics, relative to their largest |value|


def _cfg(modelname, cls=ExpConfig, **over):
    base = dict(batch_size=4, modelname=modelname, vertex_count=N_VERTS, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=SR, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=1e-3)
    if modelname == "voca":
        base.update(n_feature=16, out_dim=29, win_length=790)
    base.update(over)
    return cls(**base)


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    template = (rng.normal(size=(b, N_VERTS // 3, 3)) * 0.1).astype(np.float32)
    return {
        "audio": (rng.normal(size=(b, WINDOW)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, b)],
        "verts": template.reshape(b, -1) + (rng.normal(size=(b, N_VERTS)) * 0.01).astype(np.float32),
        "template_vert": template,
    }


@pytest.mark.parametrize("name", ["audio2mesh", "voca", "song2face"])
def test_train_step_matches_jax_grad(name, tmp_path):
    batch = _batch(0)
    jexp = JaxExperiment(_cfg(name, JaxExpConfig), log_dir=str(tmp_path / "jax"), tensorboard=False)
    state = jexp.init_state(batch)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(params):
        pred, fmask, new_stats, verts = jexp._apply(params, state.batch_stats, jbatch, train=True)
        loss = jexp._compute_loss(pred, verts, fmask)
        return loss["loss"], (loss, new_stats)

    (_, (jloss, jstats)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)

    exp = Audio2FaceExperiment(_cfg(name), log_dir=str(tmp_path / "torch"), device="cpu")
    variables = {"params": jax.tree.map(np.asarray, state.params),
                 "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}
    exp.model.load_state_dict(frame_model_state_dict_from_jax(name, variables))
    metrics = exp.accumulate_gradients(batch)
    for key in ("loss", "rec_loss", "vel_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jloss[key]), rtol=1e-5)

    grads = {k: p.grad for k, p in exp.model.named_parameters()}
    got = frame_model_jax_variables_from_state_dict(name, grads)["params"]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    largest = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_want)
    for path, want in flat_want:
        want, keys = np.asarray(want), [k.key for k in path]
        if keys[1:] == ["conv", "bias"] and f"{keys[0]}_bn" in jgrads:
            # a conv bias before a train-mode BatchNorm: its gradient is 0
            # (the batch mean takes the shift away), so both are noise
            assert max(np.abs(flat_got[path]).max(), np.abs(want).max()) < ZERO_LEAF * largest
            continue
        diff = np.abs(flat_got[path] - want).max()
        assert diff <= GRAD_LEAF_TOL * max(np.abs(want).max(), GRAD_FLOOR * largest), (path, diff)

    if variables["batch_stats"]:
        back = frame_model_jax_variables_from_state_dict(name, exp.model.state_dict())["batch_stats"]
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        for path, want in jax.tree_util.tree_flatten_with_path(jstats)[0]:
            want = np.asarray(want)
            np.testing.assert_allclose(flat_back[path], want, rtol=0,
                                       atol=STATS_TOL * np.abs(want).max(), err_msg=str(path))


def test_checkpoint_carries_batchnorm_stats_into_the_predictor(tmp_path):
    """Two real steps, ``save_checkpoint``, then ``FramePredictor.
    from_checkpoint`` on the clip reproduces the trainer's ``predict`` on
    the host-fragmented frames (the x100 convention cannot hide in
    zero-initialized layers)."""
    cfg = _cfg("audio2mesh")
    exp = Audio2FaceExperiment(cfg, log_dir=str(tmp_path / "run"), device="cpu")
    rng = np.random.default_rng(1)
    clip = (rng.normal(size=int(0.3 * SR)) * 0.1).astype(np.float32)
    t = len(clip) * 60 // SR
    template = (rng.normal(size=(N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    batch = {
        "audio": batch_audio_fragments(clip, np.arange(t), sample_rate=SR).astype(np.float32),
        "verts": rng.normal(size=(t, N_VERTS // 3, 3)).astype(np.float32),
        "template_vert": np.broadcast_to(template, (t, N_VERTS // 3, 3)).copy(),
        "one_hot": np.broadcast_to(np.eye(12, dtype=np.float32)[3], (t, 12)).copy(),
    }
    before = exp.model.artic0_bn.bn.running_var.clone()
    for _ in range(2):
        exp.train_step(batch)
    assert not torch.equal(before, exp.model.artic0_bn.bn.running_var)
    path = exp.save_checkpoint(epoch=0)

    loaded = Audio2FaceExperiment(cfg, log_dir=str(tmp_path / "run"), device="cpu")
    loaded.load_checkpoint(path)
    for k, v in exp.model.state_dict().items():
        assert torch.equal(v, loaded.model.state_dict()[k]), k

    want, _ = exp.predict(batch)
    pred = FramePredictor.from_checkpoint(path, cfg, frame_batch=8, bucket_seconds=0.3, device="cpu")
    got = pred([clip], batch["one_hot"][:1], template)[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)
    assert np.abs(got - template[None]).max() > 1e-6


def test_wav2vec_extractor_in_the_step_gets_no_gradient(tmp_path):
    """The wav2vec2 extractor runs inside the step in eval mode and its
    output is detached: the model trains, the extractor's weights do not."""
    from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    cfg = _cfg("voca", feature_extractor="wav2vec", n_feature=16, out_dim=29)
    exp = Audio2FaceExperiment(cfg, log_dir=str(tmp_path), device="cpu")
    # the registry builds wav2vec2-base; a 1-layer encoder keeps this quick
    from audio2face_tpu_torch.models.extractor import Wav2VecExtractor

    exp.feature_extractor = Wav2VecExtractor(SR, 16, 29, config=Wav2Vec2Config(num_layers=1))
    metrics = exp.train_step(_batch(2))
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.grad is None for p in exp.feature_extractor.parameters())
    assert all(p.grad is not None for p in exp.model.parameters())

"""The port's config, registry and trainer on the CPU, at a tiny size."""

import dataclasses
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from audio2face_tpu.config import ExpConfig as JaxExpConfig
from audio2face_tpu.parallel.mesh import make_mesh
from audio2face_tpu.training.trainer import Audio2FaceExperiment as JaxExperiment
from audio2face_tpu.training.trainer import torch_adam
from audio2face_tpu_torch import registry
from audio2face_tpu_torch.compat.jax_params import (
    faceformer_jax_tree_from_state_dict,
    faceformer_state_dict_from_jax,
)
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.losses import FaceFormerLoss, VocaLoss
from audio2face_tpu_torch.models.faceformer import FaceFormer
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment, stream_seed

REFERENCE_YAML = textwrap.dedent(
    """
    batch_size: 128
    modelname: "audio2mesh"
    vertex_count: 15069 #5023 * 3
    one_hot_size: 12
    split_frame: True
    percision: "16-mixed"
    lr: 1e-4
    feature_extractor: "mfcc"
    sample_rate: 22000
    n_feature: 32
    out_dim: 52
    win_length: 440 #220*2
    """
)

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)
REQUIRED = dict(
    batch_size=1, modelname="voca", one_hot_size=12, feature_extractor="mfcc",
    sample_rate=22000, vertex_count=15069, split_frame=True, n_feature=16,
    out_dim=29, win_length=790,
)


def test_reference_yaml_roundtrip_equals_the_jax_config(tmp_path):
    p = tmp_path / "config.yaml"
    p.write_text(REFERENCE_YAML)
    cfg, ref = ExpConfig.from_yaml(str(p)), JaxExpConfig.from_yaml(str(p))
    assert dataclasses.asdict(cfg) == ref.model_dump()  # same keys, values and defaults
    assert cfg.lr == 1e-4 and cfg.hop_length is None and cfg.loss is None
    assert cfg.name() == ref.name() == "audio2mesh_mfcc_0.0001_None_16-mixed"
    assert cfg.bf16_compute and cfg.n_verts == 15069


def test_precision_alias_overrides_and_type_checks():
    cfg = ExpConfig(**REQUIRED, precision="32")
    assert cfg.percision == "32" and not cfg.bf16_compute
    assert ExpConfig.from_dict({**REQUIRED, "precision": "bf16-mixed", "unknown_key": 1}).bf16_compute
    ff = cfg.model_copy(update={"modelname": "faceformer", "batch_size": 128})
    out = ff.apply_faceformer_overrides()
    assert (out.split_frame, out.batch_size, out.feature_extractor) == (False, 1, None)
    assert cfg.apply_faceformer_overrides().feature_extractor == "mfcc"  # others untouched
    assert ExpConfig(**{**REQUIRED, "mesh_shape": [2, 1]}).mesh_shape == (2, 1)
    for bad in ({"batch_size": "many"}, {"split_frame": 1}, {"lr": "fast"}, {"modelname": None}):
        with pytest.raises(TypeError, match="ExpConfig"):
            ExpConfig(**{**REQUIRED, **bad})


def test_from_yaml_without_pyyaml_raises_a_clear_error(tmp_path, monkeypatch):
    """Without PyYAML the flat reader takes the repo's config files
    (tests/test_torch_config.py); a file it cannot read raises, naming the
    line."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = tmp_path / "config.yaml"
    path.write_text("modelname: voca\nmesh:\n  data: 2\n")
    with pytest.raises(ValueError, match="line 3: not a flat"):
        ExpConfig.from_yaml(str(path))


def test_registry():
    from audio2face_tpu_torch.models.audio2mesh import Audio2Mesh
    from audio2face_tpu_torch.models.extractor import MFCCExtractor, Wav2VecExtractor
    from audio2face_tpu_torch.models.song2face import Song2Face
    from audio2face_tpu_torch.models.voca import Voca

    assert registry.get_model("faceformer") is FaceFormer
    for name, cls in (("voca", Voca), ("audio2mesh", Audio2Mesh), ("song2face", Song2Face)):
        assert registry.get_model(name) is cls
    with pytest.raises(KeyError, match="Unknown model"):
        registry.get_model("af_model")
    assert registry.get_extractor(None)(sample_rate=16000) is None
    assert registry.get_extractor("mfcc") is MFCCExtractor
    assert registry.get_extractor("wav2vec") is Wav2VecExtractor
    with pytest.raises(KeyError, match="Unknown extractor"):
        registry.get_extractor("fbank")
    assert isinstance(registry.get_loss_fn("faceformer"), FaceFormerLoss)
    assert isinstance(registry.get_loss_fn("voca"), VocaLoss)


# ---- trainer -------------------------------------------------------------

V3 = 90  # 30 vertices
NARROW = Wav2Vec2Config(
    conv_dim=(32,) * 7, hidden_size=48, num_layers=1, num_heads=4, intermediate_size=64,
    pos_conv_kernel=16, pos_conv_groups=4,
)


def _config(**kw):
    base = dict(
        batch_size=2, modelname="faceformer", one_hot_size=12, feature_extractor=None,
        sample_rate=16000, vertex_count=V3, split_frame=False, n_feature=32, out_dim=52,
        win_length=440, percision="32", lr=1e-3, seed=3,
    )
    return ExpConfig(**{**base, **kw})


def _experiment(tmp_path=None, **kw):
    cfg_kw = {k: kw.pop(k) for k in list(kw) if k in ExpConfig._KINDS}
    return Audio2FaceExperiment(
        _config(**cfg_kw), log_dir=None if tmp_path is None else str(tmp_path), device="cpu",
        **{"model_kwargs": {"encoder_config": NARROW}, **kw})


def _batch(seed, b=2, samples=4000, padded=True):
    rng = np.random.default_rng(seed)
    t = samples * 60 // 16000
    batch = {
        "audio": (rng.normal(size=(b, samples)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, b)],
        "verts": (rng.normal(size=(b, t, V3)) * 0.01).astype(np.float32),
        "template_vert": (rng.normal(size=(b, V3 // 3, 3)) * 0.01).astype(np.float32),
    }
    if padded:
        batch["audio_lengths"] = np.asarray([samples] + [samples * 2 // 3] * (b - 1), np.int32)
    return batch


def _params(exp):
    return {k: v.detach().clone() for k, v in exp.model.state_dict().items()}


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Audio2FaceExperiment(_config(), model_kwargs={"encoder_config": NARROW})


def test_meshes_and_other_datasets_are_refused():
    # a mesh this one-process world cannot cover is refused; fsdp makes a
    # one-rank mesh (the multi-rank paths: tests/test_torch_fsdp.py)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        _experiment(mesh_shape=(2, 2))
    exp = _experiment(fsdp=True)
    assert exp.fsdp and exp.mesh is not None and not exp.tensor_parallel
    with pytest.raises(ValueError, match="unknown dataset"):
        _experiment(dataset="mead")
    # BIWI is a dataset of the faceformer family: 25 fps, period 25
    biwi = _experiment(dataset="biwi")
    assert (biwi.model.dataset, biwi.model.period, biwi.model.fps) == ("biwi", 25, 25)
    assert hasattr(biwi.model, "cross_q") and not hasattr(_experiment().model, "cross_q")
    with pytest.raises(ValueError, match="accumulate_grad_batches"):
        _experiment(accumulate_grad_batches=0)


@pytest.mark.parametrize("padded", [True, False], ids=["padded-chunked-head", "unpadded-b1"])
def test_train_steps_lower_the_loss_on_a_repeated_batch(padded):
    exp = _experiment()
    batch = _batch(0, b=2 if padded else 1, padded=padded)
    before = exp.eval_step(batch)
    first = exp.train_step(batch)
    assert set(first) == {"loss", "rec_loss", "vel_loss", "err"}
    for _ in range(5):
        metrics = exp.train_step(batch)
    after = exp.eval_step(batch)
    assert exp.step == 6 and all(torch.isfinite(v) for v in metrics.values())
    assert float(after["loss"]) < float(before["loss"])
    assert float(after["err"]) < float(before["err"])
    pred, err = exp.predict(batch)
    t = batch["verts"].shape[1]
    assert pred.shape == (batch["audio"].shape[0], t, V3 // 3, 3)
    np.testing.assert_allclose(float(err), float(after["err"]), rtol=1e-6)
    # predictions come back in data units (/100)
    assert float(pred.abs().max()) < 1.0


def test_optimizer_step_is_adam_with_coupled_weight_decay():
    exp = _experiment()
    lr, wd, b1, b2, eps = exp.lr, exp.lr / 10.0, 0.9, 0.999, 1e-8
    m = {k: torch.zeros_like(p) for k, p in exp.model.named_parameters()}
    v = {k: torch.zeros_like(p) for k, p in exp.model.named_parameters()}
    for step in (1, 2):
        exp.accumulate_gradients(_batch(step))
        want = {}
        for k, p in exp.model.named_parameters():
            g = (p.grad if p.grad is not None else torch.zeros_like(p)) + wd * p.detach()
            m[k] = b1 * m[k] + (1 - b1) * g
            v[k] = b2 * v[k] + (1 - b2) * g * g
            mhat, vhat = m[k] / (1 - b1**step), v[k] / (1 - b2**step)
            want[k] = p.detach() - lr * mhat / (vhat.sqrt() + eps)
        skipped = {k for k, p in exp.model.named_parameters() if p.grad is None}
        exp.optimizer.step()
        for k, p in exp.model.named_parameters():
            if k in skipped:  # torch's Adam leaves a parameter without a gradient alone
                continue
            np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{k} step {step}")
        assert not skipped or skipped <= {k for k in want if "layers" in k}  # LayerDrop only


def test_optimizer_step_matches_the_jax_torch_adam():
    """The JAX trainer's update rule (torch_adam: coupled decay lr/10, then
    Adam) on the port's own gradients, laid into the JAX tree through the
    inverse name map, gives the parameters the port's optimizer gives."""
    exp = _experiment(model_kwargs={"encoder_config": dataclasses.replace(NARROW, layerdrop=0.0)})
    tx = torch_adam(exp.lr, exp.lr / 10.0)

    def tree(named):
        return jax.tree.map(jnp.asarray, faceformer_jax_tree_from_state_dict(dict(named)))

    params = tree((k, p.detach()) for k, p in exp.model.named_parameters())
    opt_state = tx.init(params)
    for step in (1, 2, 3):
        exp.accumulate_gradients(_batch(step))
        assert all(p.grad is not None for p in exp.model.parameters())
        grads = tree((k, p.grad) for k, p in exp.model.named_parameters())
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        exp.optimizer.step()
        exp.step += 1
        got = tree((k, p.detach()) for k, p in exp.model.named_parameters())
        for path, want in jax.tree_util.tree_leaves_with_path(params):
            leaf = got
            for key in path:
                leaf = leaf[key.key]
            np.testing.assert_allclose(np.asarray(leaf), np.asarray(want), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{jax.tree_util.keystr(path)} step {step}")


def test_eval_step_matches_the_jax_experiment(tmp_path):
    """The same padded batch and the same weights (the JAX experiment's own
    init, motion maps randomized, carried over through the name map) through
    both experiments' eval_step and predict: x100 scaling, masked loss, err."""
    cfg_kw = dict(_config().__dict__)
    jexp = JaxExperiment(
        JaxExpConfig(**cfg_kw), mesh=make_mesh((1, 1), devices=jax.devices()[:1]),
        log_dir=str(tmp_path / "jax"), tensorboard=False)
    batch = _batch(31, samples=8000)
    state = jexp.init_state(batch)
    rng = np.random.default_rng(32)
    params = dict(jax.tree.map(np.asarray, state.params))
    for name in ("vertice_map_kernel", "vertice_map_bias", "vertice_map_r_kernel", "vertice_map_r_bias"):
        params[name] = rng.normal(0, 0.05, params[name].shape).astype(np.float32)
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    want = {k: float(v) for k, v in jexp.eval_step(state, batch).items()}
    want_pred, want_err = jexp.predict(state, batch)

    exp = Audio2FaceExperiment(_config(), log_dir=str(tmp_path / "torch"), device="cpu")
    exp.model.load_state_dict(faceformer_state_dict_from_jax(params))
    got = {k: float(v) for k, v in exp.eval_step(batch).items()}
    assert set(got) == set(want) == {"loss", "rec_loss", "vel_loss", "err"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    pred, err = exp.predict(batch)
    np.testing.assert_allclose(float(err), float(want_err), rtol=1e-4)
    valid = batch["audio_lengths"] * 60 // 16000
    for i, n in enumerate(valid):
        np.testing.assert_allclose(pred[i, :n].numpy(), np.asarray(want_pred)[i, :n], rtol=0, atol=1e-5)


def test_a_save_that_died_before_its_rename_is_no_checkpoint(tmp_path):
    exp = _experiment(tmp_path)
    ckpt_dir = tmp_path / "checkpoints"
    ckpt_dir.mkdir()
    (ckpt_dir / "periodic-epoch=0-step=9.tmp").write_bytes(b"half a file")
    assert exp._checkpoints() == []
    exp.fit(_Data(), max_epochs=0, resume=True)  # nothing to resume from: no error
    exp.step = 2
    exp.save_checkpoint(0, periodic=True, epoch_step=2)
    assert exp._checkpoints() == ["periodic-epoch=0-step=2"]
    other = _experiment(tmp_path)
    assert other.load_checkpoint() == (0, 2) and other.step == 2


def test_accumulation_equals_the_mean_of_the_microbatch_gradients():
    k = 2
    exp = _experiment(accumulate_grad_batches=k)
    batch = _batch(7, b=4)
    metrics = exp.accumulate_gradients(batch)
    got = {n: p.grad.clone() for n, p in exp.model.named_parameters() if p.grad is not None}

    # the same microbatches, one at a time, with the streams (seed, step, i)
    want, losses = {}, []
    dev = exp._to_device(batch)
    for i in range(k):
        exp.model.zero_grad(set_to_none=True)
        mb = {key: v[2 * i : 2 * i + 2] for key, v in dev.items()}
        gen = torch.Generator().manual_seed(stream_seed(exp.config.seed, exp.step, i))
        loss, _ = exp._train_loss(mb, gen)
        loss["loss"].backward()
        losses.append(float(loss["loss"].detach()))
        for n, p in exp.model.named_parameters():
            if p.grad is not None:
                want[n] = want.get(n, 0) + p.grad / k
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want[n].abs().max()) + 1e-12, err_msg=n)
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)
    # one update for the k microbatches
    exp.train_step(batch)
    assert exp.step == 1
    with pytest.raises(ValueError, match="microbatches"):
        exp.accumulate_gradients(_batch(7, b=3))


class _Interrupted(Exception):
    pass


class _Data:
    """Three train batches an epoch in a shuffled order, one val batch."""

    def __init__(self, fail_at_step=None):
        self.train = [_batch(10 + i) for i in range(3)]
        self.val = [_batch(20)]
        self.fail_at_step = fail_at_step
        self.served = 0
        self.orders = []

    def train_batches(self, np_rng):
        order = np_rng.permutation(len(self.train))
        self.orders.append(order.tolist())
        for i in order:
            if self.fail_at_step is not None and self.served == self.fail_at_step:
                raise _Interrupted
            self.served += 1
            yield self.train[i]

    def val_batches(self):
        return iter(self.val)


def test_fit_logs_picks_the_best_epoch_and_stops_early(tmp_path):
    exp = _experiment(tmp_path, max_epochs=3)
    best_state, result = exp.fit(_Data(), log_every=1)
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    epoch_rows = [r for r in rows if "val/err" in r]
    assert len(epoch_rows) == result.epochs_run == 3 and len(rows) == 3 * 3 + 3
    assert all(r["steps"] == 3 for r in epoch_rows)
    vals = [r["val/err"] for r in epoch_rows]
    assert result.best_epoch == int(np.argmin(vals)) and result.best_val_err == min(vals)
    assert best_state["step"] == 3 * (result.best_epoch + 1)
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert f"epoch={result.best_epoch}-step={best_state['step']}" in ckpts

    # lr 0 (and with it no weight decay): the val err never improves after
    # epoch 0, so patience 2 stops after epoch 2
    still = _experiment(tmp_path / "still", lr=0.0, max_epochs=10, early_stop_patience=2)
    _, stopped = still.fit(_Data(), checkpoint=False)
    assert stopped.epochs_run == 3 and stopped.best_epoch == 0
    assert not (tmp_path / "still" / "checkpoints").exists()


def test_resume_replays_an_uninterrupted_run_bitwise(tmp_path):
    full = _experiment(tmp_path / "full", max_epochs=2)
    data = _Data()
    full.fit(data, checkpoint_every_steps=1)
    assert full.step == 6
    # periodic saves keep the newest two
    periodic = [c for c in os.listdir(tmp_path / "full" / "checkpoints") if c.startswith("periodic-")]
    assert sorted(periodic) == ["periodic-epoch=1-step=5", "periodic-epoch=1-step=6"]

    # the same run, cut after 4 steps (one step into epoch 1), then resumed
    cut = _experiment(tmp_path / "cut", max_epochs=2)
    with pytest.raises(_Interrupted):
        cut.fit(_Data(fail_at_step=4), checkpoint_every_steps=2)
    assert cut.step == 4
    resumed = _experiment(tmp_path / "cut", max_epochs=2)
    data2 = _Data()
    resumed.fit(data2, resume=True, checkpoint_every_steps=2)
    assert resumed.step == 6
    # epoch 1's shuffle replayed; its first batch drawn and skipped, two trained
    assert data2.orders == [data.orders[1]] and data2.served == 3
    want, got = _params(full), _params(resumed)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    opt_w, opt_g = full.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in opt_w:
        assert torch.equal(opt_w[i]["exp_avg_sq"], opt_g[i]["exp_avg_sq"])

    # an end-of-epoch checkpoint resumes with the next epoch
    again = _experiment(tmp_path / "full", max_epochs=3)
    epoch, epoch_step = again.load_checkpoint(str(tmp_path / "full" / "checkpoints" / "epoch=0-step=3"))
    assert (epoch, epoch_step, again.step) == (0, None, 3)

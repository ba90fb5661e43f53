"""The port's host runtime: the native loader's build (and a failed build
raising), native against its numpy reference and against the JAX package's
runtime bit for bit, the ``Prefetcher``'s order, errors, depth, trees and
``cpu`` device, and the trainer's ``fit`` through the prefetcher giving the
metrics of direct iteration."""

import dataclasses

import numpy as np
import pytest
import torch

from audio2face_tpu.runtime import fragment_batch_i16 as jax_fragment_batch_i16
from audio2face_tpu.runtime import gather_rows_f32 as jax_gather_rows_f32
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.data.synthetic import generate_synthetic_vocaset
from audio2face_tpu_torch.data.vocaset import VocaDataModule
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from audio2face_tpu_torch.runtime import (
    Prefetcher,
    build_native,
    fragment_batch_i16,
    fragment_batch_i16_reference,
    gather_rows_f32,
    gather_rows_f32_reference,
)
from audio2face_tpu_torch.runtime import hostloader
from audio2face_tpu_torch.training import trainer as trainer_module
from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

torch.set_num_threads(1)


def test_native_library_builds_under_its_digest():
    path = build_native()
    assert path.exists() and path == hostloader.library_path()
    assert path.parent == hostloader.BUILD_DIR and path.name.startswith("libhostloader_")


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "hostloader.cpp"
    broken.write_text('extern "C" int a2f_runtime_version() { return }\n')
    monkeypatch.setattr(hostloader, "SRC", broken)
    monkeypatch.setattr(hostloader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(hostloader, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        fragment_batch_i16(np.zeros(10, np.int16), np.zeros(1, np.int64), 4)
    monkeypatch.setattr(hostloader.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build_native()


@pytest.mark.parametrize("window", [11440, 7])
def test_fragment_native_equals_reference_and_jax(window):
    rng = np.random.default_rng(0)
    audio = rng.integers(-32768, 32767, 50000).astype(np.int16)
    starts = np.asarray([-5720, -window - 3, 0, 1000, 44000, 49999, 60000], np.int64)
    got = fragment_batch_i16(audio, starts, window)
    np.testing.assert_array_equal(got, fragment_batch_i16_reference(audio, starts, window))
    np.testing.assert_array_equal(got, jax_fragment_batch_i16(audio, starts, window))
    np.testing.assert_array_equal(fragment_batch_i16(audio, starts, window, n_threads=1), got)
    with pytest.raises(ValueError, match="1-D"):
        fragment_batch_i16(audio.reshape(2, -1), starts, window)


def test_gather_rows_native_equals_reference_and_jax():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(100, 7, 3)).astype(np.float32)
    idx = np.asarray([3, 99, 0, 3], np.int64)
    got = gather_rows_f32(src, idx)
    np.testing.assert_array_equal(got, gather_rows_f32_reference(src, idx))
    np.testing.assert_array_equal(got, jax_gather_rows_f32(src, idx))
    # a non-f32 or strided source is converted first
    np.testing.assert_array_equal(gather_rows_f32(src.astype(np.float64), idx), src[idx])
    np.testing.assert_array_equal(gather_rows_f32(src[:, ::2], idx), src[idx][:, ::2])
    for bad in ([100], [-1]):
        with pytest.raises(IndexError):
            gather_rows_f32(src, np.asarray(bad))


def test_prefetcher_order_transform_and_errors():
    items = list(range(20))
    assert list(Prefetcher(iter(items), transform=lambda x: x * 2)) == [x * 2 for x in items]
    assert list(Prefetcher(iter(items), depth=1)) == items

    def bad():
        yield 1
        raise RuntimeError("boom")

    p = Prefetcher(bad())
    assert next(p) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(items), depth=0)


def test_prefetcher_cpu_device_hands_over_tensors_and_closes():
    rng = np.random.default_rng(1)
    batches = [{"audio": rng.normal(size=(2, 5)).astype(np.float32),
                "pair": (np.arange(3), torch.ones(2)), "name": "x"} for _ in range(5)]
    got = list(Prefetcher(iter(batches), device="cpu"))
    assert len(got) == 5 and got[0]["name"] == "x"
    for g, b in zip(got, batches):
        assert isinstance(g["audio"], torch.Tensor) and g["audio"].device.type == "cpu"
        np.testing.assert_array_equal(g["audio"].numpy(), b["audio"])
        assert isinstance(g["pair"], tuple) and torch.equal(g["pair"][0], torch.arange(3))
    p = Prefetcher(iter(range(10**6)), depth=2)
    assert next(p) == 0
    p.close()
    assert not p._thread.is_alive()
    with pytest.raises(StopIteration):
        next(p)


NARROW = Wav2Vec2Config(
    conv_dim=(32,) * 7, hidden_size=48, num_layers=1, num_heads=4, intermediate_size=64,
    pos_conv_kernel=16, pos_conv_groups=4,
)


def test_fit_through_the_prefetcher_equals_direct_iteration(tmp_path, monkeypatch):
    """One epoch of ``fit`` (batches through the Prefetcher) gives the train
    and val metrics of a loop that feeds the same batches directly."""
    data = generate_synthetic_vocaset(str(tmp_path / "data"), n_verts=30, sentences_per_subject=1,
                                      seconds_per_sentence=0.5)
    cfg = ExpConfig(batch_size=4, modelname="faceformer", one_hot_size=12, feature_extractor=None,
                    sample_rate=16000, vertex_count=90, split_frame=False, n_feature=32,
                    out_dim=52, win_length=440, percision="32", lr=1e-3, seed=3)
    kw = dict(device="cpu", model_kwargs={"encoder_config": dataclasses.replace(NARROW, layerdrop=0.0)})
    dm = VocaDataModule(data, batch_size=4, split_frame=False)
    dm.setup()

    made = []

    class Recorded(Prefetcher):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(trainer_module, "Prefetcher", Recorded)
    exp = Audio2FaceExperiment(cfg, log_dir=str(tmp_path / "fit"), **kw)
    _, result = exp.fit(dm, max_epochs=1, checkpoint=False)
    assert len(made) == 1 and made[0].device == torch.device("cpu")
    assert made[0].uploads == []  # CPU: no copies

    ref = Audio2FaceExperiment(cfg, log_dir=str(tmp_path / "ref"), **kw)
    errs = [ref.train_step(b)["err"] for b in dm.train_batches(np.random.default_rng([cfg.seed, 0]))]
    val = [ref.eval_step(b)["err"] for b in dm.val_batches()]
    assert result.history[0]["steps"] == len(errs) == 4
    assert result.history[0]["train/err"] == float(torch.stack(errs).mean())
    assert result.history[0]["val/err"] == float(torch.stack(val).mean())
    for (name, a), b in zip(exp.model.state_dict().items(), ref.model.state_dict().values()):
        assert torch.equal(a, b), name

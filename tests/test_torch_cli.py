"""The port's command lines on the CPU, driven through ``main(argv)`` with
``--device cpu``, in the shape of tests/test_entrypoints.py and
tests/test_compat.py: ``train`` on the 523-vertex Audio2Mesh config (the
repo's ``configs/audio2mesh.yaml`` with its head narrowed) and a miniature
synthetic VOCASET, then the ``evaluate`` sweep and diff (held to the JAX
package's metrics), ``export`` (read back by the port's and the JAX
package's converters) and ``serve`` in a subprocess (a POST and a live
session against direct calls); the trainer's tensorboard scalars and
profiler trace. Each test runs under a deadline of its own."""

import contextlib
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from audio2face_tpu import evaluation as jax_eval
from audio2face_tpu.compat.torch_convert import convert_state_dict as jax_convert_state_dict
from audio2face_tpu.compat.torch_convert import load_torch_checkpoint as jax_load_torch_checkpoint
from audio2face_tpu_torch.compat.jax_params import frame_model_jax_variables_from_state_dict
from audio2face_tpu_torch.compat.torch_convert import convert_state_dict, load_torch_checkpoint
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj, generate_synthetic_vocaset
from audio2face_tpu_torch.data.vocaset import VocaDataModule

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VERTS = 523
DEADLINE_S = 60
SUBJECT, SENTENCE = "FaceTalk_170809_00138_TA", "sentence01"  # in the test split


@contextlib.contextmanager
def deadline(seconds: int = DEADLINE_S):
    """Fail the enclosed block once it has run ``seconds``."""
    def fail(signum, frame):
        raise TimeoutError(f"over the {seconds} s deadline")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _run(main, argv) -> str:
    """``main(argv)`` in this process; its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``cli.train`` once, one epoch, in a directory of its own."""
    from audio2face_tpu_torch.cli import train

    root = tmp_path_factory.mktemp("cli")
    cfg = root / "audio2mesh.yaml"
    with open(os.path.join(REPO, "configs", "audio2mesh.yaml")) as f:
        cfg.write_text(f.read().replace("15069", str(3 * N_VERTS)))
    data = generate_synthetic_vocaset(str(root / "vocaset"), n_verts=N_VERTS,
                                      sentences_per_subject=1, seconds_per_sentence=0.6)
    template = generate_synthetic_face_obj(str(root / "template.obj"), n_verts=N_VERTS)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        with deadline():
            stdout = _run(train.main, [
                "--config", str(cfg), "--dataset-path", data, "--max-epochs", "1",
                "--predict-subject", SUBJECT, "--predict-sentence", SENTENCE,
                "--skip-render", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    config = ExpConfig.from_yaml(str(cfg))
    log_dir = root / "logs" / config.name()
    ckpts = sorted(os.listdir(log_dir / "checkpoints"), key=lambda x: int(x.split("=")[-1]))
    return {"root": root, "cfg": str(cfg), "config": config, "data": data, "template": template,
            "log_dir": log_dir, "ckpt": str(log_dir / "checkpoints" / ckpts[-1]), "stdout": stdout}


def _sentence(run):
    """The predicted sentence's ground truth (T, V, 3) and template (V, 3)."""
    dm = VocaDataModule(run["data"], batch_size=128, split_frame=True)
    dm.setup()
    batch = dm.predict_batch(SUBJECT, SENTENCE)
    gt = np.asarray(batch["verts"], np.float32).reshape(-1, N_VERTS, 3)
    return gt, np.asarray(batch["template_vert"], np.float32).reshape(-1, N_VERTS, 3)[0], dm


def test_train_fits_saves_and_scores_the_prediction(run):
    rows = [json.loads(r) for r in (run["log_dir"] / "metrics.jsonl").read_text().splitlines()]
    epoch = [r for r in rows if "val/err" in r]
    assert len(epoch) == 1 and epoch[0]["steps"] > 0 and np.isfinite(epoch[0]["val/err"])
    assert os.path.basename(run["ckpt"]) == f"epoch=0-step={epoch[0]['steps']}"
    pred = np.load(run["log_dir"] / "pred_verts.npy")
    gt, template, _ = _sentence(run)
    assert pred.shape == gt.shape and pred.shape[1:] == (N_VERTS, 3) and np.isfinite(pred).all()
    lines = run["stdout"].splitlines()
    assert any(line.startswith("Best val/err") for line in lines)
    rec = [float(line.split(": ")[1]) for line in lines if line.startswith("predict_rec_loss: ")]
    assert len(rec) == 1 and np.isfinite(rec[0])
    printed = [line for line in lines if line.startswith("predict metrics: ")]
    assert len(printed) == 1
    got = dict(kv.split("=") for kv in printed[0][len("predict metrics: "):].split())
    want = jax_eval.evaluate_animation(pred, gt, template)
    assert set(got) == set(want)
    for k, v in want.items():  # printed to 6 significant digits
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, atol=1e-12, err_msg=k)


def test_evaluate_sweep_equals_the_experiments_evaluate(run):
    from audio2face_tpu_torch.cli import evaluate
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    with deadline():
        stdout = _run(evaluate.main, [
            "--config", run["cfg"], "--dataset-path", run["data"], "--log-dir", str(run["log_dir"]),
            "--max-sentences", "2", "--device", "cpu"])
        got = json.loads(stdout.strip().splitlines()[-1])["metrics"]
        exp = Audio2FaceExperiment(run["config"], log_dir=str(run["log_dir"]), device="cpu")
        exp.load_checkpoint(run["ckpt"])
        dm = VocaDataModule(run["data"], batch_size=128, split_frame=True)
        dm.setup()
        want = exp.evaluate(dm, max_sentences=2)
    assert got["n_sentences"] == want["n_sentences"] == 2
    for k in ("lve", "fdd", "mve", "max_l2", "err"):
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert "n_sentences: 2" in stdout


def test_evaluate_diff_matches_jax_and_checks_its_modes(run, tmp_path):
    from audio2face_tpu_torch.cli import evaluate
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    gt, _, _ = _sentence(run)
    pred = np.load(run["log_dir"] / "pred_verts.npy")
    np.save(tmp_path / "gt.npy", gt)
    np.save(tmp_path / "short.npy", pred[:-3])
    lip, upper = np.arange(0, 40), np.arange(300, 523)
    np.save(tmp_path / "lip.npy", lip)
    np.save(tmp_path / "upper.npy", upper)
    mesh_t = np.asarray(FaceMesh.load(run["template"]).verts, np.float32)
    base = ["--gt", str(tmp_path / "gt.npy"), "--device", "cpu"]
    with deadline():
        out = _run(evaluate.main, ["--pred", str(run["log_dir"] / "pred_verts.npy"),
                                   "--template", run["template"], *base])
        got = json.loads(out.strip().splitlines()[-1])["metrics"]
        want = jax_eval.evaluate_animation(pred, gt, mesh_t)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert got["n_frames"] == len(gt)

        # fewer predicted frames: the first n compared; gt frame 0 as the
        # neutral pose without --template; given region masks
        out = _run(evaluate.main, ["--pred", str(tmp_path / "short.npy"), *base,
                                   "--lip-mask", str(tmp_path / "lip.npy"),
                                   "--upper-mask", str(tmp_path / "upper.npy")])
        assert "comparing the first" in out and "gt frame 0" in out
        got = json.loads(out.strip().splitlines()[-1])["metrics"]
        n = len(pred) - 3
        want = jax_eval.evaluate_animation(pred[:n], gt[:n], gt[0],
                                           regions=jax_eval.VertexRegions(lip=lip, upper=upper))
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert got["n_frames"] == n

    for argv in (["--pred", "x.npy"], ["--pred", "x.npy", "--gt", "y.npy", "--config", "c.yaml"], [],
                 ["--pred", str(tmp_path / "short.npy"), *base, "--lip-mask", "lip.npy"]):
        with pytest.raises(SystemExit):
            _run(evaluate.main, argv)


def test_export_loads_back_into_the_port_and_the_jax_package(run, tmp_path):
    from audio2face_tpu_torch.cli import export

    out = tmp_path / "out" / "audio2mesh.ckpt"
    cwd = os.getcwd()
    os.chdir(run["root"])  # the default checkpoint: the newest under logs/<config name>
    try:
        with deadline():
            stdout = _run(export.main, ["--config", run["cfg"], "--out", str(out)])
    finally:
        os.chdir(cwd)
    saved = torch.load(run["ckpt"], map_location="cpu", weights_only=True)
    raw = torch.load(str(out), map_location="cpu", weights_only=True)
    assert raw["global_step"] == saved["step"] and raw["epoch"] == saved["epoch"] == 0
    assert all(k.startswith("model.") for k in raw["state_dict"])
    assert stdout.startswith(f"exported audio2mesh step {saved['step']} (")
    assert stdout.rstrip().endswith(f"-> {out}")

    back = convert_state_dict("audio2mesh", load_torch_checkpoint(str(out)))
    assert set(back) == set(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(back[k], v), k
    # the JAX package's loader reads the same tensors
    jax_vars = jax_convert_state_dict("audio2mesh", jax_load_torch_checkpoint(str(out)))
    want = frame_model_jax_variables_from_state_dict("audio2mesh", saved["model"])
    for col in ("params", "batch_stats"):
        flat_got = dict(_flatten(jax_vars[col]))
        flat_want = dict(_flatten(want[col]))
        assert set(flat_got) == set(flat_want), col
        for k, v in flat_want.items():
            np.testing.assert_array_equal(np.asarray(flat_got[k]), v, err_msg=k)


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_answers_like_direct_calls(run, tmp_path):
    """``cli.serve`` as users start it, on the trained checkpoint with a live
    port: one POST equals a direct ``FramePredictor`` call, one live session
    a direct ``FrameStreamPool`` stream; then the process is terminated."""
    from audio2face_tpu_torch.frame_stream import FrameStreamPool
    from audio2face_tpu_torch.http_server import decode_audio_body
    from audio2face_tpu_torch.live_server import LiveClient
    from audio2face_tpu_torch.serving import FramePredictor
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    port, live_port = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "audio2face_tpu_torch.cli.serve", "--template", run["template"],
         "--config", run["cfg"], "--checkpoint", run["ckpt"], "--port", str(port),
         "--live-port", str(live_port), "--live-streams", "2", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        with deadline():
            health = None
            while health is None:
                assert proc.poll() is None, (tmp_path / "serve.log").read_text()
                try:
                    c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                    c.request("GET", "/healthz")
                    health = json.loads(c.getresponse().read())
                    c.close()
                except OSError:
                    time.sleep(0.2)
            assert health["backend"] == "cpu"
            rng = np.random.default_rng(7)
            sr = run["config"].sample_rate
            clip = (rng.normal(size=sr) * 0.1).astype(np.float32)
            buf = io.BytesIO()
            wavfile.write(buf, sr, (clip * 32767).astype(np.int16))
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            c.request("POST", "/v1/infer?subject=3", body=buf.getvalue(),
                      headers={"Content-Type": "audio/wav"})
            r = c.getresponse()
            assert r.status == 200
            got = np.load(io.BytesIO(r.read()))
            c.request("GET", "/stats")
            stats = json.loads(c.getresponse().read())
            c.close()

            template = np.asarray(FaceMesh.load(run["template"]).verts, np.float32)
            one_hot = np.eye(12, dtype=np.float32)[[3]]
            direct = FramePredictor.from_checkpoint(run["ckpt"], run["config"], device="cpu")
            wav, wsr = decode_audio_body(buf.getvalue(), "audio/wav", None)
            want = direct([wav], one_hot, template, sample_rate=wsr)[0]
            assert got.shape == want.shape == (60, N_VERTS, 3)
            assert float(np.linalg.norm(got - want, axis=-1).max()) < 1e-5
            assert stats["ok"] == 1 and "live" in stats

            with LiveClient(live_port, subject=3, sample_rate=sr, timeout=30.0) as lc:
                parts = [lc.send(clip[off : off + sr // 10]) for off in range(0, sr, sr // 10)]
                live = np.concatenate(parts + [lc.finish()])
            pool = FrameStreamPool(run["config"], state_dict=direct.model.state_dict(),
                                   n_streams=1, device="cpu")
            slot = pool.open_stream(one_hot[0], template)
            solo = np.concatenate([pool.push(slot, clip[off : off + sr // 10],
                                             last=off + sr // 10 >= sr)
                                   for off in range(0, sr, sr // 10)] + [pool.poll(slot)])
            assert live.shape == solo.shape == (60, N_VERTS, 3)
            assert float(np.linalg.norm(live - solo, axis=-1).max()) < 1e-5
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert proc.poll() is not None


def test_clis_refuse_the_cpu_fallback(run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from audio2face_tpu_torch.cli import evaluate, serve

    gt, _, _ = _sentence(run)
    path = str(run["root"] / "gt_refuse.npy")
    np.save(path, gt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(evaluate.main, ["--pred", path, "--gt", path])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(evaluate.main, ["--config", run["cfg"], "--dataset-path", run["data"],
                             "--log-dir", str(run["log_dir"])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(serve.main, ["--template", run["template"], "--config", run["cfg"]])


# ---------------------------------------------------------------------------
# the trainer's tensorboard and profiler hooks
# ---------------------------------------------------------------------------


class _FrameData:
    """``n`` training batches of 4 frames an epoch, one validation batch."""

    def __init__(self, n: int):
        self.train = [self._batch(10 + i) for i in range(n)]
        self.val = [self._batch(99)]

    @staticmethod
    def _batch(seed):
        rng = np.random.default_rng(seed)
        template = (rng.normal(size=(4, 10, 3)) * 0.1).astype(np.float32)
        return {
            "audio": (rng.normal(size=(4, 11440)) * 0.1).astype(np.float32),
            "one_hot": np.eye(12, dtype=np.float32)[rng.integers(0, 12, 4)],
            "verts": template.reshape(4, -1) + (rng.normal(size=(4, 30)) * 0.01).astype(np.float32),
            "template_vert": template,
        }

    def train_batches(self, np_rng):
        return iter(self.train)

    def val_batches(self):
        return iter(self.val)


def _frame_experiment(log_dir, **kw):
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    cfg = ExpConfig(batch_size=4, modelname="voca", vertex_count=30, one_hot_size=12,
                    feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=16,
                    out_dim=29, win_length=790, percision="32", lr=1e-3)
    return Audio2FaceExperiment(cfg, log_dir=str(log_dir), device="cpu", **kw)


def _train_ranges(path) -> int:
    """The ``train`` ranges in a Chrome trace: one a profiled step."""
    events = json.loads(open(path).read())["traceEvents"]
    return sum(e.get("name") == "train" and e.get("ph") == "X" for e in events)


def test_fit_writes_tensorboard_scalars_and_profiles_an_epoch(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    with deadline():
        exp = _frame_experiment(tmp_path / "run")
        exp.fit(_FrameData(7), max_epochs=2, log_every=2, checkpoint=False, profile_epoch=1)
        acc = EventAccumulator(str(tmp_path / "run"))
        acc.Reload()
        tags = set(acc.Tags()["scalars"])
        assert {"train/err", "val/err", "train_step/loss", "train_step/err"} <= tags
        assert [e.step for e in acc.Scalars("val/err")] == [0, 1]
        assert [e.step for e in acc.Scalars("train_step/loss")] == [2, 4, 6, 9, 11, 13]
        rows = [json.loads(r) for r in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
        val = [r["val/err"] for r in rows if "val/err" in r]
        np.testing.assert_allclose([e.value for e in acc.Scalars("val/err")], val, rtol=1e-6)
        # epoch 1 profiled: its first 5 of 7 steps, each a "train" range
        assert not (tmp_path / "run" / "trace-epoch=0.json").exists()
        assert _train_ranges(tmp_path / "run" / "trace-epoch=1.json") == 5

        # an epoch shorter than 5 steps is profiled to its end
        short = _frame_experiment(tmp_path / "short")
        short.fit(_FrameData(3), max_epochs=1, checkpoint=False, profile_epoch=0)
        assert _train_ranges(tmp_path / "short" / "trace-epoch=0.json") == 3


def test_fit_without_the_tensorboard_package_writes_no_events(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    with deadline():
        exp = _frame_experiment(tmp_path / "run")
        exp.fit(_FrameData(2), max_epochs=1, log_every=1, checkpoint=False)
        off = _frame_experiment(tmp_path / "off", tensorboard=False)
        off.fit(_FrameData(2), max_epochs=1, log_every=1, checkpoint=False)
    for d in ("run", "off"):
        files = os.listdir(tmp_path / d)
        assert "metrics.jsonl" in files and not any(f.startswith("events.") for f in files), files
    assert exp.tensorboard is False and exp._tb is None

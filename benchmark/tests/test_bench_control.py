"""The output check's control and faults.

- The control, the plain reference at the precision below the
  configuration's (fp8 operands for bf16), put in the program's place,
  fails each cell's limit: here at a small size on the CPU, and on the card
  at the cell's own size (``cuda`` fixture).
- A whole run with the timed path broken underneath reads ``correct``
  false, once for each fault a cell can have: answers altered where they
  are produced, half of a batch's answers left out, a decoder step that
  returns its state unchanged. (No cell spans chips, so none can leave
  out an exchange between chips.) The same runs unbroken read true.
- The check recomputes every clip of the requests it samples.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.drivers.common import audio_bank
from benchmark.reference.common import fp8_e4m3
from benchmark.tests.conftest import BENCH, SMALL_VERTS, config, config_module, small_cell

SMALL_OFFLINE = dict(clips_per_request=3, length_median_s=1.2, length_sigma=0.3,
                     length_max_s=2.0, check_requests=1)
BENCH_JSON = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def limit(cell: str) -> float:
    return json.loads((BENCH / "workloads" / f"{cell}.json").read_text())["limits"]["vertex_err"]


def rel_gap(got: torch.Tensor, want: torch.Tensor, template: np.ndarray) -> float:
    tm = torch.as_tensor(template)
    motion = (want - tm).norm(dim=-1).square().mean().sqrt()
    return float((got - want).norm(dim=-1).max() / motion)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_inputs(sr: int, n: int):
    bank = audio_bank(4, 6.0, sr)
    audios = [bank[2000 * i : 2000 * i + int(1.5 * sr) + 100 * i] for i in range(n)]
    one_hot = np.eye(12, dtype=np.float32)[[3, 8, 1][:n]]
    template = (0.05 * np.random.default_rng(1).standard_normal((SMALL_VERTS // 3, 3))
                ).astype(np.float32)
    return audios, one_hot, template


@pytest.mark.parametrize("name,cell", [
    ("faceformer_vocaset", "faceformer_vocaset.offline_mixed"),
    ("audio2mesh_mfcc", "audio2mesh_mfcc.offline_mixed"),
])
def test_fp8_control_fails_the_limit(name, cell):
    cfg = config(name, vertice_dim=SMALL_VERTS)
    mod = config_module(name)
    w = mod.weights(cfg, 21, "cpu")
    audios, one_hot, template = small_inputs(cfg["sample_rate"], 2)
    want = mod.reference(cfg, w, audios, one_hot, [template] * 2, "cpu")
    ctrl = mod.reference(cfg, w, audios, one_hot, [template] * 2, "cpu", fp8_e4m3)
    assert max(rel_gap(c, r, template) for c, r in zip(ctrl, want)) > limit(cell)


def offline_cell(**kw):
    return small_cell("faceformer_vocaset", "offline_mixed", "offline",
                      limits={"vertex_err": limit("faceformer_vocaset.offline_mixed")},
                      **SMALL_OFFLINE, **kw)


def frame_cell():
    return small_cell("audio2mesh_mfcc", "offline_mixed", "offline",
                      limits={"vertex_err": limit("audio2mesh_mfcc.offline_mixed")},
                      **SMALL_OFFLINE)


@pytest.fixture
def e2e(monkeypatch):
    """Small cells report whatever end-to-end metric their driver made."""
    monkeypatch.setattr(run, "cell_metrics", lambda bench, cell, trace: [])


@pytest.mark.parametrize("make", [offline_cell, frame_cell])
def test_sound_runs_are_correct(make, e2e):
    out = run.run_cell(make(), 2.0, False, BENCH_JSON)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def alter_vertex_chunk(monkeypatch):
    """Answers altered where they are produced: the vertex head's output
    one part in five larger."""
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    real = FaceFormerPredictor._vertex_chunk

    def altered(self, hs, template):
        return real(self, hs, template) * 1.2

    monkeypatch.setattr(FaceFormerPredictor, "_vertex_chunk", altered)


def test_altered_answers_are_not_correct(monkeypatch, e2e):
    alter_vertex_chunk(monkeypatch)
    out = run.run_cell(offline_cell(), 2.0, False, BENCH_JSON)
    assert not out["correct"]


def test_altered_frame_answers_are_not_correct(monkeypatch, e2e):
    from audio2face_tpu_torch.serving import FramePredictor

    real = FramePredictor.forward_chunk

    def altered(self, *args):
        return real(self, *args) * 1.2

    monkeypatch.setattr(FramePredictor, "forward_chunk", altered)
    assert not run.run_cell(frame_cell(), 2.0, False, BENCH_JSON)["correct"]


def test_half_a_batch_left_out_is_not_correct(monkeypatch, e2e):
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    real = FaceFormerPredictor.__call__

    def half(self, audios, one_hot, template, *args, **kwargs):
        keep = max(1, len(audios) // 2)
        return real(self, audios[:keep], one_hot[:keep], template, *args, **kwargs)

    monkeypatch.setattr(FaceFormerPredictor, "__call__", half)
    out = run.run_cell(offline_cell(), 2.0, False, BENCH_JSON)
    assert not out["correct"] and out["failed"] > 0


def test_a_decoder_step_that_keeps_its_state_is_not_correct(monkeypatch, e2e):
    """Every decode step starts from the first step's state: the style as
    its embedding, an empty cache, frame 0."""
    from audio2face_tpu_torch.ops import decode_kernel

    real = decode_kernel.decode_loop_reference

    def frozen(cross, style, pe, weights, *, period=60, **kwargs):
        b, t, d = cross.shape
        hs = real(cross.reshape(b * t, 1, d), style.repeat_interleave(t, dim=0), pe, weights,
                  period=period)
        return hs.reshape(b, t, d)

    monkeypatch.setattr(decode_kernel, "decode_loop_reference", frozen)
    assert not run.run_cell(offline_cell(), 2.0, False, BENCH_JSON)["correct"]


def test_every_seed_sends_the_catalog_in_its_own_order():
    """The requests differ in lengths and buckets, and every seed sends the
    same ones, so seeds differ in order and audio, not in work."""
    import math

    from benchmark.drivers.offline import Requests
    from benchmark.tests.conftest import traffic

    cfg, tr = config("faceformer_vocaset", vertice_dim=SMALL_VERTS), traffic("offline_mixed")
    n = tr["catalog_requests"]

    def cycle(seed):
        reqs = Requests(cfg, tr, seed)
        return [reqs.get(r)["lengths"] for r in range(n)]

    a, b = cycle(2**31 + 11), cycle(7)
    assert sorted(map(sorted, map(list, a))) == sorted(map(sorted, map(list, b)))
    assert [list(x) for x in a] != [list(x) for x in b]
    # each request's two groups of 8, in 5 s buckets: many pairs, up to 60 s
    buckets = {tuple(math.ceil(x / (5 * 16000)) for x in sorted(lengths)[7::8]) for lengths in a}
    longest = {long for _, long in buckets}
    assert len(buckets) >= 8 and min(longest) <= 5 and max(longest) == 12


def test_the_check_recomputes_whole_requests():
    from benchmark.control import offline_sample
    from benchmark.drivers.offline import Requests

    cell = offline_cell()
    reqs = Requests(cell.cfg, cell.traffic, cell.seed)
    sample = offline_sample(cell, reqs, 20)
    n = cell.traffic["clips_per_request"]
    assert len(sample) == n * cell.traffic["check_requests"]
    # one request's clips: their bank offsets are one request's, in its order
    chosen = [r for r in range(20) if reqs.get(r)["offsets"] == [s["offset"] for s in sample]]
    assert len(chosen) == 1
    # the seed picks the request: other seeds pick others
    picks = {tuple(s["offset"] for s in offline_sample(
        offline_cell(seed=seed), Requests(cell.cfg, cell.traffic, seed), 20)) for seed in range(8)}
    assert len(picks) > 1


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_JSON["workloads"]])
def test_fp8_control_fails_at_the_cells_size(cell, cuda):
    from benchmark.control import control_reading

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        reading = control_reading(run.load_cell(cell, seed, cuda), 45)
        assert reading["vertex_err"] > limit(cell), (seed, reading)

"""The program's recording beside the traced window
(``benchmark/program_trace.py``) and the per-layer readers that use it:

- every accepted per-layer metric reads the same with the program's
  recording beside the trace and without it;
- the idle gaps are named ``"<harness span>/<program span>"`` and each idle
  stretch is split over the program spans that cover it;
- each reader of the recording returns its value from a synthetic ``ctx``,
  and None with no recording;
- a small cell's traced window on the CPU reads them all;
- on the card, K3's launches of a FaceFormer request fall inside
  ``predict.model`` (``cuda`` fixture).
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

from audio2face_tpu_torch.utils import spans
from audio2face_tpu_torch.utils.spans import Recording, Span
from benchmark import program_trace, run
from benchmark import trace as tracing
from benchmark.tests.conftest import BENCH, SMALL_VERTS, config, config_module, small_cell

BENCH_JSON = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
T0 = 1_000_000_000  # the window's start, ns


class Event:
    """A profiler event as ``Trace`` reads it."""

    def __init__(self, name, start, duration=0, cuda=False, corr=0):
        self._v = (name, T0 + start, duration, cuda, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]


def launched(name, start, end, at, corr):
    """A device event and the runtime call that launched it."""
    return [Event(name, start, end - start, cuda=True, corr=corr),
            Event("cudaLaunchKernel", at, 1, corr=corr)]


def scene():
    """A traced window of 1,000 ns: harness spans ``model`` (with
    ``features`` inside) and ``output``; device busy 120-190, 200-280,
    400-500; the program's spans of one request."""
    events = (launched("flash_fwd_wgmma_kernel<64>", 120, 160, 110, 1)
              + launched("mfcc_kernel", 160, 190, 155, 2)
              + launched("decode_cluster_kernel<false>", 200, 280, 190, 3)
              + launched("Memcpy DtoH (Device -> Pageable)", 400, 500, 390, 4))
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    harness = [(T0 + a, T0 + b, name) for a, b, name in
               [(0, 1000, tracing.WINDOW), (100, 300, "model"), (150, 200, "features"),
                (300, 900, "output")]]
    rec = Recording()
    for name, a, b, parent in [("predict", 50, 950, None), ("predict.model", 100, 300, 0),
                               ("predict.sync", 300, 310, 0), ("predict.head", 310, 350, 0),
                               ("predict.copy", 350, 520, 0), ("predict.unpack", 520, 900, 0)]:
        rec.spans.append(Span(name, T0 + a, T0 + b, parent, request=0))
    rec.spans[0].cpu_ns = 450
    rec.counters.update(frames_valid=466, frames_computed=1000, vertex_bytes_copied=12_000,
                        vertex_bytes_returned=5_592)
    return tracing.Trace(prof, harness), rec


def ctx_of(trace, rec=None):
    cfg = config("faceformer_vocaset")
    records = [{"frames": 300, "wall": 0.5, "lengths": [32000, 48000]},
               {"frames": 180, "wall": 0.4, "lengths": [48000]}]
    ctx = SimpleNamespace(trace=trace, window=SimpleNamespace(records=records), cfg=cfg,
                          cfgmod=config_module("faceformer_vocaset"), cell=None)
    if rec is not None:
        ctx.program = rec
    return ctx


def read(name, ctx):
    return run.load_module(BENCH / "metrics" / f"{name}.py", f"metric_{name}").read(ctx)


@pytest.mark.parametrize("name", [m["name"] for m in BENCH_JSON["per_layer"]])
def test_accepted_metrics_read_the_same_beside_the_recording(name):
    trace, rec = scene()
    without = read(name, ctx_of(trace))
    assert without is not None
    assert read(name, ctx_of(trace, rec)) == without


def test_idle_is_split_over_the_program_spans():
    trace, rec = scene()
    idle = program_trace.idle_by_span(trace, rec)
    want = {"outside": 100, "predict": 100, "predict.model": 50, "predict.sync": 10,
            "predict.head": 40, "predict.copy": 70, "predict.unpack": 380}
    assert idle == {k: v / 1e9 for k, v in want.items()}
    assert sum(idle.values()) == pytest.approx(trace.window_s - trace.busy_s)


def test_gap_names_take_the_harness_program_form():
    trace, rec = scene()
    gaps = program_trace.breakdown(trace, rec)["idle_gaps"]
    assert gaps == [["output/predict.copy", 500e-9], ["model/predict.model", 120e-9],
                    ["window", 120e-9], ["features/predict.model", 10e-9]]
    # the harness's own breakdown is unchanged beside it
    assert [g[1] for g in trace.breakdown()["idle_gaps"]] == [g[1] for g in gaps]


# (name, value by hand from scene() and ctx_of()'s two requests)
PROGRAM_READINGS = [
    ("request.d2h_wait_ms", 1e3 * 170e-9 / 2),
    ("request.unpack_ms", 1e3 * 380e-9 / 2),
    ("request.copy_useful_pct", 46.6),
    ("model.pad_useful_pct", 46.6),
    ("request.host_cpu_pct", 50.0),
    ("device.idle_in_output_pct", 100.0 * (40 + 70 + 380) / 750),
]


def test_program_metrics_are_listed_once():
    assert sorted(program_trace.PROGRAM_METRICS) == sorted(n for n, _ in PROGRAM_READINGS)
    accepted = {m["name"] for m in BENCH_JSON["per_layer"]}
    assert not accepted & set(program_trace.PROGRAM_METRICS)


@pytest.mark.parametrize("name,want", PROGRAM_READINGS)
def test_program_metric_reads_a_synthetic_ctx(name, want):
    trace, rec = scene()
    assert read(name, ctx_of(trace, rec)) == pytest.approx(want, rel=1e-12)
    assert read(name, ctx_of(trace)) is None


def test_a_small_traced_window_reads_the_program_metrics():
    cell = small_cell("faceformer_vocaset", "offline_mixed", "offline", clips_per_request=3,
                      length_median_s=1.2, length_sigma=0.3, length_max_s=2.0)
    out = program_trace.traced(cell, 2.0, BENCH_JSON)
    assert out["failed"] == 0 and out["attempted"] > 0
    # no device here: the readers of device time find nothing
    assert set(out["metrics"]) >= set(program_trace.PROGRAM_METRICS) - {"device.idle_in_output_pct"}
    assert out["metrics"]["request.copy_useful_pct"]["value"] == pytest.approx(
        out["metrics"]["model.pad_useful_pct"]["value"])
    counters = out["counters"]
    assert counters["vertex_bytes_copied"] == counters["frames_computed"] * SMALL_VERTS * 4
    assert counters["vertex_bytes_returned"] == counters["frames_valid"] * SMALL_VERTS * 4
    assert sum(out["idle_s_by_program_span"].values()) == pytest.approx(
        out["device"]["window_s"], rel=1e-6)


def test_k3_launches_fall_inside_predict_model(cuda):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = config("faceformer_vocaset", vertice_dim=SMALL_VERTS)
    mod = config_module("faceformer_vocaset")
    pred = mod.predictor(cfg, mod.weights(cfg, 7, cuda), cuda)
    rng = np.random.default_rng(0)
    audios = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (24000, 40000)]
    one_hot = np.eye(cfg["n_styles"], dtype=np.float32)[[1, 5]]
    template = np.zeros((SMALL_VERTS // 3, 3), np.float32)
    pred(audios, one_hot, template)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            spans.recording() as rec:
        pred(audios, one_hot, template)
        torch.cuda.synchronize()
    trace = tracing.Trace(prof, [])
    model = [(s.start_ns, s.end_ns) for s in rec.spans if s.name == "predict.model"]
    k3 = [t for (_, _, name, _), t in zip(trace.device, trace.launched)
          if "decode_cluster_kernel" in name]
    assert k3 and all(t is not None for t in k3)
    for t in k3:
        assert any(a <= t <= b for a, b in model), t

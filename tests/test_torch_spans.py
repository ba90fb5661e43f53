"""The serving path's spans and counters (``utils/spans.py``) on the CPU:
nothing is recorded while no recording is open, results stay bit-equal
with one open, the spans nest under one request id a call, the counters
match a count by hand, and the spans share the profiler's clock."""

import threading

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.models.faceformer import FaceFormer
from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor
from audio2face_tpu_torch.utils import spans

torch.set_num_threads(1)

N_VERTS = 300
ROW_BYTES = N_VERTS * 4  # one frame of f32 vertices
# clips of mixed lengths, two groups of at most 2: (0.3, 0.45) and (0.7)
SECONDS = (0.3, 0.7, 0.45)


@pytest.fixture(scope="module")
def faceformer():
    model = FaceFormer(n_verts=N_VERTS, n_onehot=12)
    g = torch.Generator().manual_seed(0)
    model.init_parameters(g)
    # non-zero motion maps, so the vertices are not the template
    with torch.no_grad():
        for lin in (model.vertice_map, model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.05)
    return FaceFormerPredictor(n_verts=N_VERTS, state_dict=model.state_dict(), bf16=False,
                               max_batch=2, bucket_seconds=0.5, device="cpu")


@pytest.fixture(scope="module")
def frame():
    cfg = ExpConfig(batch_size=8, modelname="audio2mesh", vertex_count=N_VERTS, one_hot_size=12,
                    feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                    out_dim=52, win_length=440, percision="32", lr=1e-3)
    return FramePredictor(cfg, max_batch=2, frame_batch=16, bucket_seconds=0.5, seed=3,
                          device="cpu")


def inputs_for(sr: int):
    rng = np.random.default_rng(1)
    audios = [(rng.normal(size=int(s * sr)) * 0.1).astype(np.float32) for s in SECONDS]
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    return audios, one_hot, template


@pytest.fixture(params=["faceformer", "frame"])
def case(request, faceformer, frame):
    """(predictor, one request's inputs)."""
    if request.param == "faceformer":
        return faceformer, inputs_for(16000)
    return frame, inputs_for(22000)


def test_no_recording_records_nothing(case, monkeypatch):
    pred, inputs = case

    def refuse(*args, **kwargs):
        raise AssertionError("recorded with no recording open")

    monkeypatch.setattr(spans._Open, "__init__", refuse)
    monkeypatch.setattr(spans.Recording, "count", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    out = pred(*inputs)
    assert len(out) == len(SECONDS)
    assert spans.span("predict") is spans.span("predict.copy")  # the shared no-op


def test_recording_leaves_results_bit_equal(case):
    pred, inputs = case
    want = pred(*inputs)
    with spans.recording() as rec:
        got = pred(*inputs)
    assert rec.spans
    for w, g in zip(want, got):
        assert w.tobytes() == g.tobytes()


def chunks(pred, frames: list) -> int:
    """Chunks a request of clips of ``frames`` frames copies out, with
    ``SECONDS``'s two groups."""
    groups = [frames[:2], frames[2:]]
    if isinstance(pred, FaceFormerPredictor):  # the head's chunk is the whole bucket here
        return len(groups)
    return sum(-(-max(g) // pred.frame_batch) for g in groups)


FACEFORMER_NAMES = {"predict.upload", "predict.model", "predict.encode", "predict.decode",
                    "predict.sync", "predict.head", "predict.copy", "predict.unpack"}
# spans opened inside another than ``predict``: the encoder and the decoder
# inside the model call
PARENTS = {"predict.encode": "predict.model", "predict.decode": "predict.model"}
FRAME_NAMES = {"predict.upload", "predict.model", "predict.copy", "predict.unpack"}


def test_spans_nest_under_one_request_a_call(case):
    pred, inputs = case
    with spans.recording() as rec:
        out = pred(*inputs)
        pred(*inputs)
    roots = [k for k, s in enumerate(rec.spans) if s.parent is None]
    assert [rec.spans[k].name for k in roots] == ["predict", "predict"]
    assert [rec.spans[k].request for k in roots] == [0, 1]
    thread = threading.get_ident()
    for s in rec.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns and s.thread == thread
        if s.parent is None:
            assert s.cpu_ns >= 0
            continue
        parent = rec.spans[s.parent]
        assert parent.name == PARENTS.get(s.name, "predict") and s.request == parent.request
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
        assert s.cpu_ns is None
    names = {s.name for s in rec.spans if s.parent is not None}
    assert names == (FACEFORMER_NAMES if isinstance(pred, FaceFormerPredictor) else FRAME_NAMES)
    n_copy = sum(s.name == "predict.copy" and s.request == 0 for s in rec.spans)
    assert n_copy == chunks(pred, sorted(o.shape[0] for o in out))


def test_counters_match_a_count_by_hand(case):
    pred, inputs = case
    with spans.recording() as rec:
        out = pred(*inputs)
    frames = sorted(o.shape[0] for o in out)  # the request's order: sorted by length
    decoder = {}
    if isinstance(pred, FaceFormerPredictor):
        # each group decodes its bucket's frames for every row of its batch
        # grid: 0.5 s (30 frames) for 2 rows, then 1 s (60) for 1
        computed = 2 * 30 + 1 * 60
        # the decoder steps every row of the grid; the plain loop spills no
        # cache row (the kernel's plan does, past its shared memory)
        decoder = {"decode_steps": computed, "decode_rows_spilled": 0}
    else:
        # 16-frame chunks of every row: 2 chunks of 2 rows, then 3 of 1
        computed = 2 * 2 * 16 + 3 * 1 * 16
    # only the valid rows go to the host; nothing is pinned and no host
    # allocator runs on the CPU
    assert rec.counters == {
        **decoder,
        "frames_valid": sum(frames),
        "frames_computed": computed,
        "vertex_bytes_copied": sum(frames) * ROW_BYTES,
        "vertex_bytes_returned": sum(frames) * ROW_BYTES,
        "vertex_bytes_pinned": 0,
        "host_alloc_misses": 0,
    }


def test_spans_share_the_profilers_clock(frame):
    """Ops launched inside ``predict.model`` (the model's convolutions) and
    ``predict.upload`` (the rows' ``repeat_interleave``) start, by the
    profiler's stamps, inside those spans."""
    from torch.profiler import ProfilerActivity, profile

    inputs = inputs_for(22000)
    frame(*inputs)
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as rec:
        frame(*inputs)
    starts: dict = {}
    for ev in prof.profiler.kineto_results.events():
        starts.setdefault(ev.name(), []).append(ev.start_ns())
    for op, name in (("aten::conv2d", "predict.model"), ("aten::repeat_interleave", "predict.upload")):
        inside = [(s.start_ns, s.end_ns) for s in rec.spans if s.name == name]
        assert starts.get(op)
        for t in starts[op]:
            assert any(a <= t <= b for a, b in inside), (op, t)


def test_a_second_recording_raises():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    with spans.recording() as rec:  # closed again: a new one opens
        spans.count("n", 2)
    assert rec.counters == {"n": 2}


def test_each_thread_has_its_own_stack():
    """A span opened on another thread is that thread's outermost one:
    its own request id, not a child of the span open here."""
    with spans.recording() as rec:
        with spans.span("predict"):
            t = threading.Thread(target=_one_span, args=("predict",))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with spans.span("predict.model"):
                pass
    main, other, model = rec.spans
    assert (main.parent, other.parent, model.parent) == (None, None, 0)
    assert (main.request, other.request, model.request) == (0, 1, 0)
    assert other.thread != main.thread and other.cpu_ns is not None


def _one_span(name):
    with spans.span(name):
        pass

"""``FramePredictor``'s offline chunks as CUDA graph replays
(``serving.py _FrameGraph``).

On the CPU: the predictor captures and replays nothing, ``warmup``
included. On the card (skipped without CUDA): for Audio2Mesh, VOCA and
Song2Face at two batch sizes, a request replayed from the graphs that
``warmup`` captured returns what the same weights return eagerly, bit for
bit; ``frame_graph_captures`` counts the row counts warmed and nothing
afterwards, ``frame_graph_replays`` the chunks run; the kernel wrappers
count no launch at a replay, while the profiler sees each replay run its
one-pass epilogues; back-to-back requests with other audio and styles each
return their own eager answers; the live pool's frame step and a mesh
predictor replay nothing.

No JAX: ``python3 -m pytest --noconftest tests/test_torch_frame_graph.py``
runs it on a machine without it."""

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.frame_stream import FrameStreamPool
from audio2face_tpu_torch.models.layers import TorchBatchNorm
from audio2face_tpu_torch.ops.frame_epilogue import frame_epilogue
from audio2face_tpu_torch.serving import FramePredictor
from audio2face_tpu_torch.utils import spans

torch.set_num_threads(1)

SR = 22000
N_VERTS = 300
KW = dict(max_batch=8, frame_batch=128, bucket_seconds=1.0)
# one-pass epilogues a forward of each frame model
BLOCKS = {"audio2mesh": 12, "voca": 4, "song2face": 9}


def config(name: str, percision: str = "16-mixed") -> ExpConfig:
    base = dict(batch_size=8, modelname=name, vertex_count=N_VERTS, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=SR, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision=percision, lr=1e-3)
    if name == "voca":
        base.update(n_feature=16, out_dim=29, win_length=790)
    return ExpConfig(**base)


def predictor(name: str, device, **kw) -> FramePredictor:
    """Seeded weights with non-zero conv biases and BatchNorm statistics."""
    pred = FramePredictor(config(name), seed=3, device=device, **{**KW, **kw})
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for m in pred.model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
            elif isinstance(m, TorchBatchNorm):
                c = m.bn.weight.shape[0]
                m.bn.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.bn.weight.copy_(torch.randn(c, generator=g) * 0.1 + 1)
                m.bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return pred


def request(seed: int, n: int, longest: float = 4.6):
    """``n`` clips of 0.4 s to ``longest`` s, the first that long, their
    styles and a template."""
    rng = np.random.default_rng(seed)
    seconds = np.concatenate([[longest], rng.uniform(0.4, longest, size=n - 1)])
    audios = [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32) for s in seconds]
    one_hot = np.eye(12, dtype=np.float32)[rng.integers(0, 12, n)]
    template = (rng.normal(size=(N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    return audios, one_hot, template


@pytest.fixture(autouse=True)
def own_launch_count(monkeypatch):
    """Each test counts its own launches from 0, and leaves the process's
    count as it found it for the test files that run after it."""
    monkeypatch.setattr(frame_epilogue, "launches", 0)


def counts(rec) -> dict:
    c = rec.counters
    return {"captures": c.get("frame_graph_captures", 0), "replays": c.get("frame_graph_replays", 0),
            "chunks": sum(1 for sp in rec.spans if sp.name == "predict.model"),
            "fused": c.get("conv_epilogues_fused", 0)}


def traced_epilogues(fn):
    """``fn()`` under the profiler: its result, and the one-pass epilogue
    kernels the device ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = fn()
        torch.cuda.synchronize()
    return got, sum(1 for e in prof.events() if getattr(e, "device_type", None) == DeviceType.CUDA
                    and "frame_epilogue_kernel" in e.name)


def assert_bit_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.tobytes() == w.tobytes()


# ---- CPU ------------------------------------------------------------------


def test_cpu_predictor_captures_and_replays_nothing():
    pred = FramePredictor(config("audio2mesh", "32"), seed=3, device="cpu", max_batch=2,
                          frame_batch=16, bucket_seconds=0.5)
    with spans.recording() as rec:
        pred.warmup(0.5, batches=[2])
        pred(*request(0, 2, longest=0.45))
    c = counts(rec)
    assert c["chunks"] > 0 and c["captures"] == c["replays"] == 0 and not pred._graphs


# ---- the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("n_clips", [8, 3], ids=["b_pad8", "b_pad4"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_replay_equals_the_eager_chunk(name, n_clips, cuda):
    eager, graphed = predictor(name, cuda), predictor(name, cuda)
    audios, one_hot, template = request(1, n_clips)
    b_pad = 8 if n_clips == 8 else 4
    with spans.recording() as rec:
        graphed.warmup(5.0, batches=[b_pad])
    c = counts(rec)
    # the wrappers count the eager chunks' launches and those recorded into the capture
    assert c["captures"] == 1 and c["fused"] == frame_epilogue.launches > BLOCKS[name]
    want = eager(audios, one_hot, template)
    frame_epilogue.launches = 0
    with spans.recording() as rec:
        got, traced = traced_epilogues(lambda: graphed(audios, one_hot, template))
    c = counts(rec)
    assert c["chunks"] == 3  # the longest clip: 276 frames in chunks of 128
    assert c["captures"] == 0 and c["replays"] == c["chunks"]
    assert c["fused"] == frame_epilogue.launches == 0
    assert traced == BLOCKS[name] * c["chunks"]
    assert_bit_equal(got, want)


def test_only_the_row_counts_warmed_capture(cuda):
    pred = predictor("audio2mesh", cuda)
    with spans.recording() as rec:
        pred.warmup(2.0, batches=[1, 2, 8])
    assert counts(rec)["captures"] == 3 and len(pred._graphs) == 3
    for n_clips, replayed in ((1, True), (2, True), (3, False), (8, True)):  # 3 pads to 4
        frame_epilogue.launches = 0
        with spans.recording() as rec:
            pred(*request(10 + n_clips, n_clips, longest=1.9))
        c = counts(rec)
        assert c["captures"] == 0 and c["chunks"] > 0
        assert c["replays"] == (c["chunks"] if replayed else 0), n_clips
        assert c["fused"] == frame_epilogue.launches == (
            0 if replayed else BLOCKS["audio2mesh"] * c["chunks"])


def test_back_to_back_requests_return_their_own_answers(cuda):
    """Two 16-clip requests (two groups of 8 each, other styles and
    templates) held at once: each equals its eager answer, so no replay
    overwrote a chunk before its copies landed and every group's style rows
    reached the graph."""
    eager, graphed = predictor("audio2mesh", cuda), predictor("audio2mesh", cuda)
    graphed.warmup(5.0, batches=[8])
    first, second = request(20, 16), request(21, 16)
    with spans.recording() as rec:
        got = [graphed(*first), graphed(*second)]
    c = counts(rec)
    assert c["captures"] == 0 and c["replays"] == c["chunks"] > 4
    assert_bit_equal(got[0], eager(*first))
    assert_bit_equal(got[1], eager(*second))


def test_live_pool_and_mesh_replay_nothing(cuda):
    from audio2face_tpu_torch.parallel import make_mesh

    base = predictor("audio2mesh", cuda)
    pool = FrameStreamPool(config("audio2mesh"), state_dict=base.model.state_dict(), n_streams=3,
                           device=cuda)
    rng = np.random.default_rng(30)
    windows = (rng.normal(size=(3, pool.span)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[:3]
    template = (rng.normal(size=(3, N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    with spans.recording() as rec:
        pool.forward(windows, one_hot, template, np.asarray([0, 23, 1001], np.int64))
        torch.cuda.synchronize()
    assert counts(rec)["replays"] == 0 and not pool._base._graphs

    meshed = FramePredictor(config("audio2mesh"), state_dict=base.model.state_dict(), device=cuda,
                            mesh=make_mesh((1, 1)), **KW)
    with spans.recording() as rec:
        meshed.warmup(2.0, batches=[8])
        got = meshed(*request(31, 8, longest=1.9))
    c = counts(rec)
    assert c["chunks"] > 0 and c["captures"] == c["replays"] == 0 and not meshed._graphs
    assert_bit_equal(got, base(*request(31, 8, longest=1.9)))

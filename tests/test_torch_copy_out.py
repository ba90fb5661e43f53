"""The request output path (``serving.py _CopyOut``): each chunk's valid
vertex rows copied straight into the clips' results.

On the CPU the copy plan is held, bit for bit, to the old path written
here: a plain ``out.cpu()`` of each chunk and a scatter of each clip's
rows. FaceFormer's vertex head is cut into chunks so that every group's
longest clip spans three of them and the tail chunk is realigned. On the
card (skipped without CUDA): the results are pinned and complete when the
call returns, results a caller still holds survive the next call, and a
repeated call makes no new host allocation."""

import numpy as np
import pytest
import torch

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.models.faceformer import FaceFormer
from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor, _CopyOut
from audio2face_tpu_torch.utils import spans

torch.set_num_threads(1)

N_VERTS = 300
ROW_BYTES = N_VERTS * 4  # one frame of f32 vertices
# two groups of at most 2: (0.3, 0.45) s in a 0.5 s bucket (30 frames at
# 60 fps) and (0.95) s in a 1 s bucket (60 frames)
SECONDS = (0.3, 0.95, 0.45)
FRAMES = [18, 57, 27]
# FaceFormer's head chunk: 11 frames at a batch of 2, 22 at a batch of 1.
# Chunks start at 0, 11, 22 -> 19 (realigned by 3) and 0, 22, 44 -> 38 (by 6)
CHUNK_BYTES = 22 * N_VERTS * 4
FACEFORMER_OFFSETS = [0, 0, 3, 0, 0, 6]
KINDS = ["faceformer", "frame"]


def build(kind: str, device: str):
    """(predictor, one request's inputs, the same request with other audio)."""
    if kind == "faceformer":
        model = FaceFormer(n_verts=N_VERTS, n_onehot=12)
        g = torch.Generator().manual_seed(0)
        model.init_parameters(g)
        # non-zero motion maps, so the vertices are not the template
        with torch.no_grad():
            for lin in (model.vertice_map, model.vertice_map_r):
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
                lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.05)
        pred = FaceFormerPredictor(n_verts=N_VERTS, state_dict=model.state_dict(), bf16=False,
                                   max_batch=2, bucket_seconds=0.5, device=device)
        pred._VERTEX_CHUNK_BYTES = CHUNK_BYTES
        sr = 16000
    else:
        cfg = ExpConfig(batch_size=8, modelname="audio2mesh", vertex_count=N_VERTS,
                        one_hot_size=12, feature_extractor="mfcc", sample_rate=22000,
                        split_frame=True, n_feature=32, out_dim=52, win_length=440,
                        percision="32", lr=1e-3)
        pred = FramePredictor(cfg, max_batch=2, frame_batch=16, bucket_seconds=0.5, seed=3,
                              device=device)
        sr = 22000
    return pred, inputs_for(sr, 1), inputs_for(sr, 2)


def inputs_for(sr: int, seed: int):
    rng = np.random.default_rng(seed)
    audios = [(rng.normal(size=int(s * sr)) * 0.1).astype(np.float32) for s in SECONDS]
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    return audios, one_hot, template


def old_send(self, out, off, lo, dsts, frames):
    """The old path: the whole chunk to the host, then its rows scattered."""
    chunk = out.cpu().numpy()
    for j, dst in enumerate(dsts):
        m = min(frames[j], lo + chunk.shape[1] - off) - lo
        if m > 0:
            dst.numpy()[lo : lo + m] = chunk[j, off : off + m]


@pytest.mark.parametrize("kind", KINDS)
def test_copy_plan_equals_a_plain_copy_and_scatter(kind, monkeypatch):
    pred, inputs, _ = build(kind, "cpu")
    sends = []
    send, results = _CopyOut.send, _CopyOut.results

    def logged(self, out, off, lo, dsts, frames):
        sends.append(off)
        send(self, out, off, lo, dsts, frames)

    def nan_filled(self, frames, n_verts):  # a row never written shows
        return [r.fill_(float("nan")) for r in results(self, frames, n_verts)]

    monkeypatch.setattr(_CopyOut, "send", logged)
    monkeypatch.setattr(_CopyOut, "results", nan_filled)
    got = pred(*inputs)
    monkeypatch.setattr(_CopyOut, "send", old_send)
    want = pred(*inputs)
    assert [g.shape for g in got] == [(n, N_VERTS // 3, 3) for n in FRAMES]
    for g, w in zip(got, want):
        assert not np.isnan(g).any()
        assert g.tobytes() == w.tobytes()
    if kind == "faceformer":
        assert sends == FACEFORMER_OFFSETS
    else:  # 16-frame chunks: 2 for the first group, 4 for the second
        assert sends == [0] * 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("kind", KINDS)
def test_results_are_pinned_complete_and_kept(kind, cuda, monkeypatch):
    pred, inputs, other = build(kind, cuda)
    want = pred(*inputs)
    torch.cuda.synchronize()
    want = [w.copy() for w in want]
    send = _CopyOut.send

    def late(self, *args):  # the copy stream starts ~50 ms behind the host
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(100_000_000)
        send(self, *args)

    monkeypatch.setattr(_CopyOut, "send", late)
    first = pred(*inputs)
    held = [f.copy() for f in first]  # read before any synchronize
    for f, h, w in zip(first, held, want):
        assert torch.from_numpy(f).is_pinned()
        assert h.tobytes() == w.tobytes()
    second = pred(*other)
    assert any(s.tobytes() != f.tobytes() for s, f in zip(second, first))
    for f, h in zip(first, held):  # no block of a held result was reused
        assert f.tobytes() == h.tobytes()


@pytest.mark.parametrize("kind", KINDS)
def test_a_repeated_call_allocates_no_host_memory(kind, cuda):
    pred, inputs, _ = build(kind, cuda)
    pred(*inputs)  # dropped: its blocks go back to the cache
    with spans.recording() as rec:
        pred(*inputs)
    counters = rec.counters
    assert counters["host_alloc_misses"] == 0
    returned = sum(FRAMES) * ROW_BYTES
    assert counters["vertex_bytes_returned"] == returned
    assert counters["vertex_bytes_copied"] == counters["vertex_bytes_pinned"] == returned

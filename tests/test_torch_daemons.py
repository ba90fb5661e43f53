"""The port's serving front ends on the CPU: ``BatchingServer`` coalescing,
backpressure, timeouts, cancellation and failure isolation; the HTTP daemon
and the live TCP daemon over loopback, in the shape of
tests/test_http_server.py and tests/test_live_server.py (a 300-wide head);
and the new entry points' refusal to fall back to the CPU."""

import http.client
import io
import json
import queue
import socket
import threading
import time

import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from audio2face_tpu.http_server import decode_audio_body as jax_decode_audio_body
from audio2face_tpu_torch.http_server import ServingDaemon, decode_audio_body
from audio2face_tpu_torch.live_server import LiveClient, LiveStreamingDaemon, recv_msg, send_msg
from audio2face_tpu_torch.models.faceformer import FaceFormer
from audio2face_tpu_torch.multistream import StreamingServer
from audio2face_tpu_torch.serving import FaceFormerPredictor
from audio2face_tpu_torch.serving_queue import BatchingServer
from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor
from audio2face_tpu_torch.utils import spans

torch.set_num_threads(1)

SR = 16000
N_VERTS = 300
CHUNK_S = 0.4
CHUNK = int(CHUNK_S * SR)


@pytest.fixture(scope="module")
def state():
    """A FaceFormer state dict with non-zero motion maps."""
    model = FaceFormer(n_verts=N_VERTS, n_onehot=12)
    g = torch.Generator().manual_seed(0)
    model.init_parameters(g)
    with torch.no_grad():
        for lin in (model.vertice_map, model.vertice_map_r):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.05)
    return model.state_dict()


# ---- BatchingServer --------------------------------------------------------


class _Recorder:
    """A predictor that records its batch sizes and returns (T, V, 3) with
    T = len(audio) and every value = the one-hot's argmax."""

    max_batch = 4

    def __init__(self, delay=0.0, fail_on=None):
        self.batches, self.delay, self.fail_on = [], delay, fail_on
        self.grad_enabled = []

    def __call__(self, audios, one_hot, template, sample_rate=16000):
        self.batches.append(len(audios))
        self.grad_enabled.append(torch.is_grad_enabled())
        time.sleep(self.delay)
        if self.fail_on is not None and any(len(a) == self.fail_on for a in audios):
            raise ValueError("bad clip")
        return [np.full((len(a), 2, 3), float(np.argmax(o)), np.float32)
                for a, o in zip(audios, one_hot)]


def test_batching_server_coalesces_and_routes():
    pred = _Recorder(delay=0.05)
    server = BatchingServer(pred, max_wait_ms=50.0)
    try:
        futs = [server.submit(np.zeros(5 + i, np.float32), np.eye(12)[i % 12], np.zeros((2, 3)))
                for i in range(8)]
        results = [f.result(timeout=30) for f in futs]
    finally:
        server.close()
    for i, r in enumerate(results):
        assert r.shape == (5 + i, 2, 3) and r[0, 0, 0] == i % 12
    assert sum(pred.batches) == 8 and len(pred.batches) < 8
    assert max(pred.batches) <= pred.max_batch
    assert not any(pred.grad_enabled)  # the dispatcher thread runs under inference_mode


def test_batching_server_backpressure_timeout_cancel_and_failure():
    pred = _Recorder(delay=0.3, fail_on=7)
    server = BatchingServer(pred, max_wait_ms=1.0, max_queue=1)
    try:
        first = server.submit(np.zeros(3, np.float32), np.eye(12)[0], np.zeros((2, 3)))
        time.sleep(0.1)  # the dispatcher holds `first`; the queue is empty
        second = server.submit(np.zeros(3, np.float32), np.eye(12)[1], np.zeros((2, 3)))
        with pytest.raises(queue.Full):
            server.submit(np.zeros(3, np.float32), np.eye(12)[2], np.zeros((2, 3)), block=False)
        assert second.cancel()
        assert first.result(timeout=30).shape == (3, 2, 3)
        bad = server.submit(np.zeros(7, np.float32), np.eye(12)[3], np.zeros((2, 3)))
        with pytest.raises(ValueError, match="bad clip"):
            bad.result(timeout=30)
        # the dispatcher survived the failure; a queued request can time out
        slow = server.submit(np.zeros(4, np.float32), np.eye(12)[4], np.zeros((2, 3)))
        time.sleep(0.1)  # the dispatcher is busy with `slow`
        late = server.submit(np.zeros(4, np.float32), np.eye(12)[5], np.zeros((2, 3)),
                             timeout=0.01)
        assert slow.result(timeout=30).shape == (4, 2, 3)
        with pytest.raises(TimeoutError):
            late.result(timeout=30)
    finally:
        server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(np.zeros(3, np.float32), np.eye(12)[0], np.zeros((2, 3)))


class _SpannedRecorder(_Recorder):
    """A predictor that marks its calls as the port's predictors do."""

    def __call__(self, *args, **kwargs):
        with spans.span("predict"):
            return super().__call__(*args, **kwargs)


def test_queue_wait_in_stats_and_spans():
    """Requests submitted while the dispatcher is busy wait for it: their
    waits reach ``/stats`` as ``queue_wait_ms``. With a span recording
    open, the dispatcher thread records the predictor's spans on its own
    stack, one request id a call, and the queue records none of its own."""
    pred = _SpannedRecorder(delay=0.3)
    daemon = ServingDaemon(pred, np.zeros((2, 3), np.float32), max_wait_ms=1.0)
    try:
        with spans.recording() as rec:
            first = daemon.batcher.submit(np.zeros(3, np.float32), np.eye(12)[0], np.zeros((2, 3)))
            time.sleep(0.1)  # the dispatcher holds `first` for 0.3 s
            rest = [daemon.batcher.submit(np.zeros(3, np.float32), np.eye(12)[i], np.zeros((2, 3)))
                    for i in (1, 2)]
            for f in [first, *rest]:
                f.result(timeout=30)
        waits = daemon.batcher.queue_waits()
        stats = daemon.stats()
    finally:
        daemon.stop()
    assert len(waits) == 3 and min(waits) >= 0.0 and max(waits) >= 0.1
    assert stats["queue_wait_ms"]["window"] == 3
    assert stats["queue_wait_ms"]["max"] == round(max(waits) * 1e3, 1) >= 100.0
    assert stats["queue_wait_ms"]["p95"] >= stats["queue_wait_ms"]["p50"]
    assert [s.name for s in rec.spans] == ["predict"] * len(pred.batches)
    assert sorted(s.request for s in rec.spans) == list(range(len(pred.batches)))
    assert all(s.parent is None and s.end_ns is not None for s in rec.spans)
    assert {s.thread for s in rec.spans} == {daemon.batcher._thread.ident}


# ---- HTTP daemon -----------------------------------------------------------


@pytest.fixture(scope="module")
def daemon(state):
    predictor = FaceFormerPredictor(n_verts=N_VERTS, bf16=False, max_batch=4,
                                    bucket_seconds=0.5, state_dict=state, device="cpu")
    template = np.random.default_rng(0).normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    d = ServingDaemon(predictor, template, port=0, max_wait_ms=250.0, max_queue=16)
    d.start()
    yield d
    d.stop()


def _conn(daemon):
    return http.client.HTTPConnection("127.0.0.1", daemon.port, timeout=300)


def _wav_bytes(audio: np.ndarray, sr: int = SR) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, sr, (audio * 32768).clip(-32768, 32767).astype(np.int16))
    return buf.getvalue()


def _post_wav(daemon, audio, query=""):
    c = _conn(daemon)
    c.request("POST", f"/v1/infer{query}", body=_wav_bytes(audio),
              headers={"Content-Type": "audio/wav"})
    r = c.getresponse()
    body = r.read()
    c.close()
    return r, body


def test_healthz_names_the_torch_device(daemon):
    c = _conn(daemon)
    c.request("GET", "/healthz")
    r = c.getresponse()
    obj = json.loads(r.read())
    c.close()
    assert r.status == 200
    assert obj == {"status": "ok", "backend": "cpu", "model": "FaceFormerPredictor"}


def test_concurrent_requests_coalesce_and_match_direct_calls(daemon):
    """Four concurrent WAV requests are answered in fewer predictor calls than
    requests, each equal to a direct predictor call on the decoded body."""
    rng = np.random.default_rng(4)
    audios = [(rng.normal(size=int(0.3 * SR)) * 0.1).astype(np.float32) for _ in range(4)]
    before = dict(daemon.stats())
    calls = []
    orig = daemon.batcher.predictor

    class Counting:
        max_batch, n_onehot = orig.max_batch, orig.n_onehot

        def __call__(self, *a, **kw):
            calls.append(len(a[0]))
            return orig(*a, **kw)

    daemon.batcher.predictor = Counting()
    results = [None] * 4
    try:
        def worker(i):
            results[i] = _post_wav(daemon, audios[i], query=f"?subject={i}")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
    finally:
        daemon.batcher.predictor = orig
    assert sum(calls) == 4 and len(calls) < 4, calls
    for i, (r, body) in enumerate(results):
        assert r.status == 200
        got = np.load(io.BytesIO(body))
        wav, sr = decode_audio_body(_wav_bytes(audios[i]), "audio/wav", None)
        want = orig([wav], np.eye(12, dtype=np.float32)[[i]], daemon.template, sample_rate=sr)[0]
        assert got.shape == (int(0.3 * SR) * 60 // SR, N_VERTS // 3, 3)
        np.testing.assert_allclose(got, want, atol=2e-3)
    after = daemon.stats()
    assert after["ok"] == before["ok"] + 4 and after["in_flight"] == 0
    assert after["batches"] - before["batches"] == len(calls) < 4
    assert after["latency_ms"]["p95"] >= after["latency_ms"]["p50"] > 0


def test_raw_pcm_json_and_error_statuses(daemon):
    rng = np.random.default_rng(2)
    audio = (rng.normal(size=int(0.3 * SR)) * 0.1).astype(np.float32)
    c = _conn(daemon)
    c.request("POST", "/v1/infer", body=audio.tobytes(),
              headers={"X-Sample-Rate": str(SR), "Accept": "application/json"})
    r = c.getresponse()
    obj = json.loads(r.read())
    assert r.status == 200
    assert np.asarray(obj["vertices"]).shape == tuple(obj["shape"]) == (18, N_VERTS // 3, 3)
    for body, headers, query, status, word in (
        (b"", {"Content-Type": "audio/wav"}, "", 400, b"empty"),
        (np.zeros(100, np.float32).tobytes(), {}, "", 400, b"X-Sample-Rate"),
        (np.zeros(1600, np.float32).tobytes(), {"X-Sample-Rate": str(SR)}, "?subject=99", 400, b"subject"),
        (_wav_bytes(audio), {"Content-Type": "audio/wav"}, "?subject=notanint", 400, b"error"),
    ):
        c.request("POST", f"/v1/infer{query}", body=body, headers=headers)
        r = c.getresponse()
        assert r.status == status and word in r.read()
    c.request("POST", "/v1/nope", body=_wav_bytes(audio), headers={"Content-Type": "audio/wav"})
    r = c.getresponse()
    assert r.status == 404
    r.read()
    # keep-alive survived the errors with unread bodies
    c.request("POST", "/v1/infer", body=_wav_bytes(audio), headers={"Content-Type": "audio/wav"})
    r = c.getresponse()
    body = r.read()
    c.close()
    assert r.status == 200 and r.getheader("X-FPS") == "60"
    assert np.load(io.BytesIO(body)).shape == (18, N_VERTS // 3, 3)


def test_decode_audio_body_matches_jax():
    rng = np.random.default_rng(3)
    stereo = (rng.normal(size=(800, 2)) * 3000).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, 22050, stereo)
    for args in ((buf.getvalue(), "audio/wav", None),
                 (np.arange(10, dtype=np.float32).tobytes(), "", "8000")):
        got, want = decode_audio_body(*args), jax_decode_audio_body(*args)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="multiple of 4"):
        decode_audio_body(b"\x00" * 6, "", "16000")


# ---- live daemon -----------------------------------------------------------


@pytest.fixture(scope="module")
def live(state):
    d = LiveStreamingDaemon(
        server=StreamingServer(state_dict=state, n_verts=N_VERTS, n_streams=2, device="cpu",
                               chunk_seconds=CHUNK_S, left_seconds=0.4, lookahead_seconds=0.0),
        idle_poll_ms=20.0,
    )
    d.start()
    yield d
    d.stop()


def _solo(state, subject, clip):
    pred = StreamingFaceFormerPredictor(state_dict=state, n_verts=N_VERTS, device="cpu",
                                        chunk_seconds=CHUNK_S, left_seconds=0.4,
                                        lookahead_seconds=0.0)
    pred.start_stream(np.eye(12, dtype=np.float32)[subject], np.zeros((N_VERTS // 3, 3), np.float32))
    return np.concatenate([o for o in (pred.push(clip), pred.flush()) if o.size])


def test_live_clients_match_solo_streams(live, state):
    """Two concurrent clients over the wire each get their solo stream's
    frames."""
    rng = np.random.default_rng(5)
    clips = [(rng.normal(size=k * CHUNK) * 0.1).astype(np.float32) for k in (3, 2)]
    results, errs = [None, None], []

    def run(i):
        try:
            with LiveClient(live.port, subject=2 + i, sample_rate=SR, timeout=30.0) as c:
                assert c.info == {"verts": N_VERTS // 3, "fps": 60, "sample_rate": SR, "streams": 2}
                got = [c.send(clips[i][off : off + 5000]) for off in range(0, len(clips[i]), 5000)]
                results[i] = np.concatenate(got + [c.finish()])
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs, errs
    for i in range(2):
        np.testing.assert_allclose(results[i], _solo(state, 2 + i, clips[i]), atol=1e-5)
    assert live.stats()["frames_out"] >= sum(r.shape[0] for r in results)


def test_live_protocol_errors(live):
    with pytest.raises(RuntimeError, match="16000 Hz"):
        LiveClient(live.port, sample_rate=44100)
    with pytest.raises(RuntimeError, match="subject"):
        LiveClient(live.port, subject=99)
    s = socket.create_connection(("127.0.0.1", live.port), timeout=30)
    send_msg(s, b"A", b"\x00" * 8)
    typ, payload = recv_msg(s)
    assert typ == b"X" and "hello" in json.loads(payload.decode())["error"]
    s.close()
    c = LiveClient(live.port, timeout=10.0)
    send_msg(c._sock, b"A", b"\x00" * 6)  # not a whole float32 count
    with pytest.raises(RuntimeError, match="float32"):
        c.finish()
    c.close()
    # a full pool fails fast, and the slots come back on close
    holders = [LiveClient(live.port, timeout=10.0) for _ in range(2)]
    with pytest.raises(RuntimeError, match="busy"):
        LiveClient(live.port)
    for h in holders:
        h.close()
    LiveClient(live.port, timeout=10.0).close()


def test_live_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.frame_stream import FrameStreamPool
    from audio2face_tpu_torch.multistream import MultiStreamFaceFormerPredictor
    from audio2face_tpu_torch.runtime import Prefetcher

    cfg = ExpConfig(batch_size=2, modelname="audio2mesh", vertex_count=30, one_hot_size=12,
                    feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                    out_dim=52, win_length=440, percision="32", lr=1e-3)
    for make in (lambda: StreamingFaceFormerPredictor(n_verts=30),
                 lambda: MultiStreamFaceFormerPredictor(n_verts=30),
                 lambda: FrameStreamPool(cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(RuntimeError):
        next(Prefetcher(iter([np.zeros(2)]), device="cuda"))

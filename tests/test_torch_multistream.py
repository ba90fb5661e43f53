"""The port's multi-stream FaceFormer pool (CPU, f32) against the JAX pool and
against solo streams, at tests/test_multistream.py's bar (atol 2e-5, rtol
1e-5): interleaved streams, a late joiner, the masked tail flush, the pool's
lifecycle, and ``StreamingServer`` with concurrent sessions. Exactness
configurations use lookahead 0 and chunk-multiple clips, as in the JAX
tests, so that the pool and a solo stream consume the same windows."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.multistream import MultiStreamFaceFormerPredictor as JaxPool
from audio2face_tpu_torch.compat.jax_params import faceformer_jax_tree_from_state_dict
from audio2face_tpu_torch.models.faceformer import FaceFormer, frame_count
from audio2face_tpu_torch.multistream import MultiStreamFaceFormerPredictor, StreamingServer
from audio2face_tpu_torch.parallel import make_mesh
from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

torch.set_num_threads(1)

SR = 16000
N_VERTS = 300
CHUNK_S = 0.4  # 6400 samples = 24 frames
CHUNK = int(CHUNK_S * SR)
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """Random weights from the port's seeded init (its head moved off the
    zero-init motion maps), as the port's state and as JAX variables."""
    model = FaceFormer(n_verts=N_VERTS, n_onehot=12)
    model.init_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    state = {k: v if k.startswith("audio_encoder.") else v + 0.01 * torch.randn(v.shape, generator=gen)
             for k, v in model.state_dict().items()}
    variables = {"params": jax.tree.map(jnp.asarray, faceformer_jax_tree_from_state_dict(state))}
    rng = np.random.default_rng(0)
    one_hot = np.eye(12, dtype=np.float32)
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    return variables, state, one_hot, template


def _kw(left=0.4, **over):
    return dict(chunk_seconds=CHUNK_S, left_seconds=left, lookahead_seconds=0.0, **over)


@pytest.fixture(scope="module")
def solo(setup):
    """A clip through a solo stream with the setup's template; one predictor
    for each left context, restarted for every clip."""
    _, state, _, template = setup
    preds = {}

    def run(one_hot, clip, left=0.4):
        if left not in preds:
            preds[left] = StreamingFaceFormerPredictor(state_dict=state, n_verts=N_VERTS,
                                                       device="cpu", **_kw(left))
        pred = preds[left]
        pred.start_stream(one_hot, template)
        outs = [pred.push(clip), pred.flush()]
        return np.concatenate([o for o in outs if o.size])

    return run


def _interleave(pool, one_hot, template, clips, steps):
    slots = [pool.open_stream(one_hot[i], template) for i in range(len(clips))]
    got = [[] for _ in clips]
    offs = [0] * len(clips)
    while any(offs[i] < len(c) for i, c in enumerate(clips)):
        for i, c in enumerate(clips):
            if offs[i] < len(c):
                j = min(offs[i] + steps[i], len(c))
                got[i].append(pool.push(slots[i], c[offs[i]:j], last=j == len(c)))
                offs[i] = j
    return [np.concatenate([o for o in g + [pool.poll(s)] if o.size]) for g, s in zip(got, slots)]


def test_interleaved_streams_match_jax_pool_and_solo(setup, solo):
    """Three streams pushed in different packet sizes, one with a tail off
    the chunk grid: each equals the JAX pool's stream, and the chunk-multiple
    ones their solo runs."""
    variables, state, one_hot, template = setup
    rng = np.random.default_rng(7)
    clips = [(rng.normal(size=n) * 0.1).astype(np.float32)
             for n in (2 * CHUNK, CHUNK, CHUNK + 2500)]
    steps = [2560, 6400, 1600]
    want = _interleave(JaxPool(variables, N_VERTS, n_streams=4, **_kw()), one_hot, template,
                       clips, steps)
    pool = MultiStreamFaceFormerPredictor(state_dict=state, n_verts=N_VERTS, n_streams=4,
                                          device="cpu", **_kw())
    got = _interleave(pool, one_hot, template, clips, steps)
    for i in range(3):
        assert got[i].shape == (frame_count(len(clips[i])), N_VERTS // 3, 3)
        np.testing.assert_allclose(got[i], want[i], err_msg=f"stream {i}", **TOL)
    for i in range(2):
        np.testing.assert_allclose(got[i], solo(one_hot[i], clips[i]),
                                   err_msg=f"solo {i}", **TOL)
    # the masked tail flush: the third stream's chunks equal its solo run's
    tail_solo = solo(one_hot[2], clips[2])
    np.testing.assert_allclose(got[2][:24], tail_solo[:24], **TOL)


def test_late_joiner_is_exact_and_harmless(setup, solo):
    """A stream that joins mid-flight decodes like a solo run, and the running
    stream's frames are unchanged by it."""
    _, state, one_hot, template = setup
    rng = np.random.default_rng(11)
    clip_a = (rng.normal(size=2 * CHUNK) * 0.1).astype(np.float32)
    clip_b = (rng.normal(size=CHUNK) * 0.1).astype(np.float32)
    pool = MultiStreamFaceFormerPredictor(state_dict=state, n_verts=N_VERTS, n_streams=2,
                                          device="cpu", **_kw())
    a = pool.open_stream(one_hot[0], template)
    out_a = [pool.push(a, clip_a[:CHUNK])]  # A runs a chunk alone
    b = pool.open_stream(one_hot[5], template)  # B joins late
    out_b = [pool.push(b, clip_b, last=True)]
    out_a += [pool.push(a, clip_a[CHUNK:], last=True), pool.poll(a)]
    out_b.append(pool.poll(b))
    np.testing.assert_allclose(np.concatenate([o for o in out_a if o.size]),
                               solo(one_hot[0], clip_a), **TOL)
    np.testing.assert_allclose(np.concatenate([o for o in out_b if o.size]),
                               solo(one_hot[5], clip_b), **TOL)


def test_pool_lifecycle_capacity_and_reuse(setup, solo):
    _, state, one_hot, template = setup
    pool = MultiStreamFaceFormerPredictor(state_dict=state, n_verts=N_VERTS, n_streams=2,
                                          device="cpu", **_kw(left=0.0, max_seconds=1.0))
    a = pool.open_stream(one_hot[0], template)
    b = pool.open_stream(one_hot[1], template)
    with pytest.raises(RuntimeError, match="busy"):
        pool.open_stream(one_hot[2], template)
    # capacity is per slot and raises before any state changes
    with pytest.raises(RuntimeError, match="max_seconds"):
        pool.push(a, np.zeros(2 * SR, np.float32))
    pool.close_stream(a)
    c = pool.open_stream(one_hot[2], template)  # slot reused
    rng = np.random.default_rng(3)
    clip = (rng.normal(size=CHUNK) * 0.1).astype(np.float32)
    out = pool.push(c, clip, last=True)
    assert out.shape[0] == frame_count(len(clip))
    np.testing.assert_allclose(out, solo(one_hot[2], clip, left=0.0), **TOL)
    # b, idle so far, still works
    np.testing.assert_allclose(pool.push(b, clip, last=True),
                               solo(one_hot[1], clip, left=0.0), **TOL)
    with pytest.raises(RuntimeError, match="flushed"):
        pool.push(b, clip)
    # on a one-rank mesh the slot-sharded pool decodes the same
    meshed = MultiStreamFaceFormerPredictor(state_dict=state, n_verts=N_VERTS, n_streams=2,
                                            device="cpu", mesh=make_mesh((1, 1)),
                                            **_kw(left=0.0, max_seconds=1.0))
    s = meshed.open_stream(one_hot[2], template)
    np.testing.assert_allclose(meshed.push(s, clip, last=True),
                               solo(one_hot[2], clip, left=0.0), **TOL)


def test_streaming_server_concurrent_sessions(setup, solo):
    """Threaded callers through StreamingServer each reproduce their solo
    stream; a full pool raises, and wait=True blocks until a slot frees."""
    _, state, one_hot, template = setup
    rng = np.random.default_rng(21)
    clips = [(rng.normal(size=k * CHUNK) * 0.1).astype(np.float32) for k in (2, 1, 1)]
    server = StreamingServer(state_dict=state, n_verts=N_VERTS, n_streams=3, device="cpu", **_kw())
    outs, errs = [None] * 3, []

    def run(i):
        try:
            sess = server.open_session(one_hot[i], template)
            got = []
            step = 2000 + 500 * i  # different packet sizes per caller
            for off in range(0, len(clips[i]), step):
                got.append(sess.push(clips[i][off : off + step], last=off + step >= len(clips[i])))
            got.append(sess.poll())
            outs[i] = np.concatenate([g for g in got if g.size])
            sess.close()
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errs, errs
    for i in range(3):
        np.testing.assert_allclose(outs[i], solo(one_hot[i], clips[i]),
                                   err_msg=f"session {i}", **TOL)

    s1 = server.open_session(one_hot[0], template)
    s2 = server.open_session(one_hot[1], template)
    s3 = server.open_session(one_hot[2], template)
    with pytest.raises(RuntimeError, match="busy"):
        server.open_session(one_hot[3], template)
    with pytest.raises(TimeoutError):
        server.open_session(one_hot[3], template, wait=True, timeout=0.05)
    releaser = threading.Timer(0.2, s1.close)
    releaser.start()
    s4 = server.open_session(one_hot[3], template, wait=True, timeout=10.0)
    releaser.join(timeout=10)
    for s in (s2, s3, s4):
        s.close()
    with pytest.raises(TypeError, match="pool="):
        StreamingServer(pool=object(), n_verts=N_VERTS)

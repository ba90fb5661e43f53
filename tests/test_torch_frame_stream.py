"""The port's FrameStreamPool (CPU, f32) against the JAX pool on the same
variables and against the port's offline FramePredictor, at
tests/test_frame_stream.py's bar (atol 1e-6): interleaved ragged pushes,
flush tails, slot reuse, ``StreamingServer`` in front of the pool, and the
window gather's ``f0 % FPS`` form."""

import numpy as np
import pytest
import torch

from audio2face_tpu.config import ExpConfig as JaxExpConfig
from audio2face_tpu.frame_stream import FrameStreamPool as JaxFrameStreamPool
from audio2face_tpu.serving import FramePredictor as JaxFramePredictor
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.frame_stream import FPS, FrameStreamPool, window_offsets
from audio2face_tpu_torch.multistream import StreamingServer
from audio2face_tpu_torch.parallel import make_mesh
from audio2face_tpu_torch.serving import FramePredictor

torch.set_num_threads(1)

SR = 22000
N_VERTS = 300


def _cfg(modelname, cls=ExpConfig):
    base = dict(batch_size=8, modelname=modelname, vertex_count=N_VERTS, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=SR, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=1e-3)
    if modelname == "voca":
        base.update(n_feature=16, out_dim=29, win_length=790)
    return cls(**base)


@pytest.fixture(scope="module", params=["audio2mesh", "voca", "song2face"])
def stack(request):
    import jax

    jax_pred = JaxFramePredictor(_cfg(request.param, JaxExpConfig), max_batch=4, frame_batch=16,
                                 bucket_seconds=0.5, seed=3)
    variables = jax.tree.map(np.asarray, jax_pred.variables)
    cfg = _cfg(request.param)
    pool = FrameStreamPool(cfg, variables=variables, n_streams=3, frame_batch=8, device="cpu")
    offline = FramePredictor(cfg, variables=variables, max_batch=4, frame_batch=16,
                             bucket_seconds=0.5, device="cpu")
    jax_pool = JaxFrameStreamPool(jax_pred.config, variables=jax_pred.variables, n_streams=3,
                                  frame_batch=8)
    return jax_pool, pool, offline


def _interleave(pool, clips, one_hot, template, packet):
    slots = [pool.open_stream(one_hot[i], template) for i in range(len(clips))]
    got = [[] for _ in clips]
    cursors = [0] * len(clips)
    rr = 0
    while any(cursors[i] < len(c) for i, c in enumerate(clips)):
        i = rr % len(clips)
        rr += 1
        if cursors[i] >= len(clips[i]):
            continue
        chunk = clips[i][cursors[i] : cursors[i] + packet[i]]
        cursors[i] += packet[i]
        got[i].append(pool.push(slots[i], chunk, last=cursors[i] >= len(clips[i])))
    for i, s in enumerate(slots):
        got[i].append(pool.poll(s))
        pool.close_stream(s)
    return [np.concatenate(g) for g in got]


def test_interleaved_streams_match_jax_and_offline(stack):
    """Three streams in ragged interleaved packets, tails off the frame
    batch: each equals the JAX pool's stream and the offline prediction."""
    jax_pool, pool, offline = stack
    rng = np.random.default_rng(0)
    clips = [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32) for s in (0.5, 0.2, 0.35)]
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    packet = [3001, 1203, 7777]
    got = _interleave(pool, clips, one_hot, template, packet)
    want_jax = _interleave(jax_pool, clips, one_hot, template, packet)
    want = offline(clips, one_hot, template)
    for i in range(3):
        assert got[i].shape == want[i].shape == (len(clips[i]) * FPS // SR, N_VERTS // 3, 3)
        np.testing.assert_allclose(got[i], want_jax[i], atol=1e-6, rtol=0, err_msg=f"jax {i}")
        np.testing.assert_allclose(got[i], want[i], atol=1e-6, rtol=0, err_msg=f"offline {i}")


def test_slot_lifecycle_and_small_pushes(stack):
    """Pushes shorter than a frame batch buffer until one is ready; a full
    pool raises; a closed slot is reused; pushing after the flush raises."""
    _, pool, offline = stack
    rng = np.random.default_rng(1)
    clip = (rng.normal(size=int(0.3 * SR)) * 0.1).astype(np.float32)
    template = np.zeros((N_VERTS // 3, 3), np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[2]]
    slots = [pool.open_stream(one_hot[0], template) for _ in range(3)]
    with pytest.raises(RuntimeError, match="busy"):
        pool.open_stream(one_hot[0], template)
    assert pool.push(slots[0], clip[:500]).shape[0] == 0
    pool.close_stream(slots[1])
    again = pool.open_stream(one_hot[0], template)
    assert again == slots[1]
    got = [pool.push(slots[0], clip[500:]), pool.flush(slots[0])]
    got = np.concatenate(got)
    np.testing.assert_allclose(got, offline([clip], one_hot, template)[0], atol=1e-6, rtol=0)
    with pytest.raises(RuntimeError, match="flushed"):
        pool.push(slots[0], clip[:10])
    for s in (slots[0], again, slots[2]):
        pool.close_stream(s)
    # on a one-rank mesh the slot-sharded pool decodes the same
    meshed = FrameStreamPool(pool.config, state_dict=pool._base.model.state_dict(), n_streams=2,
                             frame_batch=8, device="cpu", mesh=make_mesh((1, 1)))
    s = meshed.open_stream(one_hot[0], template)
    got = np.concatenate([meshed.push(s, clip[:500]), meshed.push(s, clip[500:]), meshed.flush(s)])
    np.testing.assert_allclose(got, offline([clip], one_hot, template)[0], atol=1e-6, rtol=0)


def test_streaming_server_fronts_frame_pool(stack):
    _, pool, offline = stack
    rng = np.random.default_rng(2)
    clip = (rng.normal(size=int(0.3 * SR)) * 0.1).astype(np.float32)
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    server = StreamingServer(pool=pool)
    assert (server.sample_rate, server.fps, server.n_streams) == (SR, 60, 3)
    sess = server.open_session(np.eye(12, dtype=np.float32)[5], template)
    got = [sess.push(clip[i : i + 4000]) for i in range(0, len(clip), 4000)]
    got += [sess.flush(), sess.poll()]
    sess.close()
    want = offline([clip], np.eye(12, dtype=np.float32)[[5]], template)[0]
    np.testing.assert_allclose(np.concatenate(got), want, atol=1e-6, rtol=0)


def test_pool_forward_is_the_predictors_frame_step(stack):
    """The pool's batched forward is ``FramePredictor``'s frame step on the
    windows cut on the host at each frame's exact start: bit-equal."""
    _, pool, _ = stack
    rng = np.random.default_rng(8)
    windows = (rng.normal(size=(pool.n_streams, pool.span)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[: pool.n_streams]
    template = (rng.normal(size=(pool.n_streams, N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    f0 = np.asarray([0, 23, 1001], np.int64)
    window = 2 * pool.n_pad
    frags = np.stack([windows[i, s : s + window] for i in range(pool.n_streams)
                      for s in ((f0[i] + j) * SR // FPS - f0[i] * SR // FPS
                                for j in range(pool.fb))])
    base = pool._base
    want = base.frame_vertices(torch.as_tensor(frags), *base.style_rows(one_hot, template))
    got = pool.forward(windows, one_hot, template, f0)
    assert got.shape == (pool.n_streams, pool.fb, N_VERTS // 3, 3)
    assert got.numpy().tobytes() == want.numpy().tobytes()


def test_window_gather_depends_only_on_f0_mod_fps(stack):
    """The gather's offsets are exact in int64 and a function of f0 % 60 only:
    equal windows at f0 and f0 + k * 60 (past the int32 wrap of f0 * sr)
    decode equal vertices."""
    _, pool, _ = stack
    f0 = torch.tensor([0, 17, 59, 123_456_789], dtype=torch.int64)
    rel = window_offsets(f0, pool.fb, SR)
    j = torch.arange(pool.fb)
    naive = (f0[:, None] + j) * SR // FPS - (f0 * SR // FPS)[:, None]
    assert rel.dtype == torch.int64
    assert torch.equal(rel, naive)
    rng = np.random.default_rng(7)
    windows = (rng.normal(size=(pool.n_streams, pool.span)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[: pool.n_streams]
    template = (rng.normal(size=(pool.n_streams, N_VERTS // 3, 3)) * 0.01).astype(np.float32)
    base = np.asarray([17, 3, 59], np.int64)
    huge = (2**31 // SR // 60 + 7) * 60
    small = pool.forward(windows, one_hot, template, base)
    big = pool.forward(windows, one_hot, template, base + huge)
    np.testing.assert_array_equal(big.numpy(), small.numpy())

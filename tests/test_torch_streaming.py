"""The port's streaming FaceFormer (CPU, f32) against the JAX package's:
``decode_step_attention`` and the shared decoder step, then
``StreamingFaceFormerPredictor`` on carried weights, single-window and
chunked, at max per-vertex L2 < 1e-4 (BASELINE.md's conversion bar); and the
stream's contracts (flush frame count, push granularity, latency, capacity).
A 300-wide head on the full-width wav2vec2 encoder, as
tests/test_streaming.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.decoder_step import make_decoder_step as jax_make_decoder_step
from audio2face_tpu.ops.attention import decode_step_attention as jax_decode_step_attention
from audio2face_tpu.streaming import StreamingFaceFormerPredictor as JaxStreaming
from audio2face_tpu_torch.compat.jax_params import faceformer_jax_tree_from_state_dict
from audio2face_tpu_torch.models.decoder_step import (
    decoder_step_params,
    make_decoder_step,
    run_decoder_steps,
)
from audio2face_tpu_torch.models.faceformer import FaceFormer, frame_count
from audio2face_tpu_torch.ops.attention import decode_step_attention
from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

torch.set_num_threads(1)

SR = 16000
N_VERTS = 300
VERTEX_L2_BAR = 1e-4


@pytest.fixture(scope="module")
def setup():
    """Random weights from the port's seeded init (its head moved off the
    zero-init motion maps so that outputs carry signal), as the port's state
    and as the JAX parameter tree."""
    model = FaceFormer(n_verts=N_VERTS, n_onehot=12)
    model.init_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    state = {k: v if k.startswith("audio_encoder.") else v + 0.01 * torch.randn(v.shape, generator=gen)
             for k, v in model.state_dict().items()}
    params = {"params": faceformer_jax_tree_from_state_dict(state)}
    variables = {"params": jax.tree.map(jnp.asarray, params["params"])}
    rng = np.random.default_rng(0)
    n = int(1.6 * SR)  # a multiple of 800: frame-exact chunk boundaries
    audio = (rng.normal(size=(1, n)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[3]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    return variables, params, audio, one_hot, template


CHUNKED = dict(chunk_seconds=0.4, left_seconds=0.4, lookahead_seconds=0.2)


@pytest.fixture(scope="module")
def jax_chunked(setup):
    """One JAX stream of the chunked windows for the tests that use them, so
    that its programs compile once."""
    return JaxStreaming(setup[0], N_VERTS, **CHUNKED)


def _max_l2(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b, axis=-1).max())


def _stream(pred, one_hot, template, clip, step):
    pred.start_stream(one_hot, template)
    outs = [pred.push(clip[i : i + step]) for i in range(0, len(clip), step)]
    outs.append(pred.flush())
    return np.concatenate([o for o in outs if o.size])


@pytest.mark.parametrize("per_item", [False, True])
def test_decode_step_attention_matches_jax(per_item):
    rng = np.random.default_rng(4)
    b, h, t_max, d = 3, 4, 150, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, h, t_max, d)).astype(np.float32)
    v = rng.normal(size=(b, h, t_max, d)).astype(np.float32)
    step = np.asarray([0, 61, 149], np.int32) if per_item else np.int32(97)
    got = decode_step_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                torch.tensor(step, dtype=torch.int64), alibi_period=60)
    want = jax_decode_step_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(step), alibi_period=60)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # rows past each step are masked: changing them changes nothing
    k2 = k.copy()
    if per_item:
        k2[0, :, 1:] = 7.0
        k2[1, :, 62:] = 7.0
    else:
        k2[:, :, 98:] = 7.0
    again = decode_step_attention(torch.tensor(q), torch.tensor(k2), torch.tensor(v),
                                  torch.tensor(step, dtype=torch.int64), alibi_period=60)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_decoder_step_with_masking_matches_jax_scan(setup):
    """Per-item start frames, ``n_valid`` masking into the scratch row and the
    frozen carry, against JAX's step under ``lax.scan``."""
    _, params, _, _, _ = setup
    port = StreamingFaceFormerPredictor(params, N_VERTS, device="cpu")
    p = port._p
    jp = {k: jnp.asarray(v) for k, v in params["params"].items() if k != "audio_encoder"}
    rng = np.random.default_rng(5)
    s, n_frames, t_max = 3, 7, 40
    styles = rng.normal(size=(s, 64)).astype(np.float32)
    emb0 = rng.normal(size=(s, 64)).astype(np.float32)
    cross = rng.normal(size=(s, n_frames, 64)).astype(np.float32)
    t0 = np.asarray([0, 5, 20], np.int64)
    n_valid = np.asarray([7, 3, 0], np.int64)
    kc = rng.normal(size=(s, 4, t_max + 1, 16)).astype(np.float32) * 0.1
    vc = rng.normal(size=(s, 4, t_max + 1, 16)).astype(np.float32) * 0.1

    step = jax_make_decoder_step(jp, styles=jnp.asarray(styles), t0=jnp.asarray(t0, jnp.int32),
                                 n_valid=jnp.asarray(n_valid, jnp.int32), t_scratch=t_max)
    (j_emb, j_k, j_v), j_hs = jax.lax.scan(
        step, (jnp.asarray(emb0), jnp.asarray(kc), jnp.asarray(vc)),
        (jnp.arange(n_frames), jnp.swapaxes(jnp.asarray(cross), 0, 1)))
    with torch.inference_mode():
        step = make_decoder_step(p, styles=torch.tensor(styles), t0=torch.tensor(t0),
                                 n_valid=torch.tensor(n_valid), t_scratch=t_max)
        (emb, k, v), hs = run_decoder_steps(
            step, (torch.tensor(emb0), torch.tensor(kc), torch.tensor(vc)), torch.tensor(cross))
    np.testing.assert_allclose(hs.numpy(), np.swapaxes(np.asarray(j_hs), 0, 1), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(j_k), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(j_v), atol=2e-5, rtol=1e-5)
    # the idle stream kept its carry bit for bit
    np.testing.assert_array_equal(emb.numpy()[2], emb0[2])
    with pytest.raises(ValueError, match="t_scratch"):
        make_decoder_step(p, styles=torch.tensor(styles), t0=torch.tensor(t0),
                          n_valid=torch.tensor(n_valid))


@pytest.mark.parametrize("windows", ["single", "chunked"])
def test_streaming_matches_jax(setup, jax_chunked, windows):
    """One window over the whole grain-aligned clip (the offline encoder
    output), and 0.4 s chunks with 0.4 s of left context and 0.2 s of
    lookahead pushed in 3,000-sample packets, through the flush."""
    variables, params, audio, one_hot, template = setup
    if windows == "single":
        kw = dict(chunk_seconds=1.6, left_seconds=0.0, lookahead_seconds=0.0)
        jax_stream = JaxStreaming(variables, N_VERTS, **kw)
    else:
        kw, jax_stream = CHUNKED, jax_chunked
    want = _stream(jax_stream, one_hot, template, audio[0], 3000)
    got = _stream(StreamingFaceFormerPredictor(params, N_VERTS, device="cpu", **kw),
                  one_hot, template, audio[0], 3000)
    assert got.shape == (frame_count(audio.shape[1]), N_VERTS // 3, 3)
    assert _max_l2(got, want) < VERTEX_L2_BAR
    assert np.abs(got - template).max() > 1e-3  # the outputs carry signal


def test_flush_frame_count_granularity_and_latency(setup, jax_chunked):
    """A tail off the 800-sample grain still streams out frame_count(n)
    frames, equal to JAX's (whose flush pads the tail window to the grain);
    100 ms packets give the same frames bit for bit as one push; the first
    chunk comes out once chunk + lookahead samples are in; pushing after the
    flush raises."""
    _, params, audio, one_hot, template = setup
    pred = StreamingFaceFormerPredictor(params, N_VERTS, device="cpu", **CHUNKED)
    n = audio.shape[1] - 480
    small = _stream(pred, one_hot, template, audio[0, :n], int(0.1 * SR))
    big = _stream(pred, one_hot, template, audio[0, :n], n)
    assert small.shape[0] == frame_count(n)
    np.testing.assert_array_equal(small, big)
    want = _stream(jax_chunked, one_hot, template, audio[0, :n], n)
    assert _max_l2(small, want) < VERTEX_L2_BAR
    with pytest.raises(RuntimeError, match="flushed"):
        pred.push(audio[0, :800])

    pred.start_stream(one_hot, template)
    first = pred.push(audio[0, : pred.chunk + pred.lookahead])
    assert first.shape[0] == frame_count(pred.chunk)
    assert pred.push(audio[0, pred.chunk + pred.lookahead :][:400]).shape[0] == 0


def test_capacity_and_biwi_weights_raise(setup):
    _, params, audio, one_hot, template = setup
    pred = StreamingFaceFormerPredictor(params, N_VERTS, chunk_seconds=0.5, left_seconds=0.5,
                                        lookahead_seconds=0.0, max_seconds=1.0, device="cpu")
    pred.start_stream(one_hot, template)
    with pytest.raises(RuntimeError, match="max_seconds"):
        for i in range(0, audio.shape[1], 8000):
            pred.push(audio[0, i : i + 8000])
    biwi = {"params": dict(params["params"], cross_q_kernel=np.zeros((64, 64), np.float32))}
    with pytest.raises(ValueError, match="BIWI"):
        StreamingFaceFormerPredictor(biwi, N_VERTS, device="cpu")
    with pytest.raises(RuntimeError, match="start_stream"):
        StreamingFaceFormerPredictor(params, N_VERTS, device="cpu").push(audio[0, :800])


def test_decoder_step_params_are_the_model_weights(setup):
    _, params, _, _, _ = setup
    pred = StreamingFaceFormerPredictor(params, N_VERTS, device="cpu")
    p = decoder_step_params(pred.model)
    for name in ("dec_q_kernel", "linear2_bias", "norm3_scale", "vertice_map_r_kernel"):
        np.testing.assert_array_equal(p[name].numpy(), params["params"][name])

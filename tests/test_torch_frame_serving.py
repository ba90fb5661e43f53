"""The port's FramePredictor (CPU, f32) against the JAX FramePredictor with
carried variables: audio -> vertices for Audio2Mesh, VOCA and Song2Face
through the MFCC extractor, ragged clips that are no multiple of the bucket,
per-clip max per-vertex L2 in data units.

Bar: 1e-4 per-vertex L2 (BASELINE.md's conversion bar) on the outputs in
data units, which carry the MFCC front end's error (2.4e-4 of the feature
scale against JAX; tests/test_torch_dsp.py). The readings here are ~1e-7:
the /100 unit convention scales the model's deviation down."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.config import ExpConfig as JaxExpConfig
from audio2face_tpu.data.vocaset import batch_audio_fragments
from audio2face_tpu.serving import FramePredictor as JaxFramePredictor
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.parallel import make_mesh
from audio2face_tpu_torch.serving import FramePredictor

torch.set_num_threads(1)

SR = 22000
N_VERTS = 300
VERTEX_L2_BAR = 1e-4
KW = dict(max_batch=4, frame_batch=16, bucket_seconds=0.5)


def _cfg(modelname, cls=ExpConfig, **over):
    base = dict(batch_size=8, modelname=modelname, vertex_count=N_VERTS, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=SR, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=1e-3)
    if modelname == "voca":
        base.update(n_feature=16, out_dim=29, win_length=790)
    base.update(over)
    return cls(**base)


def _max_l2(a, b):
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b, axis=-1).max())


def _clips(rng, seconds, sr=SR):
    return [(rng.normal(size=int(s * sr)) * 0.1).astype(np.float32) for s in seconds]


@pytest.fixture(scope="module", params=["audio2mesh", "voca", "song2face"])
def predictors(request):
    name = request.param
    ref = JaxFramePredictor(_cfg(name, JaxExpConfig), seed=3, **KW)
    variables = jax.tree.map(np.asarray, ref.variables)
    rng = np.random.default_rng(9)
    if "batch_stats" in variables:  # trained-like running statistics
        variables = dict(variables, batch_stats=jax.tree.map(
            lambda a: (np.abs(rng.normal(size=a.shape)) + 0.5).astype(np.float32),
            variables["batch_stats"]))
        ref = JaxFramePredictor(_cfg(name, JaxExpConfig), variables=jax.tree.map(jnp.asarray, variables), **KW)
    port = FramePredictor(_cfg(name), variables=variables, device="cpu", **KW)
    return ref, port


def test_ragged_clips_match_jax(predictors):
    """Clip lengths across bucket and frame-chunk boundaries, none a whole
    bucket; a batch padded from 3 clips to the grid's 4."""
    ref, port = predictors
    rng = np.random.default_rng(0)
    audios = _clips(rng, (0.31, 0.74, 0.52))
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    want = ref(audios, one_hot, template)
    got = port(audios, one_hot, template)
    for a, w, g in zip(audios, want, got):
        assert g.shape == (len(a) * 60 // SR, N_VERTS // 3, 3)
        assert _max_l2(g, w) < VERTEX_L2_BAR
        assert np.abs(g - template).max() > 1e-3  # the model moves the vertices


def test_matches_the_host_fragmenter_forward(predictors):
    """The on-device gather equals the dataset's host fragmenter followed
    by the predictor's own extractor and model on one whole-clip batch."""
    _, port = predictors
    rng = np.random.default_rng(1)
    clip = _clips(rng, (0.4,))[0]
    one_hot = np.eye(12, dtype=np.float32)[[5]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    t = len(clip) * 60 // SR
    frags = torch.tensor(batch_audio_fragments(clip, np.arange(t), sample_rate=SR))
    with torch.no_grad():
        want = port.model(port.extractor(frags), torch.tensor(one_hot).expand(t, 12),
                          torch.tensor(template * 100.0).expand(t, -1, -1)).numpy() / 100.0
    got = port([clip], one_hot, template)[0]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_window_starts_past_the_int32_wrap_match_jax():
    """A chunk at frame 100,003 of a 28-minute clip: the starts come from
    the decomposition ``(f // fps) * sr + (f % fps) * sr // fps`` (the naive
    int32 product wraps past frame ~97,600) and the windows equal the clip's
    slices at f * sr // fps (exact integers) and JAX's chunk."""
    cfg = _cfg("voca")
    f0, fb = 100_003, 4
    ref = JaxFramePredictor(_cfg("voca", JaxExpConfig), max_batch=1, frame_batch=fb, bucket_seconds=1.0)
    port = FramePredictor(cfg, variables=jax.tree.map(np.asarray, ref.variables), max_batch=1,
                          frame_batch=fb, bucket_seconds=1.0, device="cpu")
    n = (f0 + fb) * SR // 60 + SR
    clip = np.random.default_rng(2).normal(size=n).astype(np.float32) * 0.1
    template = np.zeros((1, N_VERTS // 3, 3), np.float32)
    inputs = port.prepare([clip], np.eye(12, dtype=np.float32)[[2]], template)
    got = port.forward_chunk(*inputs, f0)[0].numpy()
    starts = [(f0 + j) * SR // 60 for j in range(fb)]  # python ints: exact
    frags = torch.tensor(np.stack([np.pad(clip, (port.n_pad, 0))[s : s + port.window] for s in starts]))
    with torch.no_grad():
        want = port.model(port.extractor(frags), torch.eye(12)[[2] * fb],
                          torch.zeros(fb, N_VERTS // 3, 3)).numpy() / 100.0
    np.testing.assert_allclose(got, want, atol=1e-6)
    samples = inputs[0].shape[1] - port.n_pad - port.window  # the bucket
    audio = np.zeros((1, samples), np.float32)
    audio[0, :n] = clip
    fn = ref._get_fn(1, samples)
    jax_out = np.asarray(fn(ref.variables, {}, jnp.asarray(audio), jnp.asarray(np.eye(12, dtype=np.float32)[[2]]),
                            jnp.asarray(template), jnp.int32(f0)))[0]
    assert _max_l2(got, jax_out) < VERTEX_L2_BAR


def test_resampling_validation_and_warmup():
    cfg = _cfg("voca")
    ref = JaxFramePredictor(_cfg("voca", JaxExpConfig), frame_batch=16, bucket_seconds=0.3)
    port = FramePredictor(cfg, variables=jax.tree.map(np.asarray, ref.variables), frame_batch=16,
                          bucket_seconds=0.3, device="cpu")
    rng = np.random.default_rng(4)
    a16 = (rng.normal(size=8000) * 0.1).astype(np.float32)
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    one = np.eye(12, dtype=np.float32)[[0]]
    got = port([a16], one, template, sample_rate=16000)[0]
    assert got.shape[0] == (8000 * SR // 16000) * 60 // SR
    assert _max_l2(got, ref([a16], one, template, sample_rate=16000)[0]) < VERTEX_L2_BAR
    with pytest.raises(ValueError, match="one_hot"):
        port([a16], np.eye(12, dtype=np.float32)[[0, 1]], template)
    with pytest.raises(ValueError, match="faceformer"):
        FramePredictor(_cfg("faceformer", split_frame=False, batch_size=1), device="cpu")
    # on a one-rank mesh (shard_map_data, the gather) it decodes the same
    meshed = FramePredictor(cfg, variables=jax.tree.map(np.asarray, ref.variables),
                            frame_batch=16, bucket_seconds=0.3, device="cpu",
                            mesh=make_mesh((1, 1)))
    np.testing.assert_array_equal(meshed([a16], one, template, sample_rate=16000)[0], got)
    assert port.warmup(0.5, batches=[1, 2]) == 4


def test_bf16_predictor_runs_and_stays_near_f32():
    cfg = _cfg("audio2mesh")
    f32 = FramePredictor(cfg, device="cpu", seed=1, **KW)
    b16 = FramePredictor(cfg.model_copy(update={"percision": "16-mixed"}), device="cpu",
                         state_dict=f32.model.state_dict(), **KW)
    assert b16.model.dtype == torch.bfloat16
    rng = np.random.default_rng(5)
    audios = _clips(rng, (0.3, 0.2))
    one_hot = np.eye(12, dtype=np.float32)[[1, 2]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32) * 0.01
    for g, w in zip(b16(audios, one_hot, template), f32(audios, one_hot, template)):
        disp = np.abs(w - template).max()
        assert np.isfinite(g).all() and _max_l2(g, w) < 0.05 * disp

"""Port FaceFormerPredictor (CPU, f32) vs the JAX predictor with carried
weights: per-clip max per-vertex L2 < 1e-4 (BASELINE.md's bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.serving import FaceFormerPredictor as JaxPredictor
from audio2face_tpu_torch.serving import FaceFormerPredictor, _batch_grid, _pad_batch

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

N_VERTS = 300
KW = dict(n_verts=N_VERTS, bf16=False, max_batch=4, bucket_seconds=0.5)


@pytest.fixture(scope="module")
def predictors():
    rng = np.random.default_rng(0)
    init = JaxPredictor(decode_impl="scan", **KW)
    params = dict(jax.tree.map(np.asarray, init.variables["params"]))
    # the init zeroes the motion maps, which would make every output equal
    # the template
    for name, shape in [("vertice_map_kernel", (N_VERTS, 64)), ("vertice_map_bias", (64,)),
                        ("vertice_map_r_kernel", (64, N_VERTS)), ("vertice_map_r_bias", (N_VERTS,))]:
        params[name] = rng.normal(0, 0.05, shape).astype(np.float32)
    ref = JaxPredictor(
        variables={"params": jax.tree.map(jnp.asarray, params)}, decode_impl="scan", **KW
    )
    port = FaceFormerPredictor(variables={"params": params}, device="cpu", **KW)
    return ref, port


def _max_l2(a, b):
    assert a.shape == b.shape
    return float(np.linalg.norm(a - b, axis=-1).max())


def _clips(rng, seconds, sr=16000):
    return [(rng.normal(size=int(s * sr)) * 0.1).astype(np.float32) for s in seconds]


def test_batch_grid_matches_jax():
    from audio2face_tpu import serving as js

    for mb in (1, 3, 4, 8, 12):
        assert _batch_grid(mb) == js._batch_grid(mb)
        for b in range(1, mb + 1):
            assert _pad_batch(b, mb) == js._pad_batch(b, mb)


def test_variable_length_batch(predictors):
    ref, port = predictors
    rng = np.random.default_rng(1)
    audios = _clips(rng, (0.3, 0.7, 0.45))
    one_hot = np.eye(12, dtype=np.float32)[[0, 4, 9]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    want = ref(audios, one_hot, template)
    got = port(audios, one_hot, template)
    for a, w, g in zip(audios, want, got):
        assert g.shape == (len(a) * 60 // 16000, N_VERTS // 3, 3)
        assert _max_l2(g, w) < 1e-4


def test_batch_vs_solo(predictors):
    ref, port = predictors
    rng = np.random.default_rng(2)
    a, b = _clips(rng, (0.5, 0.25))
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    solo = port([a], np.eye(12, dtype=np.float32)[[2]], template)[0]
    batch = port([a, b], np.eye(12, dtype=np.float32)[[2, 7]], template)
    assert _max_l2(solo, ref([a], np.eye(12, dtype=np.float32)[[2]], template)[0]) < 1e-4
    want = ref([a, b], np.eye(12, dtype=np.float32)[[2, 7]], template)
    for g, w in zip(batch, want):
        assert _max_l2(g, w) < 1e-4
    # padding another clip beside a clip changes nothing on its frames
    # (tests/test_serving.py's bound)
    np.testing.assert_allclose(batch[0], solo, atol=2e-3)


def test_resampling_22050(predictors):
    ref, port = predictors
    rng = np.random.default_rng(3)
    (a,) = _clips(rng, (0.5,), sr=22050)
    one_hot = np.eye(12, dtype=np.float32)[[0]]
    template = rng.normal(size=(N_VERTS // 3, 3)).astype(np.float32)
    got = port([a], one_hot, template, sample_rate=22050)[0]
    want = ref([a], one_hot, template, sample_rate=22050)[0]
    assert got.shape[0] == (len(a) * 16000 // 22050 + 1) * 60 // 16000
    assert _max_l2(got, want) < 1e-4


def test_warmup_and_realtime_factor(predictors):
    _, port = predictors
    assert port.warmup(max_seconds=0.5, batches=[1, 2]) == 2
    assert port.realtime_factor(seconds=0.25, batch=1) > 0.0

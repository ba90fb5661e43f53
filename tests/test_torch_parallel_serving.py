"""The port's predictors on a mesh (``mesh=``) on four spawned gloo ranks on
the CPU, each against its solo run on the same weights and inputs (atol
2e-5, rtol 1e-5, the bar of tests/test_sequence_parallel.py's predictor
test): ``FaceFormerPredictor`` (3 clips padded to the 4-row mesh,
``max_batch`` rounded down to the axis), ``FramePredictor``, and the
slot-sharded ``MultiStreamFaceFormerPredictor`` and ``FrameStreamPool``
(one slot a rank, interleaved pushes); and, with no spawn, the mesh-aligned
batch grid and ``_fit_max_batch`` against the JAX package's."""

import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from audio2face_tpu import serving as jax_serving
from audio2face_tpu_torch import serving
from torch_gloo import run_ranks

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(3)
    data = {
        "clips": [(rng.normal(size=int(s * 16000)) * 0.1).astype(np.float32)
                  for s in (0.5, 0.35, 0.8)],
        "frame_clips": [(rng.normal(size=int(s * 22000)) * 0.1).astype(np.float32)
                        for s in (0.6, 0.3, 0.45)],
        "one_hot": np.eye(12, dtype=np.float32)[[0, 5, 7, 2]],
        "template": (rng.normal(size=(50, 3)) * 0.01).astype(np.float32),
        "frame_template": (rng.normal(size=(100, 3)) * 0.01).astype(np.float32),
        "pool_clips": [(rng.normal(size=int(s * 16000)) * 0.1).astype(np.float32)
                       for s in (0.8, 1.2, 0.4, 0.9)],
        "pool_template": (rng.normal(size=(100, 3)) * 0.01).astype(np.float32),
        "pool_kw": dict(chunk_seconds=0.4, left_seconds=0.4, lookahead_seconds=0.0,
                        max_seconds=4.0),
    }
    return run_ranks(4, cases.serving_cases, (data,), tmp_path_factory.mktemp("gloo"))


def _assert_clips_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def test_faceformer_predictor_mesh_matches_solo(results):
    for r in results:
        assert r["ff_max_batch"] == 4  # 6 rounded down to the 4-way axis
        assert r["ff_collectives"]["all_gather"] > 0
        _assert_clips_equal(r["ff_mesh"], results[0]["ff_solo"])


def test_frame_predictor_mesh_matches_solo(results):
    for r in results:
        _assert_clips_equal(r["frame_mesh"], results[0]["frame_solo"])


@pytest.mark.parametrize("pool", ["pool", "frame_pool"])
def test_slot_sharded_pool_matches_solo_pool(results, pool):
    for r in results:
        _assert_clips_equal(r[f"{pool}_mesh"], results[0][f"{pool}_solo"])


def test_batch_grid_and_max_batch_fit_match_jax():
    for max_batch, n_data in ((8, 1), (8, 2), (8, 4), (6, 3), (12, 4), (16, 8)):
        assert serving._batch_grid(max_batch, n_data) == jax_serving._batch_grid(max_batch, n_data)
        for b in range(1, max_batch + 1):
            assert serving._pad_batch(b, max_batch, n_data) == jax_serving._pad_batch(
                b, max_batch, n_data)
    with pytest.warns(UserWarning, match="rounding down"):
        assert serving._fit_max_batch(6, 4) == 4
    assert serving._fit_max_batch(8, 4) == 8
    with pytest.raises(ValueError, match="smaller than the mesh data axis"):
        serving._fit_max_batch(2, 4)

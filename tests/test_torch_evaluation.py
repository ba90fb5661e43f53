"""The port's evaluation metrics (LVE / FDD / MVE / max-L2) against the JAX
package's on the same seeded inputs, the geometric region stand-in, and
``Audio2FaceExperiment.evaluate`` against the JAX experiment's on a tiny
synthetic VOCASET with carried weights, frame model and FaceFormer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu import evaluation as jax_eval
from audio2face_tpu.config import ExpConfig as JaxExpConfig
from audio2face_tpu.data.vocaset import VocaDataModule as JaxVocaDataModule
from audio2face_tpu.parallel.mesh import make_mesh
from audio2face_tpu.training.trainer import Audio2FaceExperiment as JaxExperiment
from audio2face_tpu_torch import evaluation
from audio2face_tpu_torch.compat.jax_params import (
    faceformer_state_dict_from_jax,
    frame_model_state_dict_from_jax,
)
from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.data.synthetic import generate_synthetic_vocaset
from audio2face_tpu_torch.data.vocaset import VocaDataModule
from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

torch.set_num_threads(1)

T, V = 7, 40
RTOL, ATOL = 1e-5, 1e-7  # f32, another summation order
EVAL_RTOL = 1e-4  # whole models in f32 against JAX, then the metrics


@pytest.fixture
def anim():
    rng = np.random.default_rng(0)
    template = rng.normal(size=(V, 3)).astype(np.float32)
    gt = template[None] + 0.05 * rng.normal(size=(T, V, 3)).astype(np.float32)
    pred = gt + 0.01 * rng.normal(size=(T, V, 3)).astype(np.float32)
    regions = evaluation.VertexRegions(lip=np.arange(0, 10), upper=np.arange(25, 40))
    return pred, gt, template, regions


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


def _jax_regions(regions):
    return jax_eval.VertexRegions(lip=regions.lip, upper=regions.upper)


@pytest.mark.parametrize("metric", ["lve", "fdd", "mve", "max_l2"])
def test_metric_matches_jax(anim, metric):
    pred, gt, template, regions = anim
    mask = np.asarray([1, 1, 1, 1, 1, 0, 0], np.float32)
    for frame_mask in (None, mask):
        fm = None if frame_mask is None else torch.as_tensor(frame_mask)
        if metric == "lve":
            got = evaluation.lip_vertex_error(torch.as_tensor(pred), gt, regions.lip, fm)
            want = jax_eval.lip_vertex_error(pred, gt, regions.lip, frame_mask)
        elif metric == "fdd":
            got = evaluation.upper_face_dynamics_deviation(
                torch.as_tensor(pred), gt, template, regions.upper, fm)
            want = jax_eval.upper_face_dynamics_deviation(
                jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(template), regions.upper,
                None if frame_mask is None else jnp.asarray(frame_mask))
        elif metric == "mve":
            got = evaluation.mean_vertex_error(pred, gt, fm)
            want = jax_eval.mean_vertex_error(pred, gt, frame_mask)
        else:
            got = evaluation.max_vertex_l2(pred, gt, fm)
            want = jax_eval.max_vertex_l2(pred, gt, frame_mask)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.ndim == 0
        _close(got, want)


def test_fdd_uses_the_population_std(anim):
    """torch.std defaults to Bessel's correction; jnp.std and FDD do not."""
    pred, gt, template, regions = anim
    ids = regions.upper

    def dyn(z):
        d2 = np.sum((z[:, ids] - template[None, ids]) ** 2, axis=-1)
        return np.std(d2, axis=0)

    want = np.mean(dyn(pred.astype(np.float64)) - dyn(gt.astype(np.float64)))
    got = evaluation.upper_face_dynamics_deviation(pred, gt, template, ids)
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)


def test_fdd_sign_convention(anim):
    _, gt, template, regions = anim
    amplified = template[None] + 2.5 * (gt - template[None])
    frozen = np.broadcast_to(template[None], gt.shape)
    for z, sign in ((amplified, 1.0), (frozen, -1.0)):
        got = float(evaluation.upper_face_dynamics_deviation(z, gt, template, regions.upper))
        assert np.sign(got) == sign
        _close(got, jax_eval.upper_face_dynamics_deviation(z, gt, template, regions.upper))


def test_frame_mask_ignores_padding(anim):
    """Metrics over a padded animation equal the valid prefix's, and JAX's
    on the padded arrays."""
    pred, gt, template, regions = anim
    pad = np.random.default_rng(1).normal(size=(3, V, 3)).astype(np.float32)
    pred_p = np.concatenate([pred, pad], axis=0)
    gt_p = np.concatenate([gt, np.zeros_like(pad)], axis=0)
    mask = np.concatenate([np.ones(T), np.zeros(3)]).astype(np.float32)
    full = evaluation.evaluate_animation(pred, gt, template, regions)
    padded = evaluation.evaluate_animation(pred_p, gt_p, template, regions, frame_mask=mask)
    want = jax_eval.evaluate_animation(pred_p, gt_p, template, _jax_regions(regions), frame_mask=mask)
    assert set(padded) == set(want) == {"lve", "fdd", "mve", "max_l2"}
    for k in want:
        assert isinstance(padded[k], float)
        np.testing.assert_allclose(padded[k], full[k], rtol=RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(padded[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_batched_equals_flat_and_clip_mode_broadcasts_the_template(anim):
    """(B, T, V, 3) with identical items equals the single item; a (B, 1, V,
    3) template (the trainer's clip mode) equals a (B, V, 3) one; both equal
    JAX's."""
    pred, gt, template, regions = anim
    predb, gtb, tb = np.stack([pred, pred]), np.stack([gt, gt]), np.stack([template, template])
    mask = np.ones((2, T), np.float32)
    flat = evaluation.evaluate_animation(pred, gt, template, regions)
    batched = evaluation.evaluate_animation(predb, gtb, tb, regions)
    clip = evaluation.evaluate_animation(predb, gtb, tb[:, None], regions, frame_mask=mask)
    want = jax_eval.evaluate_animation(predb, gtb, tb[:, None], _jax_regions(regions), frame_mask=mask)
    for k in flat:
        np.testing.assert_allclose(batched[k], flat[k], rtol=RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(clip[k], flat[k], rtol=RTOL, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(clip[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_max_l2_multiplies_by_the_mask():
    """Masked frames count as distance 0, as JAX's product does."""
    gt = np.zeros((2, 3, 3), np.float32)
    pred = gt.copy()
    pred[1, 0] = [3.0, 4.0, 0.0]  # 5 in the masked frame
    pred[0, 2] = [0.0, 0.0, 2.0]
    mask = np.asarray([1.0, 0.0], np.float32)
    assert float(evaluation.max_vertex_l2(pred, gt, mask)) == 2.0
    assert float(jax_eval.max_vertex_l2(pred, gt, mask)) == 2.0


def test_metrics_mix_tensors_and_arrays(anim):
    pred, gt, template, regions = anim
    want = evaluation.evaluate_animation(pred, gt, template, regions)
    got = evaluation.evaluate_animation(torch.as_tensor(pred), gt, torch.as_tensor(template),
                                        frame_mask=torch.ones(T))
    mixed = evaluation.animation_metrics(torch.as_tensor(pred, dtype=torch.float64), gt, template,
                                         regions, np.ones(T))
    assert mixed.dtype == torch.float32 and mixed.shape == (4,)
    np.testing.assert_allclose(mixed.numpy(), [want[k] for k in evaluation.METRICS], rtol=RTOL)
    assert set(got) == set(want)


@pytest.mark.parametrize("case", ["cloud", "head", "flat_z", "tiny"])
def test_infer_regions_equals_jax(case):
    rng = np.random.default_rng(2)
    if case == "cloud":
        pts = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    elif case == "head":
        pts = (rng.normal(0.0, 0.01, (5023, 3)) + [0.0, 0.0, 0.05]).astype(np.float64)
    elif case == "flat_z":  # degenerate: no vertex is in front, the lip box is empty
        pts = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
        pts[:, 2] = 0.3
    else:
        pts = np.asarray([[0, 0, 0], [1, 1, 1], [0, 1, 0]], np.float32)
    got, want = evaluation.infer_regions(pts), jax_eval.infer_regions(pts)
    assert got.lip.dtype == want.lip.dtype == np.int32
    np.testing.assert_array_equal(got.lip, want.lip)
    np.testing.assert_array_equal(got.upper, want.upper)
    if case == "cloud":
        u = (pts - pts.min(0)) / (pts.max(0) - pts.min(0))
        assert np.all(u[got.lip, 1] < 0.45) and np.all(u[got.upper, 1] > 0.60)


def test_regions_validate_and_inferred_regions_score(anim):
    with pytest.raises(ValueError):
        evaluation.VertexRegions(lip=np.array([], np.int32), upper=np.arange(3))
    pred, gt, template, _ = anim
    got = evaluation.evaluate_animation(pred, gt, template)
    want = jax_eval.evaluate_animation(pred, gt, template)
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# Audio2FaceExperiment.evaluate against the JAX experiment's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vocaset(tmp_path_factory):
    """12 subjects, 0.6 s sentences (one in the training range, the rest in
    the validation range); 60 vertices."""
    return generate_synthetic_vocaset(str(tmp_path_factory.mktemp("voca")), n_verts=60,
                                      sentences_per_subject=1, seconds_per_sentence=0.6)


def _cfg_kw(modelname):
    if modelname == "faceformer":
        return dict(batch_size=1, modelname="faceformer", vertex_count=180, one_hot_size=12,
                    feature_extractor=None, sample_rate=16000, split_frame=False, n_feature=32,
                    out_dim=52, win_length=440, percision="32", lr=1e-4)
    return dict(batch_size=16, modelname="audio2mesh", vertex_count=180, one_hot_size=12,
                feature_extractor="mfcc", sample_rate=22000, split_frame=True, n_feature=32,
                out_dim=52, win_length=440, percision="32", lr=3e-3)


@pytest.mark.parametrize("modelname", ["audio2mesh", "faceformer"])
def test_experiment_evaluate_matches_jax(vocaset, modelname, tmp_path):
    """The same weights (the JAX experiment's init, output layers
    randomized, carried through ``compat/jax_params.py``) swept over the same
    test split: frame batches for Audio2Mesh, padded clips with the frame
    mask for FaceFormer."""
    kw = _cfg_kw(modelname)
    split_frame = kw["split_frame"]
    jdm = JaxVocaDataModule(vocaset, batch_size=kw["batch_size"], split_frame=split_frame)
    jdm.setup()
    jexp = JaxExperiment(JaxExpConfig(**kw), mesh=make_mesh((1, 1), devices=jax.devices()[:1]),
                         log_dir=str(tmp_path / "jax"), tensorboard=False)
    first = jdm.predict_batch(*jdm.test_dataset.datalist[0][:2])
    state = jexp.init_state(first)
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, state.params)
    if modelname == "faceformer":
        params = dict(params)
        for name in ("vertice_map_kernel", "vertice_map_bias", "vertice_map_r_kernel",
                     "vertice_map_r_bias"):
            params[name] = rng.normal(0, 0.05, params[name].shape).astype(np.float32)
        state_dict = faceformer_state_dict_from_jax(params)
    else:
        head = params["output"]["fc3"]
        head["kernel"] = rng.normal(0, 0.05, head["kernel"].shape).astype(np.float32)
        head["bias"] = rng.normal(0, 0.05, head["bias"].shape).astype(np.float32)
        batch_stats = jax.tree.map(np.asarray, state.batch_stats)
        state_dict = frame_model_state_dict_from_jax(
            modelname, {"params": params, "batch_stats": batch_stats})
    state = state.replace(params=jax.tree.map(jnp.asarray, params))
    want = jexp.evaluate(state, jdm)

    dm = VocaDataModule(vocaset, batch_size=kw["batch_size"], split_frame=split_frame)
    dm.setup()
    exp = Audio2FaceExperiment(ExpConfig(**kw), log_dir=str(tmp_path / "torch"), device="cpu")
    exp.model.load_state_dict(state_dict)
    got = exp.evaluate(dm)
    assert set(got) == set(want) == {"lve", "fdd", "mve", "max_l2", "err", "n_sentences"}
    pairs = list(dict.fromkeys((r[0], r[1]) for r in dm.test_dataset.datalist))
    assert got["n_sentences"] == want["n_sentences"] == len(pairs) > 1
    for k in ("lve", "fdd", "mve", "max_l2", "err"):
        assert isinstance(got[k], float) and np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, err_msg=k)
    assert got["mve"] > 1e-4  # the randomized head moves the vertices

    # explicit sentences, a cap and given regions
    regions = evaluation.VertexRegions(lip=np.arange(10), upper=np.arange(30, 60))
    pairs = pairs[::-1]
    some = exp.evaluate(dm, regions=regions, sentences=pairs, max_sentences=1)
    want_some = jexp.evaluate(state, jdm, regions=_jax_regions(regions), sentences=pairs,
                              max_sentences=1)
    assert some["n_sentences"] == 1
    for k in ("lve", "fdd", "mve", "max_l2", "err"):
        np.testing.assert_allclose(some[k], want_some[k], rtol=EVAL_RTOL, err_msg=k)
    with pytest.raises(ValueError, match="no sentences"):
        exp.evaluate(dm, max_sentences=0)

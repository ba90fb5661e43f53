"""The port's sequence parallelism (``parallel/sequence.py``) on four spawned
gloo ranks on the CPU, mirroring tests/test_sequence_parallel.py: the
time-sharded stack against the JAX package's unsharded encoder on the same
weights (atol 2e-5, rtol 1e-5), a T the axis does not divide (the padded
tail masked), padded batch lengths, the split-point entry point,
``gather_output``, attention with T/n local queries against all T keys,
and ``FaceFormerPredictor(sp_mesh=)`` against the solo predictor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu_torch.compat.jax_params import wav2vec2_state_dict_from_jax
from audio2face_tpu_torch.serving import FaceFormerPredictor
from torch_gloo import run_ranks

torch.set_num_threads(1)

CFG = dict(
    conv_dim=(48, 48), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=48, num_layers=3,
    num_heads=4, intermediate_size=96, pos_conv_kernel=16, pos_conv_groups=4,
)
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(1, 4000)) * 0.1).astype(np.float32)
    audio2 = np.concatenate([audio, (rng.normal(size=(1, 4000)) * 0.1).astype(np.float32)])
    lengths = np.asarray([4000, 2700], np.int32)
    jenc = JaxEncoder(JaxConfig(**CFG))
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(audio))
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(3)
    data = {
        "config": CFG, "audio": audio, "audio2": audio2, "lengths": lengths,
        "state": {k: v.numpy() for k, v in wav2vec2_state_dict_from_jax(params).items()},
        "clips": [(rng.normal(size=int(s * 16000)) * 0.1).astype(np.float32) for s in (0.5, 0.35)],
        "one_hot": np.eye(12, dtype=np.float32)[[0, 5]],
        "template": (rng.normal(size=(50, 3)) * 0.01).astype(np.float32),
    }
    ranks = run_ranks(4, cases.sequence_cases, (data,), tmp_path_factory.mktemp("gloo"))
    want = np.asarray(jenc.apply(variables, jnp.asarray(audio)))
    want2 = np.asarray(jenc.apply(variables, jnp.asarray(audio2), None, jnp.asarray(lengths)))
    return ranks, want, want2, lengths


def test_sp_layers_match_unsharded(results):
    """4-way time sharding == JAX's plain encoder, with T not divisible by
    the axis: each rank returns its rows, which tile the whole output."""
    ranks, want, *_ = results
    t = want.shape[1]
    assert t % 4 != 0  # the test must exercise tail padding
    got = np.concatenate([r["share4"] for r in ranks], axis=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    c = -(-t // 4)
    assert [r["share4"].shape[1] for r in ranks] == [min(c, t - i * c) for i in range(4)]


def test_sp_attention_takes_local_queries_against_all_keys(results):
    ranks, want, *_ = results
    t = want.shape[1]
    t_pad = -(-t // 4) * 4
    assert ranks[1]["attention_shapes"] == [(t_pad // 4, t_pad)] * CFG["num_layers"]


def test_sp_respects_padded_batch_lengths(results):
    ranks, _, want2, lengths = results
    cfg = JaxConfig(**CFG)
    for r in ranks:
        for i, n in enumerate(lengths):
            fv = cfg.feat_extract_output_length(int(n))
            np.testing.assert_allclose(r["padded2"][i, :fv], want2[i, :fv], **TOL)


def test_sp_layers_entry_point(results):
    """pre_layers_only + sequence_parallel_layers is the same computation as
    the fused convenience wrapper."""
    for r in results[0]:
        assert r["split_point_lengths"] is None
        np.testing.assert_allclose(r["layers2"], r["encode2"], atol=1e-6)


def test_sp_gather_output_matches_sharded(results):
    ranks, want, *_ = results
    shares = np.concatenate([r["share4"] for r in ranks], axis=1)
    for r in ranks:
        np.testing.assert_allclose(r["gathered4"], shares, atol=1e-6)
        np.testing.assert_allclose(r["gathered4"], want, **TOL)


def test_faceformer_predictor_sp_mesh_matches_solo(results):
    """FaceFormerPredictor(sp_mesh=) time-shards the full-size wav2vec2
    encoder and reproduces the solo predictor on ragged padded clips."""
    ranks, *_ = results
    want = ranks[0]["solo_predictor"]
    for r in ranks:
        assert r["sp_collectives"]["all_gather"] > 0
        for g, w in zip(r["sp_predictor"], want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **TOL)


def test_mesh_and_sp_mesh_are_mutually_exclusive():
    with pytest.raises(ValueError, match="mutually exclusive"):
        FaceFormerPredictor(n_verts=150, device="cpu", mesh=object(), sp_mesh=object())

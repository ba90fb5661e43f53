"""The port's pipeline parallelism (``parallel/pipeline.py``) on four spawned
gloo ranks on the CPU, mirroring tests/test_pipeline_parallel.py: 2 and 4
stages against the JAX package's unsharded encoder on the same weights
(atol 2e-5, rtol 1e-5), microbatches of 2 with padded lengths, DP x PP on a
2 x 2 mesh, gradients through the pipeline against the plain layer stack's
(atol 1e-5, rtol 1e-4; each stage holds its own layers' gradients), and the
uneven-stage error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu.parallel.pipeline import stack_stage_params as jax_stack_stage_params
from audio2face_tpu_torch.compat.jax_params import wav2vec2_state_dict_from_jax
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from audio2face_tpu_torch.parallel.pipeline import stack_stage_params
from torch_gloo import run_ranks

torch.set_num_threads(1)

# 4 layers: stage counts 2 and 4 both divide
CFG = dict(
    conv_dim=(48, 48), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=48, num_layers=4,
    num_heads=4, intermediate_size=96, pos_conv_kernel=16, pos_conv_groups=4,
)
TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(4, 4000)) * 0.1).astype(np.float32)
    jenc = JaxEncoder(JaxConfig(**CFG))
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(audio))
    return jenc, variables, audio


@pytest.fixture(scope="module")
def results(setup, tmp_path_factory):
    jenc, variables, audio = setup
    params = jax.tree.map(np.asarray, variables["params"])
    lengths = np.asarray([4000, 2600, 3300, 4000], np.int32)
    data = {"config": CFG, "audio": audio, "lengths": lengths,
            "state": {k: v.numpy() for k, v in wav2vec2_state_dict_from_jax(params).items()}}
    ranks = run_ranks(4, cases.pipeline_cases, (data,), tmp_path_factory.mktemp("gloo"))
    want = np.asarray(jenc.apply(variables, jnp.asarray(audio)))
    want_padded = np.asarray(jenc.apply(variables, jnp.asarray(audio), None, jnp.asarray(lengths)))
    return ranks, want, want_padded, lengths


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pp_matches_unsharded(results, n_stages):
    ranks, want, *_ = results
    for r in ranks:
        got = r[f"stages{n_stages}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    # the ring shifts and the one sum over the stages
    assert ranks[0]["collectives"]["ring_shift"] > 0
    assert ranks[0]["collectives"]["all_reduce"] == 2


def test_pp_microbatch_gt1_and_padded_lengths(results):
    ranks, _, want_padded, lengths = results
    cfg = JaxConfig(**CFG)
    for r in ranks:
        for i, n in enumerate(lengths):
            fl = cfg.feat_extract_output_length(int(n))
            np.testing.assert_allclose(r["micro2_padded"][i, :fl], want_padded[i, :fl], **TOL)


def test_pp_dp_combined(results):
    ranks, want, *_ = results
    for r in ranks:
        np.testing.assert_allclose(r["dp_pp"], want, **TOL)


def test_pp_gradients_match(results):
    """The backward through the ring (each shift's backward shifts the other
    way) gives each stage its layers' gradients, equal to the plain stack's;
    the other stage's layers get none on this rank."""
    ranks, *_ = results
    solo = ranks[0]["solo_grads"]
    seen = set()
    for r in ranks:
        assert r["pp_untouched"] == []
        for k, g in r["pp_grads"].items():
            np.testing.assert_allclose(g, solo[k], atol=1e-5, rtol=1e-4, err_msg=k)
            seen.add(k)
    assert seen == set(solo)


def test_stack_stage_params_rejects_uneven(setup):
    _, variables, _ = setup
    cfg = Wav2Vec2Config(**CFG)
    with pytest.raises(ValueError, match="must divide evenly"):
        stack_stage_params(Wav2Vec2Encoder(cfg), 3, cfg)
    with pytest.raises(ValueError, match="must divide evenly"):
        jax_stack_stage_params(variables["params"], 3, JaxConfig(**CFG))
    stages = stack_stage_params(Wav2Vec2Encoder(cfg), 2, cfg)
    assert [len(s) for s in stages] == [2, 2]

"""Port conv feature encoder vs the JAX package.

- the port's plain version of the fused kernel family vs JAX
  ``fused_conv_encoder`` run in interpret mode (bf16 activations, so the
  bound is tests/test_conv_encoder.py's 0.05 x max|ref|);
- the port's f32 ``FeatureEncoder`` (per-layer conv1d path) vs the JAX f32
  ``FeatureEncoder`` on valid rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.wav2vec2 import FeatureEncoder as JaxFeatureEncoder
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.ops.conv_encoder import fused_conv_encoder as jax_fused
from audio2face_tpu_torch.models.wav2vec2 import FeatureEncoder, Wav2Vec2Config
from audio2face_tpu_torch.ops.conv_encoder import fused_conv_encoder, stack_output_length

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

L = 2500  # samples -> 7 output frames


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, L)) * 0.1).astype(np.float32)
    fe = JaxFeatureEncoder(JaxConfig(), dtype=None)
    variables = jax.jit(fe.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    return x, fe, variables, params


def _valid_frames(lengths):
    return [stack_output_length(int(n)) for n in lengths]


@pytest.mark.parametrize(
    "n,lengths",
    [(L, None), (L, (L, L - 800)), (2503, (2503, 1999)), (L, (L, 0))],
    ids=["full", "padded", "not_multiple_of_5", "zero_length_row"],
)
def test_plain_stack_matches_jax_fused(setup, n, lengths):
    x, _, _, params = setup
    x = x[:, :n]
    kernels = [params[f"conv{i}"]["kernel"] for i in range(7)]
    gn = params["group_norm"]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    ref = np.asarray(
        jax_fused(
            jnp.asarray(x), [jnp.asarray(k) for k in kernels], jnp.asarray(gn["scale"]),
            jnp.asarray(gn["bias"]), jl, interpret=True, tile_frames=8,
        ),
        np.float32,
    )
    out = fused_conv_encoder(
        torch.tensor(x), [torch.tensor(k) for k in kernels], torch.tensor(gn["scale"]),
        torch.tensor(gn["bias"]), None if lengths is None else torch.tensor(lengths),
    )
    assert out.dtype == torch.bfloat16
    assert tuple(out.shape) == (2, stack_output_length(n), 512)
    out = out.float().numpy()
    assert np.isfinite(out).all()
    bound = 0.05 * np.abs(ref).max()
    valid = _valid_frames(lengths if lengths is not None else (n, n))
    for b, nv in enumerate(valid):
        if nv > 0:
            err = np.abs(out[b, :nv] - ref[b, :nv]).max()
            assert err < bound, (b, err, bound)


def test_f32_feature_encoder_matches_jax(setup):
    x, fe, variables, params = setup
    lengths = np.asarray([L, L - 700], np.int32)
    ref = np.asarray(fe.apply(variables, jnp.asarray(x), jnp.asarray(lengths)))
    port = FeatureEncoder(Wav2Vec2Config())
    sd = {"group_norm.weight": torch.tensor(params["group_norm"]["scale"]),
          "group_norm.bias": torch.tensor(params["group_norm"]["bias"])}
    for i in range(7):
        sd[f"conv_layers.{i}.weight"] = torch.tensor(
            np.transpose(params[f"conv{i}"]["kernel"], (2, 1, 0)).copy()
        )
    port.load_state_dict(sd)
    with torch.no_grad():
        out = port(torch.tensor(x), torch.tensor(lengths)).numpy()
    assert out.shape == ref.shape
    for b, nv in enumerate(_valid_frames(lengths)):
        np.testing.assert_allclose(out[b, :nv], ref[b, :nv], rtol=1e-4, atol=1e-6)

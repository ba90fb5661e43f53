"""Port Wav2Vec2Encoder (f32) vs the JAX encoder with carried weights, at
full width (768 wide, 12 heads, 512-channel conv stack) and 2 layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu_torch.compat.jax_params import wav2vec2_state_dict_from_jax
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

# the suite runs several worker processes at once: one thread each, so that
# they do not fight over the cores (the tensors here are small)
torch.set_num_threads(1)

N_LAYERS = 2
S = 16000  # 1 s: 49 latents at 50 fps -> 60 frames


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(2, S)) * 0.1).astype(np.float32)
    jenc = JaxEncoder(JaxConfig(num_layers=N_LAYERS))
    variables = jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(audio))
    params = jax.tree.map(np.asarray, variables["params"])
    enc = Wav2Vec2Encoder(Wav2Vec2Config(num_layers=N_LAYERS))
    enc.load_state_dict(wav2vec2_state_dict_from_jax(params))
    enc.eval()
    return audio, jenc, variables, enc


def test_weight_carry_covers_every_parameter(pair):
    *_, enc = pair
    # load_state_dict is strict: every port parameter came from the JAX tree
    assert enc.masked_spec_embed.shape == (768,)
    assert len(enc.layers) == N_LAYERS


@pytest.mark.parametrize("use_lengths", [False, True], ids=["unpadded", "padded_lengths"])
def test_encoder_with_fps_adapter_matches_jax(pair, use_lengths):
    audio, jenc, variables, enc = pair
    output_len = 60
    lengths = np.asarray([S, 11000], np.int32) if use_lengths else None
    out_lengths = (
        np.asarray([n * 60 // 16000 for n in lengths], np.int32) if use_lengths else None
    )
    ref = np.asarray(jax.jit(
        lambda v, a, l, o: jenc.apply(v, a, output_len=output_len, lengths=l, output_lengths=o)
    )(variables, jnp.asarray(audio),
      None if lengths is None else jnp.asarray(lengths),
      None if out_lengths is None else jnp.asarray(out_lengths)))
    with torch.no_grad():
        out = enc(
            torch.tensor(audio), output_len=output_len,
            lengths=None if lengths is None else torch.tensor(lengths),
            output_lengths=None if out_lengths is None else torch.tensor(out_lengths),
        ).numpy()
    assert out.shape == ref.shape == (2, output_len, 768)
    valid = out_lengths if use_lengths else [output_len] * 2
    for b, n in enumerate(valid):
        np.testing.assert_allclose(out[b, :n], ref[b, :n], atol=1e-4, rtol=0)

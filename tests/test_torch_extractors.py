"""The port's feature extractors against the JAX package on the same
waveforms: the MFCC extractor (mfcc + bilinear resize to out_dim) at both
frame-model configs, and the wav2vec2 extractor (resample, normalization, a
2-layer wav2vec2 encoder with carried weights, bilinear resize of the (768,
T) image) at the frame window's shape. Both return detached f32
features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.models.extractor import MFCCExtractor as JaxMFCC
from audio2face_tpu.models.extractor import Wav2VecExtractor as JaxWav2Vec
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from audio2face_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from audio2face_tpu_torch.compat.jax_params import wav2vec2_state_dict_from_jax
from audio2face_tpu_torch.models.extractor import MFCCExtractor, Wav2VecExtractor
from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from audio2face_tpu_torch.registry import get_extractor

torch.set_num_threads(1)

SR = 22000
WINDOW = 11440  # one 0.52 s frame window at 22 kHz
# the MFCC bar of the goldens (tests/test_dsp.py): 2e-3 of the largest |value|
MFCC_BAR = 2e-3
# f32 wav2vec2 through two layers: the tolerance of the port's encoder tests
WAV2VEC_TOL = 1e-4


def _waves(seed, n=2, length=WINDOW):
    return (np.random.default_rng(seed).normal(size=(n, length)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("n_feature,out_dim,win", [(32, 52, 440), (16, 29, 790)],
                         ids=["audio2mesh", "voca"])
def test_mfcc_extractor_matches_jax(n_feature, out_dim, win):
    x = _waves(0, 3)
    port = get_extractor("mfcc")(SR, n_feature, out_dim, win, None, 1024)
    assert isinstance(port, MFCCExtractor) and port.hop_length == win // 2
    got = port(torch.tensor(x, requires_grad=True))
    want = np.asarray(JaxMFCC(SR, n_feature, out_dim, win, None, 1024)(jnp.asarray(x)))
    assert got.shape == (3, out_dim, n_feature) == want.shape
    assert not got.requires_grad  # detached, as the reference detaches it
    assert np.abs(got.numpy() - want).max() < MFCC_BAR * np.abs(want).max()


@pytest.fixture(scope="module")
def wav2vec_pair():
    """The JAX extractor on a 2-layer encoder (its constructor builds the
    full-width one, so the narrow one is set in place) and the port's with
    the same weights."""
    jax_fe = JaxWav2Vec.__new__(JaxWav2Vec)
    jax_fe.ori_sample_rate, jax_fe.sample_rate, jax_fe.out_dim, jax_fe.n_feature = SR, 16000, 52, 32
    jax_fe.config = JaxConfig(num_layers=2)
    jax_fe.model = JaxEncoder(jax_fe.config)
    params = jax_fe.model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16000)))["params"]
    jax_fe.params = params
    port = Wav2VecExtractor(SR, 32, 52, 440, None, 1024, config=Wav2Vec2Config(num_layers=2),
                            state_dict=wav2vec2_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return jax_fe, port


def test_wav2vec_extractor_matches_jax(wav2vec_pair):
    jax_fe, port = wav2vec_pair
    x = _waves(1)
    want = np.asarray(jax_fe(jnp.asarray(x)))
    got = port(torch.tensor(x))
    assert got.shape == want.shape == (2, 52, 32)
    assert got.dtype == torch.float32 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=WAV2VEC_TOL * np.abs(want).max())


def test_wav2vec_extractor_frame_window_shape():
    """One frame window resampled to 16 kHz is 8,320 samples, ~25 encoder
    positions; a seeded random init is deterministic."""
    a = Wav2VecExtractor(SR, 32, 52, config=Wav2Vec2Config(num_layers=1), seed=3)
    b = Wav2VecExtractor(SR, 32, 52, config=Wav2Vec2Config(num_layers=1), seed=3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert a.config.feat_extract_output_length(8320) == 25
    with torch.enable_grad():
        out = a(torch.tensor(_waves(2, 1)))
    assert out.shape == (1, 52, 32) and torch.isfinite(out).all() and out.grad_fn is None

"""The port's MFCC front end and fragmenter (``ops/dsp.py``) against the JAX
package on the same inputs, and the MFCC against the committed torchaudio
goldens at the JAX test's bar (2e-3 of each golden's largest |value|)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio2face_tpu.ops import dsp as jdsp
from audio2face_tpu_torch.ops import dsp

torch.set_num_threads(1)

MFCC_GOLDEN_BAR = 2e-3  # of the golden's largest |value| (tests/test_dsp.py)


def _wave(seed, shape, scale=0.2):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def test_host_constants_equal_jax():
    np.testing.assert_array_equal(dsp.hann_window(440), jdsp.hann_window(440))
    np.testing.assert_array_equal(dsp.hann_window(31, periodic=False),
                                  jdsp.hann_window(31, periodic=False))
    for args in [(513, 0.0, 11000.0, 128, 22000, None, "htk"),
                 (257, 20.0, 8000.0, 40, 16000, "slaney", "slaney")]:
        np.testing.assert_array_equal(dsp.mel_filterbank(*args), jdsp.mel_filterbank(*args))
    np.testing.assert_array_equal(dsp.dct_matrix(32, 128), jdsp.dct_matrix(32, 128))
    np.testing.assert_array_equal(dsp.dct_matrix(16, 40, None), jdsp.dct_matrix(16, 40, None))
    for mels in ([0.0, 1000.0, 2500.0], [10.0, 30.0]):
        for scale in ("htk", "slaney"):
            np.testing.assert_array_equal(dsp._mel_to_hz(mels, scale), jdsp._mel_to_hz(mels, scale))
            np.testing.assert_array_equal(dsp._hz_to_mel(mels, scale), jdsp._hz_to_mel(mels, scale))


def test_device_constants_are_built_once():
    dsp._device_constant.cache_clear()
    a = dsp.device_constant("mel_filterbank", 513, 0.0, 11000.0, 128, 22000, None, "htk", device="cpu")
    b = dsp.device_constant("mel_filterbank", 513, 0.0, 11000.0, 128, 22000, None, "htk", device="cpu")
    assert a is b and dsp._device_constant.cache_info().misses == 1
    x = torch.tensor(_wave(0, (2, 11440)))
    for _ in range(2):
        dsp.mfcc(x, sample_rate=22000, n_mfcc=32, n_fft=1024, win_length=440, hop_length=220)
    # window, filterbank and DCT: one build each over both calls
    assert dsp._device_constant.cache_info().misses == 3


def test_frame_signal_is_a_view_equal_to_jax():
    x = _wave(1, (2, 100))
    got = dsp.frame_signal(torch.tensor(x), 16, 5, 12)
    assert got.shape == (2, 12, 16) and got._base is not None
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdsp.frame_signal(jnp.asarray(x), 16, 5, 12)))


@pytest.mark.parametrize("n_fft,win,hop,length", [(1024, 440, 220, 11440), (1024, 790, 395, 11440),
                                                   (440, 440, 220, 5001), (64, 51, 16, 300)])
def test_spectrogram_matches_jax(n_fft, win, hop, length):
    """The framing: a reflect pad of n_fft // 2, the window zero-padded
    centred to n_fft, 1 + L // hop frames."""
    x = _wave(2, (2, length))
    got = dsp.spectrogram(torch.tensor(x), n_fft=n_fft, win_length=win, hop_length=hop).numpy()
    want = np.asarray(jdsp.spectrogram(jnp.asarray(x), n_fft=n_fft, win_length=win, hop_length=hop))
    assert got.shape == want.shape == (2, n_fft // 2 + 1, 1 + length // hop)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_amplitude_to_db_and_mel_match_jax():
    x = np.abs(_wave(3, (2, 128, 53))) ** 3  # quiet bins down to ~1e-12
    got = dsp.amplitude_to_db(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdsp.amplitude_to_db(jnp.asarray(x))), atol=1e-4)
    got = dsp.amplitude_to_db(torch.tensor(x), top_db=40.0).numpy()
    np.testing.assert_allclose(got, np.asarray(jdsp.amplitude_to_db(jnp.asarray(x), top_db=40.0)),
                               atol=1e-4)
    w = _wave(4, (2, 11440))
    kw = dict(sample_rate=22000, n_fft=1024, win_length=440, hop_length=220)
    got = dsp.mel_spectrogram(torch.tensor(w), **kw).numpy()
    want = np.asarray(jdsp.mel_spectrogram(jnp.asarray(w), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_mfcc_matches_torchaudio_goldens_and_jax():
    from tests.torchaudio_mirror import GOLDEN_CONFIGS

    goldens = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "mfcc_goldens.npz"))
    x32 = goldens["inputs"].astype(np.float32)
    for name, cfg in GOLDEN_CONFIGS.items():
        want = goldens[name]
        got = dsp.mfcc(torch.tensor(x32), **cfg).numpy()
        jax_out = np.asarray(jdsp.mfcc(jnp.asarray(x32), **cfg))
        assert got.shape == want.shape, name
        scale = np.abs(want).max()
        assert np.abs(got - want).max() < MFCC_GOLDEN_BAR * scale, name
        assert np.abs(got - jax_out).max() < MFCC_GOLDEN_BAR * scale, name


def test_mfcc_log_mels_matches_jax():
    x = _wave(5, (3, 11440))
    kw = dict(sample_rate=22000, n_mfcc=16, n_fft=1024, win_length=790, hop_length=395, log_mels=True)
    got = dsp.mfcc(torch.tensor(x), **kw).numpy()
    want = np.asarray(jdsp.mfcc(jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("shape,out", [((2, 53, 32), (52, 32)), ((2, 768, 25), (52, 32)),
                                       ((1, 5, 7), (9, 3)), ((3, 4, 4), (1, 1))])
@pytest.mark.parametrize("align_corners", [False, True])
def test_interp_bilinear_matches_jax(shape, out, align_corners):
    x = _wave(6, shape)
    got = dsp.interp_bilinear(torch.tensor(x), *out, align_corners=align_corners).numpy()
    want = np.asarray(jdsp.interp_bilinear(jnp.asarray(x), *out, align_corners=align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_batched_audio_fragments_matches_jax():
    audio = _wave(7, (22000,))
    idx = np.asarray([0, 1, 17, 59, 60], np.int32)
    shift = np.asarray([0, 3, -200, 499, 17], np.int32)
    for s in (None, shift):
        got = dsp.batched_audio_fragments(
            torch.tensor(audio), torch.tensor(idx), shift=None if s is None else torch.tensor(s))
        want = jdsp.batched_audio_fragments(
            jnp.asarray(audio), jnp.asarray(idx), shift=None if s is None else jnp.asarray(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fragment_starts_exact_past_int32_wrap():
    """The naive int32 product f * 22000 wraps past frame ~97,600; the
    decomposition stays exact (the JAX predictor's formula)."""
    f = np.asarray([0, 59, 60, 97_612, 100_000, 123_457, 2_000_000], np.int64)
    want = f * 22000 // 60
    for dtype in (torch.int32, torch.int64):
        got = dsp.fragment_starts(torch.tensor(f, dtype=dtype), 60, 22000)
        np.testing.assert_array_equal(got.numpy(), want)
    jf = jnp.asarray(f, jnp.int32)
    np.testing.assert_array_equal(np.asarray((jf // 60) * 22000 + (jf % 60) * 22000 // 60), want)
    assert (f.astype(np.int32) * np.int32(22000))[4] != want[4] * 60  # the naive product wraps

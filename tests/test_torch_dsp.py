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


def _interp_uncached(x, out_size, axis, align_corners):
    """``interp_linear`` as it computed before its constants were cached:
    the host's indices and weights copied to the device on every call."""
    axis = axis % x.dim()
    in_size = x.shape[axis]
    if in_size == out_size and align_corners:
        return x
    lo, hi, w_hi = dsp._interp_weights(in_size, out_size, align_corners)
    x_lo = x.index_select(axis, torch.as_tensor(lo, device=x.device))
    x_hi = x.index_select(axis, torch.as_tensor(hi, device=x.device))
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = torch.as_tensor(w_hi, device=x.device).reshape(shape)
    return x_lo * (1.0 - w) + x_hi * w


@pytest.mark.parametrize("align_corners", [False, True])
def test_cached_interp_is_bit_equal_to_the_uncached_formula(align_corners):
    """On the golden MFCC images (resized as the Audio2Mesh and VOCA
    extractors resize them) and on other shapes, axes and sizes."""
    goldens = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "mfcc_goldens.npz"))
    images = [(goldens["audio2mesh"], (52, 32)), (goldens["voca"], (29, 16)),
              (_wave(11, (2, 768, 25)), (52, 32)), (_wave(12, (1, 5, 7)), (9, 3)),
              (_wave(13, (3, 4, 4)), (1, 1))]
    for image, (out_h, out_w) in images:
        x = torch.tensor(np.swapaxes(image, -1, -2).astype(np.float32))
        want = _interp_uncached(_interp_uncached(x, out_h, -2, align_corners), out_w, -1,
                                align_corners)
        got = dsp.interp_bilinear(x, out_h, out_w, align_corners=align_corners)
        assert got.numpy().tobytes() == want.numpy().tobytes()
    x = torch.tensor(_wave(14, (2, 256, 256)))
    for axis, out in ((2, 32), (1, 60), (0, 5), (-1, 256)):
        want = _interp_uncached(x, out, axis, align_corners)
        got = dsp.interp_linear(x, out, axis=axis, align_corners=align_corners)
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_interp_constants_are_copied_once(monkeypatch):
    """A repeated size reuses the cached index and weight tensors: one host
    build and copy, then none."""
    built = []
    real = dsp._CONSTANTS["interp_weights"]
    monkeypatch.setitem(dsp._CONSTANTS, "interp_weights",
                        lambda *args: built.append(args) or real(*args))
    dsp._device_constant.cache_clear()
    x = torch.tensor(_wave(15, (4, 53, 32)))
    first = dsp.interp_bilinear(x, 52, 32)
    consts = dsp.device_constant("interp_weights", 53, 52, False, device="cpu")
    for _ in range(3):
        assert dsp.interp_bilinear(x, 52, 32).numpy().tobytes() == first.numpy().tobytes()
    again = dsp.device_constant("interp_weights", 53, 52, False, device="cpu")
    assert [a.data_ptr() for a in again] == [a.data_ptr() for a in consts]
    # 53 -> 52 and 32 -> 32, each built once over four calls
    assert built == [(53, 52, False), (32, 32, False)]
    assert dsp._device_constant.cache_info().misses == 2


def test_constants_first_made_in_inference_mode_serve_autograd():
    """A serving call (inference mode) makes the constants; a training
    step then differentiates through them."""
    dsp._device_constant.cache_clear()
    x = _wave(17, (2, 256, 256))
    with torch.inference_mode():
        dsp.interp_linear(torch.tensor(x), 32, axis=2, align_corners=False)
    leaf = torch.tensor(x, requires_grad=True)
    dsp.interp_linear(leaf, 32, axis=2, align_corners=False).sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


def test_held_constants_collects_what_a_capture_reads():
    x = torch.tensor(_wave(16, (2, 256, 256)))
    outside = dsp.device_constant("interp_weights", 256, 32, False, device="cpu")
    with dsp.held_constants() as held:
        dsp.interp_linear(x, 32, axis=2, align_corners=False)
    assert len(held) == 1 and all(a is b for a, b in zip(held[0], outside))
    assert dsp._held is None
    dsp.interp_linear(x, 32, axis=2, align_corners=False)
    assert len(held) == 1


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

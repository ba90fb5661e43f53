"""Audio DSP: the MFCC front end, interpolation, resampling, normalization
and the on-device fragmenter.

Port of ``audio2face_tpu/ops/dsp.py``. ``mfcc`` follows
``torchaudio.transforms.MFCC`` with the reference's settings: STFT (center,
reflect pad, periodic Hann window of ``win_length`` zero-padded centred to
``n_fft``) -> power -> HTK mel filterbank (128 mels, 0 to sr/2, no norm) ->
power to dB -> orthonormal DCT-II. The DFT is ``torch.fft.rfft`` on strided
views of the padded signal. The window, filterbank and DCT basis, and the
linear interpolation's gather indices and weights, are numpy constants built
in float64 on the host, as the JAX package builds them, and copied to each
device once (``device_constant``): after the first call with a shape, no
call copies from the host, so none waits for the device.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Windows and filterbanks (host-side constants, cached on each device)
# ---------------------------------------------------------------------------


def hann_window(win_length: int, *, periodic: bool = True) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    denom = win_length if periodic else win_length - 1
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / denom))).astype(np.float32)


def _hz_to_mel(freq, mel_scale: str = "htk"):
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank, (n_freqs, n_mels), as torchaudio's
    ``melscale_fbanks`` builds it: FFT bin centres linspace(0, sr/2,
    n_freqs), n_mels+2 points equally spaced in mel, optional slaney area
    normalization."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_min = _hz_to_mel(f_min, mel_scale)
    m_max = _hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int, norm: str | None = "ortho") -> np.ndarray:
    """DCT-II basis, (n_mels, n_mfcc), as torchaudio's ``create_dct``."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct = dct * 2.0
    else:
        if norm != "ortho":
            raise ValueError(f"norm must be None or 'ortho', got {norm!r}")
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct = dct * math.sqrt(2.0 / n_mels)
    return dct.T.astype(np.float32)


def _stft_window(win_length: int, n_fft: int) -> np.ndarray:
    """The periodic Hann window of ``win_length`` zero-padded centred to
    ``n_fft`` (torch.stft's convention)."""
    window = hann_window(win_length)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        window = np.pad(window, (left, n_fft - win_length - left))
    return window


def _interp_weights(in_size: int, out_size: int, align_corners: bool):
    """Gather indices and weights for 1-D linear interp: ``lo``, ``hi``
    (int64) and ``w_hi`` (f32), from source coordinates in host float64, as
    the JAX package computes them."""
    if out_size == 1:
        src = np.zeros(1)
    elif align_corners:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


_CONSTANTS = {
    "stft_window": _stft_window,
    "mel_filterbank": mel_filterbank,
    "dct_matrix": dct_matrix,
    "interp_weights": _interp_weights,
}
_held: Optional[list] = None  # see held_constants


@functools.lru_cache(maxsize=64)
def _device_constant(name: str, args: tuple, device: str):
    host = _CONSTANTS[name](*args)
    # ordinary tensors even when first asked for in inference mode: a
    # training step may differentiate through them later
    with torch.inference_mode(False):
        if isinstance(host, tuple):
            return tuple(torch.as_tensor(a, device=device) for a in host)
        return torch.as_tensor(host, device=device)


def device_constant(name: str, *args, device):
    """The numpy constant ``name(*args)`` (``stft_window``, ``mel_filterbank``,
    ``dct_matrix``, or ``interp_weights``'s tuple) as a tensor, or a tuple of
    them, on ``device``, built and copied once per (arguments, device)."""
    value = _device_constant(name, tuple(args), str(torch.device(device)))
    if _held is not None:
        _held.append(value)
    return value


@contextlib.contextmanager
def held_constants() -> Iterator[list]:
    """Collects every device constant handed out inside the block. A CUDA
    graph captured there reads them by address, so its owner keeps the list:
    a constant the cache evicts later then stays allocated."""
    global _held
    outer, _held = _held, []
    try:
        yield _held
    finally:
        _held = outer


# ---------------------------------------------------------------------------
# Spectrogram / MFCC
# ---------------------------------------------------------------------------


def frame_signal(x: torch.Tensor, frame_length: int, hop: int, n_frames: int) -> torch.Tensor:
    """(..., L) -> (..., n_frames, frame_length): a strided view, no copy."""
    return x.unfold(-1, frame_length, hop)[..., :n_frames, :]


def spectrogram(
    waveform: torch.Tensor,
    *,
    n_fft: int,
    win_length: int,
    hop_length: int,
    power: float = 2.0,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Power spectrogram, (..., n_freqs, n_frames), torch.stft conventions:
    the window of ``win_length`` zero-padded centred to ``n_fft``;
    ``center=True`` pads n_fft//2 on both sides (reflect), so n_frames =
    1 + L // hop_length. f32."""
    x = waveform.to(torch.float32)
    batch_shape = x.shape[:-1]
    if center:
        pad = n_fft // 2
        # F.pad's reflect mode takes a (N, C, L) input
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(*batch_shape, -1)
    n_frames = (x.shape[-1] - n_fft) // hop_length + 1
    window = device_constant("stft_window", win_length, n_fft, device=x.device)
    frames = frame_signal(x, n_fft, hop_length, n_frames)  # (..., n_frames, n_fft)
    spec = torch.fft.rfft(frames * window, dim=-1).abs()  # (..., n_frames, n_freqs)
    if power != 1.0:
        spec = spec**power
    return spec.transpose(-1, -2)


def amplitude_to_db(
    x: torch.Tensor,
    *,
    multiplier: float = 10.0,
    amin: float = 1e-10,
    db_multiplier: float = 0.0,
    top_db: float | None = None,
) -> torch.Tensor:
    """Power/amplitude to decibels, torchaudio ``AmplitudeToDB`` semantics."""
    x_db = multiplier * torch.log10(torch.clamp(x, min=amin)) - multiplier * db_multiplier
    if top_db is not None:
        x_db = torch.maximum(x_db, x_db.max() - top_db)
    return x_db


def mel_spectrogram(
    waveform: torch.Tensor,
    *,
    sample_rate: int,
    n_fft: int,
    win_length: int,
    hop_length: int,
    n_mels: int = 128,
    f_min: float = 0.0,
    f_max: float | None = None,
    power: float = 2.0,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> torch.Tensor:
    """(..., L) -> (..., n_mels, n_frames), torchaudio MelSpectrogram defaults."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    spec = spectrogram(
        waveform, n_fft=n_fft, win_length=win_length, hop_length=hop_length, power=power
    )
    fb = device_constant(
        "mel_filterbank", n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate, norm, mel_scale,
        device=spec.device,
    )
    return torch.einsum("...ft,fm->...mt", spec, fb)


def mfcc(
    waveform: torch.Tensor,
    *,
    sample_rate: int,
    n_mfcc: int,
    n_fft: int,
    win_length: int,
    hop_length: int,
    n_mels: int = 128,
    log_mels: bool = False,
) -> torch.Tensor:
    """(..., L) -> (..., n_mfcc, n_frames), torchaudio ``transforms.MFCC``."""
    mel = mel_spectrogram(
        waveform, sample_rate=sample_rate, n_fft=n_fft, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels,
    )
    if log_mels:
        mel = torch.log(mel + 1e-6)
    else:
        mel = amplitude_to_db(mel)
    dct = device_constant("dct_matrix", n_mfcc, n_mels, "ortho", device=mel.device)
    return torch.einsum("...mt,mk->...kt", mel, dct)


# ---------------------------------------------------------------------------
# Interpolation (F.interpolate parity)
# ---------------------------------------------------------------------------


def interp_linear(x: torch.Tensor, out_size: int, *, axis: int, align_corners: bool) -> torch.Tensor:
    """Linear interpolation along ``axis`` to ``out_size``; the indices and
    weights are ``device_constant``s."""
    axis = axis % x.dim()
    in_size = x.shape[axis]
    if in_size == out_size and align_corners:
        return x
    lo, hi, w_hi = device_constant("interp_weights", in_size, int(out_size), bool(align_corners),
                                   device=x.device)
    x_lo = x.index_select(axis, lo)
    x_hi = x.index_select(axis, hi)
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w_hi.reshape(shape)
    return x_lo * (1.0 - w) + x_hi * w


def interp_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, *, align_corners: bool = False
) -> torch.Tensor:
    """Bilinear interpolation of the last two axes (F.interpolate parity)."""
    x = interp_linear(x, out_h, axis=-2, align_corners=align_corners)
    return interp_linear(x, out_w, axis=-1, align_corners=align_corners)


def linear_interpolation_fps(features: torch.Tensor, output_len: int) -> torch.Tensor:
    """Resample the time axis of (B, T, C) features to ``output_len`` frames
    with align_corners=True linear interp (the wav2vec2 fps adapter)."""
    return interp_linear(features, output_len, axis=1, align_corners=True)


def interp_linear_per_item(
    x: torch.Tensor,
    out_size: int,
    in_lengths: torch.Tensor,
    out_lengths: torch.Tensor,
) -> torch.Tensor:
    """Per-item align_corners=True linear interp over the *valid prefix*.

    ``x``: (B, T, C) padded; item b's first ``in_lengths[b]`` steps are
    resampled onto its first ``out_lengths[b]`` output frames (frames beyond
    that clamp to the last valid step and are masked downstream). Source
    positions are computed in f32 on the device, as in the JAX package, so
    that ``floor`` picks the same neighbours."""
    b, t, _ = x.shape
    f = torch.arange(out_size, dtype=torch.float32, device=x.device)[None, :]
    in_f = in_lengths.to(x.device)[:, None].to(torch.float32)
    out_f = out_lengths.to(x.device)[:, None].to(torch.float32)
    scale = (in_f - 1.0) / torch.clamp(out_f - 1.0, min=1.0)
    src = torch.minimum(torch.clamp(f * scale, min=0.0), in_f - 1.0)
    lo = torch.floor(src).to(torch.int64)
    hi = torch.minimum(lo + 1, in_lengths.to(x.device)[:, None].to(torch.int64) - 1)
    w = (src - lo.to(torch.float32))[..., None]
    # rows with no valid input would index -1; any in-range row serves, the
    # frames are masked downstream
    lo_i = lo.clamp(0, t - 1)[..., None].expand(b, out_size, x.shape[2])
    hi_i = hi.clamp(0, t - 1)[..., None].expand(b, out_size, x.shape[2])
    x_lo = torch.gather(x, 1, lo_i)
    x_hi = torch.gather(x, 1, hi_i)
    return x_lo * (1.0 - w) + x_hi * w


def _resample_kernel(
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> tuple[np.ndarray, int]:
    """Windowed-sinc polyphase kernel, (new_freq, 1, kernel_width), as
    torchaudio's ``_get_sinc_resample_kernel`` builds it (Hann window)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq

    t = (-np.arange(new_freq, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = kernel * window * scale
    return kernel[:, None, :].astype(np.float32), width


def resample(
    waveform: torch.Tensor,
    orig_freq: int,
    new_freq: int,
    *,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """(..., L) -> (..., ceil(L * new/orig)); torchaudio's default resampler,
    as a strided polyphase conv in f32."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    kernel, width = _resample_kernel(orig, new, lowpass_filter_width, rolloff)

    batch_shape = waveform.shape[:-1]
    length = waveform.shape[-1]
    x = waveform.reshape(-1, 1, length).to(torch.float32)
    x = F.pad(x, (width, width + orig))
    y = F.conv1d(x, torch.as_tensor(kernel, device=x.device), stride=orig)  # (B, new, T')
    y = y.transpose(1, 2).reshape(*batch_shape, -1)
    target_length = math.ceil(new * length / orig)
    return y[..., :target_length]


def normalize_int16(audio: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1)."""
    return (audio / 32768.0).to(torch.float32)


def wav2vec2_zero_mean_unit_var(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Per-utterance zero mean / unit variance, (x - mu) / sqrt(var + 1e-7):
    the Wav2Vec2Processor's normalization for wav2vec2-base."""
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-7)


def fragment_starts(frame_idx: torch.Tensor, fps: int, sample_rate: int) -> torch.Tensor:
    """``frame_idx * sample_rate // fps`` evaluated as ``(f // fps) * sr +
    (f % fps) * sr // fps``: exact, and free of the int32 overflow of the
    naive product past frame ~97,000 at 22 kHz."""
    return (frame_idx // fps) * sample_rate + (frame_idx % fps) * sample_rate // fps


def batched_audio_fragments(
    audio: torch.Tensor,
    frame_idx: torch.Tensor,
    *,
    fps: int = 60,
    sample_rate: int = 22000,
    length: float = 0.52,
    shift: torch.Tensor | None = None,
    max_shift: int = 500,
) -> torch.Tensor:
    """The ``length``-second window centred at each frame time, gathered on
    the device: ``audio`` is a zero-padded (L,) clip, ``frame_idx`` (N,)
    frame indices (semantics of the reference's host fragmenter)."""
    n_pad = int(sample_rate * length / 2)
    window = 2 * n_pad
    padded = F.pad(audio, (n_pad + max_shift, window))
    starts = frame_idx.to(audio.device) * sample_rate // fps + max_shift
    if shift is not None:
        starts = starts - shift.to(audio.device)
    idx = starts[:, None] + torch.arange(window, device=audio.device)[None, :]
    return padded[idx]

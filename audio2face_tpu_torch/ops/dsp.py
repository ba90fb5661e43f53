"""Audio DSP on the main path: interpolation, resampling, normalization.

Port of the serving-path parts of ``audio2face_tpu/ops/dsp.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _interp_weights(in_size: int, out_size: int, align_corners: bool):
    """Source coordinates + gather indices/weights for 1-D linear interp
    (host float64, as the JAX package computes them)."""
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


def interp_linear(x: torch.Tensor, out_size: int, *, axis: int, align_corners: bool) -> torch.Tensor:
    """Linear interpolation along ``axis`` to ``out_size``."""
    axis = axis % x.dim()
    in_size = x.shape[axis]
    if in_size == out_size and align_corners:
        return x
    lo, hi, w_hi = _interp_weights(in_size, out_size, align_corners)
    x_lo = x.index_select(axis, torch.as_tensor(lo, device=x.device))
    x_hi = x.index_select(axis, torch.as_tensor(hi, device=x.device))
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = torch.as_tensor(w_hi, device=x.device).reshape(shape)
    return x_lo * (1.0 - w) + x_hi * w


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

"""Mel-spectrogram reference helpers (feature-parity checking utilities).

Port of ``audio2face_tpu/data/utils.py`` over the port's ``ops/dsp.py``.
The reference's offline checking module (src/dataset/utils.py:8-59)
compares torchaudio and librosa mel conventions and plots spectrograms;
here both conventions come from the same DSP core with explicit flags. Not
on the training path. CPU tensors in, numpy out.
"""

from __future__ import annotations

import numpy as np
import torch

from audio2face_tpu_torch.ops.dsp import amplitude_to_db, mel_spectrogram


def melspec_htk_slaney(
    audio,
    sr: int = 22000,
    n_mels: int = 32,
    n_fft: int = 1024,
    hop_length: int = 176,
    win_length: int = 176 * 2,
) -> np.ndarray:
    """The parameterization the reference inspects (power=2,
    norm='slaney', mel_scale='htk')."""
    audio = torch.as_tensor(np.asarray(audio, np.float32))
    out = mel_spectrogram(
        audio, sample_rate=sr, n_fft=n_fft, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels, norm="slaney", mel_scale="htk",
    )
    return out.numpy()


def melspec_htk(
    audio,
    sr: int = 22000,
    n_mels: int = 32,
    n_fft: int = 1024,
    hop_length: int = 176,
    win_length: int = 176 * 2,
) -> np.ndarray:
    """Unnormalized HTK mel (the torchaudio-MFCC-default convention)."""
    audio = torch.as_tensor(np.asarray(audio, np.float32))
    out = mel_spectrogram(
        audio, sample_rate=sr, n_fft=n_fft, win_length=win_length,
        hop_length=hop_length, n_mels=n_mels, norm=None, mel_scale="htk",
    )
    return out.numpy()


def power_to_db(spec: np.ndarray, top_db: float = 80.0) -> np.ndarray:
    """librosa.power_to_db(ref=max) equivalent for plotting."""
    db = amplitude_to_db(torch.as_tensor(np.asarray(spec)))
    db = db - db.max()
    return torch.clamp(db, min=-top_db).numpy()


def plot_spectrogram(specgram, title=None, ylabel="freq_bin", ax=None):
    """Plot helper; matplotlib is imported here, on use, so that the port
    carries no plotting dependency."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("plot_spectrogram requires matplotlib") from e
    if ax is None:
        _, ax = plt.subplots(1, 1)
    if title is not None:
        ax.set_title(title)
    ax.set_ylabel(ylabel)
    ax.imshow(
        power_to_db(np.asarray(specgram)),
        origin="lower",
        aspect="auto",
        interpolation="nearest",
    )
    return ax

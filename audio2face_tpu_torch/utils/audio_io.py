"""Waveform decoding shared by every audio-ingesting surface.

The port's own copy of ``audio2face_tpu/utils/audio_io.py`` (pure numpy/scipy).

The reference loads audio with torchaudio/librosa, which normalize PCM to
[-1, 1] float for any bit depth; scipy.io.wavfile (the only wav reader in
this environment) returns the raw container dtype instead. Every ingest
path — the HTTP daemon, the inference CLI, the BIWI datamodule — must apply
the same dtype normalization or an int32/uint8 WAV silently feeds ~1e9- (or
offset-) amplitude samples into the model and returns garbage with a 200.
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np


def pcm_to_float32(wav: np.ndarray) -> np.ndarray:
    """Normalize a scipy.io.wavfile array to mono float32 in [-1, 1].

    Handles every dtype scipy can return: uint8 (8-bit offset PCM),
    int16, int32 (24/32-bit PCM), float32/float64 (already normalized).
    Multi-channel input is averaged to mono AFTER normalization.
    """
    wav = np.asarray(wav)
    if wav.dtype == np.uint8:
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    elif wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    elif wav.dtype != np.float32:  # float64 or anything exotic
        wav = wav.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    return np.ascontiguousarray(wav, np.float32)


def read_wav(source: Union[str, bytes]) -> tuple[np.ndarray, int]:
    """Read a WAV path or in-memory RIFF body to (mono float32, rate)."""
    import scipy.io.wavfile as wavfile

    if isinstance(source, bytes):
        sr, wav = wavfile.read(io.BytesIO(source))
    else:
        sr, wav = wavfile.read(source)
    return pcm_to_float32(wav), int(sr)

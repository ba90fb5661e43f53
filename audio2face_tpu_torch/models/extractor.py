"""Feature extractors: MFCC and wav2vec2 hidden-state features.

Port of ``audio2face_tpu/models/extractor.py``. The contract is the
reference's: ``Extractor(sample_rate, n_feature, out_dim, win_length,
hop_length, n_fft)`` called on a (B, L) waveform returns (B, out_dim,
n_feature). Both run on the waveform's device and return their output
detached, as the reference detaches the extractor's output (the JAX
package's ``stop_gradient``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio2face_tpu_torch.ops import dsp


class MFCCExtractor:
    """MFCC features: (B, L) -> (B, out_dim, n_mfcc).

    torchaudio.transforms.MFCC with the reference's melkwargs (n_fft, hop =
    win // 2 by default, 128 mels), then a bilinear resize of the time axis
    to ``out_dim`` (53 -> 52 at the reference config)."""

    def __init__(
        self,
        sample_rate: int,
        n_feature: int,
        out_dim: int,
        win_length: int,
        hop_length: Optional[int] = None,
        n_fft: Optional[int] = None,
    ):
        self.sample_rate = sample_rate
        self.n_mfcc = n_feature
        self.out_dim = out_dim
        self.win_length = win_length
        self.hop_length = hop_length if hop_length else win_length // 2
        self.n_fft = n_fft if n_fft else win_length

    def to(self, device) -> "MFCCExtractor":
        """No weights: the constants follow the waveform's device."""
        return self

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        feats = dsp.mfcc(
            x, sample_rate=self.sample_rate, n_mfcc=self.n_mfcc, n_fft=self.n_fft,
            win_length=self.win_length, hop_length=self.hop_length,
        )  # (B, n_mfcc, T)
        feats = feats.transpose(-1, -2)  # (B, T, n_mfcc)
        if feats.shape[-2] != self.out_dim:
            feats = dsp.interp_bilinear(feats, self.out_dim, self.n_mfcc, align_corners=False)
        return feats.detach()


class Wav2VecExtractor(nn.Module):
    """wav2vec2-base hidden states, resized to (out_dim, n_feature).

    As the reference: resample to 16 kHz, zero-mean/unit-var normalization,
    the wav2vec2 encoder in eval mode (the port's ``Wav2Vec2Encoder``, so
    its self-attention goes through the flash-attention kernel on the card),
    then a bilinear resize of the (768, T) image to (out_dim, n_feature).

    Weights: ``state_dict`` (the port encoder's names, e.g. from
    ``compat.wav2vec2_convert.convert_wav2vec2``), or a random init from
    ``seed``. ``dtype`` is the compute dtype (default f32, as the JAX
    frame predictor builds it). ``config`` narrows the encoder (tests)."""

    def __init__(
        self,
        sample_rate: int,
        n_feature: int,
        out_dim: int,
        *args,
        state_dict: Optional[dict] = None,
        seed: int = 0,
        dtype: Optional[torch.dtype] = None,
        config=None,
        **kwargs,
    ):
        super().__init__()
        from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

        self.ori_sample_rate = sample_rate
        self.sample_rate = 16000
        self.out_dim = out_dim
        self.n_feature = n_feature
        self.dtype = dtype
        self.config = config if config is not None else Wav2Vec2Config()
        self.model = Wav2Vec2Encoder(self.config)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            self.model.init_parameters(torch.Generator().manual_seed(seed))
        self.model.eval()

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dsp.resample(x, self.ori_sample_rate, self.sample_rate)
        x = dsp.wav2vec2_zero_mean_unit_var(x)
        hidden = self.model(x, dtype=self.dtype or torch.float32)  # (B, T, 768)
        feats = hidden.float().transpose(1, 2)  # (B, 768, T)
        if feats.shape[1] != self.out_dim:
            feats = dsp.interp_bilinear(feats, self.out_dim, self.n_feature, align_corners=False)
        return feats.detach()

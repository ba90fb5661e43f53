"""Plain Audio2Mesh on MFCC features in f32 PyTorch: one clip's audio to
its per-frame vertices.

Follows Karras et al., "Audio-Driven Facial Animation by Joint End-to-End
Learning of Pose and Emotion" (SIGGRAPH 2017) as the repo's default
``config.yaml`` configures it:

- frame f (60 fps) sees the 0.52 s of audio starting at sample
  f * sr // 60 of the clip with 0.26 s of zeros before it and zeros after
  its end, i.e. the window centred on the frame's time;
- MFCC as ``torchaudio.transforms.MFCC`` with the configuration's melkwargs:
  a centred STFT (reflect pad n_fft / 2, periodic Hann window of
  ``win_length`` zero-padded to ``n_fft``), the power spectrum, an HTK mel
  filterbank (128 mels, 0 to sr/2, no norm), 10 log10 (floor 1e-10, no
  top_db clamp, as the repo states it), an orthonormal DCT-II; the (53, 32)
  image resized to (52, 32) by bilinear interpolation (align_corners off);
- the network: the 12-wide one-hot tiled below the 52 feature rows; five
  (1, 3)/(1, 2) analysis convs (72, 108, 162, 243, 256 channels) and three
  (3, 1)/(2, 1) articulation convs, each with batch norm (eval: running
  statistics) and ReLU; batch norm, a (3, 1)/(2, 1) conv, ReLU; batch norm,
  a (4, 1)/(4, 1) conv, ReLU; the vertex MLP 268 -> 72 -> 128 -> tanh -> 50
  -> V on the features beside the one-hot; the template added;
- the predictor's unit convention: template x ``unit_scale`` in, vertices
  / ``unit_scale`` out.

Weights are a dict under the port's parameter names; ``quant`` rounds both
operands of every product (the control's fp8).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import Quant, conv2d, linear, q


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """HTK triangular filters over FFT bins linspace(0, sr/2), (n_freqs, n_mels)."""
    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_max = 2595.0 * math.log10(1.0 + (sample_rate / 2.0) / 700.0)
    pts = 700.0 * (10.0 ** (np.linspace(0.0, m_max, n_mels + 2) / 2595.0) - 1.0)
    diff = np.diff(pts)
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def dct_ortho(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n_mels, n_mfcc)."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    basis = np.cos(math.pi / n_mels * (n + 0.5) * k) * math.sqrt(2.0 / n_mels)
    basis[0] /= math.sqrt(2.0)
    return basis.T


class Features:
    """The MFCC image of 0.52 s windows, constants built once."""

    def __init__(self, cfg: dict, device, quant: Quant = None):
        self.cfg, self.quant = cfg, quant
        n_fft, win = cfg["n_fft"], cfg["win_length"]
        hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * np.arange(win) / win)
        left = (n_fft - win) // 2
        window = np.zeros(n_fft)
        window[left : left + win] = hann
        f32 = dict(dtype=torch.float32, device=device)
        self.window = torch.tensor(window, **f32)
        self.mel = torch.tensor(mel_filterbank(n_fft // 2 + 1, cfg["n_mels"], cfg["sample_rate"]), **f32)
        self.dct = torch.tensor(dct_ortho(cfg["n_feature"], cfg["n_mels"]), **f32)

    def __call__(self, frags: torch.Tensor) -> torch.Tensor:
        """(N, window) audio -> (N, out_dim, n_feature)."""
        cfg = self.cfg
        n_fft, hop = cfg["n_fft"], cfg["hop_length"]
        x = F.pad(frags[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        frames = x.unfold(-1, n_fft, hop)  # (N, T, n_fft)
        power = torch.fft.rfft(frames * self.window, dim=-1).abs() ** 2
        mel = torch.matmul(q(power, self.quant), q(self.mel, self.quant))  # (N, T, mels)
        db = 10.0 * torch.log10(mel.clamp(min=1e-10))
        mfcc = torch.matmul(q(db, self.quant), q(self.dct, self.quant))  # (N, T, n_mfcc)
        return F.interpolate(mfcc[:, None], size=(cfg["out_dim"], cfg["n_feature"]),
                             mode="bilinear", align_corners=False)[:, 0]


def batch_norm(x: torch.Tensor, w: dict, name: str) -> torch.Tensor:
    p = name + ".bn."
    return F.batch_norm(x, w[p + "running_mean"], w[p + "running_var"], w[p + "weight"],
                        w[p + "bias"], training=False, eps=1e-5)


def network(w: dict, feats: torch.Tensor, one_hot: torch.Tensor, template: torch.Tensor,
            cfg: dict, quant: Quant = None) -> torch.Tensor:
    """(N, 52, 32) features, (N, 12) one-hots, (V, 3) template -> (N, V, 3)."""
    n, n_styles = one_hot.shape[0], cfg["n_styles"]
    width = feats.shape[2]
    tiled = one_hot.repeat(1, width).reshape(n, n_styles, width)
    h = torch.cat([feats, tiled], dim=1)[:, None]  # (N, 1, 64, 32)

    def conv(h, name, stride, pad):
        return conv2d(h, w[name + ".conv.weight"], w[name + ".conv.bias"], quant,
                      stride=stride, padding=pad)

    for i in range(len(cfg["analysis_channels"])):
        h = F.relu(batch_norm(conv(h, f"analysis{i}", (1, 2), (0, 1)), w, f"analysis{i}_bn"))
    for i in range(3):
        h = F.relu(batch_norm(conv(h, f"artic{i}", (2, 1), (1, 0)), w, f"artic{i}_bn"))
    h = F.relu(conv(batch_norm(h, w, "artic3_pre_bn"), "artic3", (2, 1), (1, 0)))
    h = F.relu(conv(batch_norm(h, w, "artic4_pre_bn"), "artic4", (4, 1), (0, 0)))
    h = torch.cat([h.reshape(n, -1), one_hot], dim=1)

    def fc(x, i):
        return linear(x, w[f"output.fc{i}.weight"], w[f"output.fc{i}.bias"], quant)

    out = fc(fc(torch.tanh(fc(fc(h, 0), 1)), 2), 3)
    scale = cfg["unit_scale"]
    return (out + template.reshape(1, -1) * scale).reshape(n, -1, 3) / scale


def fragments(audio: torch.Tensor, frames: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The 0.52 s windows centred on ``frames`` of one clip, (F, window)."""
    sr, fps = cfg["sample_rate"], cfg["fps"]
    half = int(sr * cfg["window_seconds"] / 2)
    padded = F.pad(audio, (half, 2 * half))
    starts = frames * sr // fps
    idx = starts[:, None] + torch.arange(2 * half, device=audio.device)[None]
    return padded[idx]


@torch.no_grad()
def predict_clips(w: dict, audios: list, one_hot: torch.Tensor, templates: list, cfg: dict,
                  quant: Quant = None, rows: int = 2048) -> list:
    """Whole clips -> (T_i, V, 3) per-frame vertices, ``rows`` frames at a time."""
    dev = one_hot.device
    feats_of = Features(cfg, dev, quant)
    out = []
    for i, a in enumerate(audios):
        audio = torch.as_tensor(a, device=dev).float()
        n_frames = audio.shape[0] * cfg["fps"] // cfg["sample_rate"]
        tmpl = torch.as_tensor(templates[i], device=dev).float()
        parts = []
        for lo in range(0, n_frames, rows):
            f = torch.arange(lo, min(n_frames, lo + rows), device=dev)
            feats = feats_of(fragments(audio, f, cfg))
            parts.append(network(w, feats, one_hot[i : i + 1].expand(len(f), -1).float(), tmpl,
                                 cfg, quant))
        out.append(torch.cat(parts))
    return out

"""Plain FaceFormer (vocaset) with the WavLM Large speech encoder, in f32
PyTorch: one clip's audio to its vertex animation.

The encoder follows Chen et al., "WavLM: Large-Scale Self-Supervised
Pre-Training for Full Stack Speech Processing" (arXiv:2110.13900), as HF
``WavLMModel`` computes it in eval mode with the ``microsoft/wavlm-large``
config (``feat_extract_norm="layer"``, ``do_stable_layer_norm=True``):

- the waveform normalized to zero mean and unit variance (the
  Wav2Vec2Processor of FaceFormer's code, eps 1e-7);
- seven convolutions (512 channels, kernels 10,3,3,3,3,2,2, strides
  5,2,2,2,2,2,2, no bias), each followed by a LayerNorm over its channels
  and exact GELU (``WavLMLayerNormConvLayer``);
- FaceFormer's fps adapter (``faceformer.py`` beside this file): the 50 fps
  latents linearly interpolated (align_corners) to samples * fps // 16000
  frames, before the feature projection;
- LayerNorm(512) and the 512 -> 1024 projection; the grouped positional
  conv (kernel 128, 16 groups, padding 64, the last step dropped), GELU,
  added; no LayerNorm before the layers;
- 24 pre-LN layers (``WavLMEncoderLayerStableLayerNorm``): x^ = LN(x); in
  head h the scores ``q_i . k_j / 8 + g[h, i] * E[bucket(j - i), h]``, with
  E layer 0's (320, 16) table (every layer reads it) and the gate ``g = a (b
  c_h - 1) + 2``, ``(a, b)`` the sigmoid of ``gru_rel_pos_linear`` (64 -> 8)
  on the head's 64 channels of x^, its 8 outputs summed in two groups of 4
  (``WavLMAttention``); softmax; x += out_proj; x += FFN(LN(x)) (4096,
  exact GELU); then the encoder's LayerNorm;
- the buckets: T5's bidirectional ones, 160 a side, exact below 80,
  logarithmic to ``max_bucket_distance`` 800 (HF's
  ``_relative_positions_bucket``, in its float32 operations).

The dense (16, T, T) bias is built for each clip alone, once, and gated in
each layer; clips are encoded one at a time, so a 60 s clip (T = 3600)
takes a few GB. Then FaceFormer's vocaset decoder, vertex head and unit
convention, as ``faceformer.py`` computes them (its ``cross_term``,
``decode`` and ``vertices``).

Weights are a dict under the port's parameter names (the benchmark's
weight maker makes them; nothing is read from the program): the conv
norms ``feature_encoder.layer_norms.{i}``, each layer's
``gru_rel_pos_linear`` and ``gru_rel_pos_const`` (one a head) and the
table ``rel_attn_embed.weight``. ``quant`` rounds both operands of every
product (the control's fp8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import faceformer as ff
from benchmark.reference.common import Quant, conv1d, linear, q

ENC = ff.ENC


def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF ``WavLMAttention._relative_positions_bucket`` of ``rel = key -
    query``."""
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = torch.abs(rel)
    exact = half // 2
    large = torch.log(rel.float() / exact)
    large = large / math.log(max_distance / exact)
    large = large * (half - exact)
    large = (exact + large).to(torch.long)
    large = torch.min(large, torch.full_like(large, half - 1))
    return out + torch.where(rel < exact, rel, large)


def position_bias(w: dict, t: int, enc: dict) -> torch.Tensor:
    """(heads, T, T): ``E[bucket(j - i), h]`` at query i, key j."""
    table = w[f"{ENC}rel_attn_embed.weight"]
    pos = torch.arange(t, device=table.device)
    rel = pos[None, :] - pos[:, None]
    return table[bucket(rel, enc["num_buckets"], enc["max_bucket_distance"])].permute(2, 0, 1)


def conv_features(w: dict, x: torch.Tensor, enc: dict, quant: Quant = None) -> torch.Tensor:
    """(1, samples) audio -> (1, T50, 512) latents: each conv, a LayerNorm
    over channels, GELU."""
    h = x[:, None, :]
    for i, s in enumerate(enc["conv_stride"]):
        h = conv1d(h, w[f"{ENC}feature_encoder.conv_layers.{i}.weight"], None, quant, stride=s)
        h = ff.layer_norm(h.transpose(1, 2), w, f"{ENC}feature_encoder.layer_norms.{i}",
                          enc["layer_norm_eps"]).transpose(1, 2)
        h = F.gelu(h)
    return h.transpose(1, 2)


def project(w: dict, latents: torch.Tensor, enc: dict, quant: Quant = None) -> torch.Tensor:
    """(1, T, 512) latents -> (1, T, 1024): the feature projection."""
    h = ff.layer_norm(latents, w, f"{ENC}feature_projection.layer_norm", enc["layer_norm_eps"])
    return linear(h, w[f"{ENC}feature_projection.projection.weight"],
                  w[f"{ENC}feature_projection.projection.bias"], quant)


def encoder_layer(w: dict, h: torch.Tensor, i: int, bias: torch.Tensor, enc: dict,
                  quant: Quant = None) -> torch.Tensor:
    """One pre-LN layer on (1, T, d), with the ungated (heads, T, T) bias."""
    p = f"{ENC}layers.{i}."
    b, t, d = h.shape
    nh = enc["num_attention_heads"]
    hd = d // nh
    eps = enc["layer_norm_eps"]

    def proj(x, name):
        return linear(x, w[p + name + ".weight"], w[p + name + ".bias"], quant)

    def heads(x):
        return x.reshape(b, t, nh, hd).transpose(1, 2)

    x = ff.layer_norm(h, w, p + "layer_norm", eps)
    gates = proj(heads(x), "gru_rel_pos_linear").reshape(b, nh, t, 2, 4).sum(-1)
    gate_a, gate_b = torch.sigmoid(gates).chunk(2, dim=-1)  # (B, H, T, 1) each
    const = w[p + "gru_rel_pos_const"].reshape(1, nh, 1, 1)
    gate = gate_a * (gate_b * const - 1.0) + 2.0
    qh = heads(proj(x, "q_proj")) * hd ** -0.5
    kh, vh = heads(proj(x, "k_proj")), heads(proj(x, "v_proj"))
    scores = torch.matmul(q(qh, quant), q(kh, quant).transpose(-1, -2)) + gate * bias[None]
    probs = scores.softmax(dim=-1)
    attn = torch.matmul(q(probs, quant), q(vh, quant))
    h = h + proj(attn.transpose(1, 2).reshape(b, t, d), "out_proj")
    x = ff.layer_norm(h, w, p + "final_layer_norm", eps)
    return h + proj(F.gelu(proj(x, "intermediate_dense")), "output_dense")


def transformer(w: dict, h: torch.Tensor, enc: dict, quant: Quant = None) -> torch.Tensor:
    """(1, T, d) projected features -> (1, T, d) hidden states: the
    positional conv, the layers, the encoder's LayerNorm."""
    k = enc["num_conv_pos_embeddings"]
    pos = conv1d(h.transpose(1, 2), w[f"{ENC}pos_conv_embed.conv.weight"],
                 w[f"{ENC}pos_conv_embed.conv.bias"], quant, padding=k // 2,
                 groups=enc["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    bias = position_bias(w, h.shape[1], enc)
    for i in range(enc["num_hidden_layers"]):
        h = encoder_layer(w, h, i, bias, enc, quant)
    return ff.layer_norm(h, w, f"{ENC}layer_norm", enc["layer_norm_eps"])


def encode(w: dict, audio: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """One clip's audio (samples,) at 16 kHz -> (T, 1024) hidden states at
    the clip's frame count, samples * fps // sample_rate."""
    enc = cfg["wavlm"]
    t = audio.shape[-1] * cfg["fps"] // cfg["sample_rate"]
    h = conv_features(w, ff.zero_mean_unit_var(audio.float()[None]), enc, quant)
    h = F.interpolate(h.transpose(1, 2), size=t, mode="linear", align_corners=True).transpose(1, 2)
    return transformer(w, project(w, h, enc, quant), enc, quant)[0]


@torch.no_grad()
def predict_clips(w: dict, audios: list, one_hot: torch.Tensor, templates: list, cfg: dict,
                  quant: Quant = None) -> list:
    """Whole clips -> their (T_i, V, 3) vertex animations, on the device of
    ``one_hot``. Each clip is encoded alone at its own length; the decoder
    runs the clips side by side, each row on its own (rows past a clip's
    end are dropped)."""
    dev = one_hot.device
    crosses = [ff.cross_term(w, encode(w, torch.as_tensor(a, device=dev), cfg, quant), quant)
               for a in audios]
    t_max = max(c.shape[0] for c in crosses)
    cross = torch.zeros(len(audios), t_max, cfg["feature_dim"], device=dev)
    for i, c in enumerate(crosses):
        cross[i, : c.shape[0]] = c
    hs = ff.decode(w, one_hot, cross, cfg, quant)
    return [ff.vertices(w, hs[i, : c.shape[0]], torch.as_tensor(templates[i], device=dev), cfg,
                        quant)
            for i, c in enumerate(crosses)]

"""Plain FaceFormer (vocaset) with the wav2vec2-Conformer Large speech
encoder (relative positions), in f32 PyTorch: one clip's audio to its
vertex animation.

The encoder follows HF ``Wav2Vec2ConformerModel`` in eval mode with the
``facebook/wav2vec2-conformer-rel-pos-large`` config: the Conformer block
of Gulati et al. (arXiv:2005.08100) with Transformer-XL relative-position
attention (Dai et al., arXiv:1901.02860 §3.3, ESPnet's form):

- the waveform normalized to zero mean and unit variance (the
  Wav2Vec2Processor of FaceFormer's code, eps 1e-7);
- seven convolutions (512 channels, kernels 10,3,3,3,3,2,2, strides
  5,2,2,2,2,2,2, with bias), each followed by a LayerNorm over its
  channels and exact GELU (``Wav2Vec2ConformerLayerNormConvLayer``);
- FaceFormer's fps adapter (``faceformer.py`` beside this file): the 50 fps
  latents linearly interpolated (align_corners) to samples * fps // 16000
  frames, before the feature projection;
- LayerNorm(512) and the 512 -> 1024 projection (``faceformer_wavlm.py``'s
  ``project``); no positional conv (HF builds it and never calls it);
- the sinusoid ``pe`` of the offsets T - 1 .. -(T - 1)
  (``Wav2Vec2ConformerRelPositionalEmbedding``);
- 24 blocks (``Wav2Vec2ConformerEncoderLayer``): x += FFN1(LN(x)) / 2; x +=
  MHSA(LN(x)), whose scores are ``((q + u) k^T + shift((q + v) R^T)) / 8``
  with ``R = linear_pos(pe)`` split into 16 heads of 64, the (T, 2T - 1)
  product materialised and shifted as HF's ``_apply_relative_embeddings``
  does; x += Conv(x) (LN, pointwise 1024 -> 2048, GLU, depthwise conv of
  kernel 31 with padding 15, eval BatchNorm with eps 1e-5, SiLU, pointwise
  1024 -> 1024, the convs without bias); x = LN(x + FFN2(LN(x)) / 2);
  the FFNs 4096 wide with swish (SiLU);
- one LayerNorm after the stack.

Clips are encoded one at a time and unpadded, so a 60 s clip (T = 3600)
takes a few GB. On a padded batch HF's depthwise conv would read padded
frames into the last 15 valid ones; the program gives each clip the answer
of the clip alone, which is this reference's, so the comparison holds the
program to the clip alone. Then FaceFormer's vocaset decoder, vertex head
and unit convention, as ``faceformer.py`` computes them.

Weights are a dict under the port's parameter names (the benchmark's
weight maker makes them; nothing is read from the program): the pointwise
convs as (out, in) matrices, the BatchNorm's running statistics beside its
affine. ``quant`` rounds both operands of every product (the control's
fp8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import faceformer as ff
from benchmark.reference import faceformer_wavlm as wavlm
from benchmark.reference.common import Quant, conv1d, linear, q

ENC = ff.ENC
BATCH_NORM_EPS = 1e-5


def conv_features(w: dict, x: torch.Tensor, enc: dict, quant: Quant = None) -> torch.Tensor:
    """(1, samples) audio -> (1, T50, 512) latents: each conv with its bias,
    a LayerNorm over channels, GELU."""
    h = x[:, None, :]
    for i, s in enumerate(enc["conv_stride"]):
        p = f"{ENC}feature_encoder.conv_layers.{i}"
        h = conv1d(h, w[p + ".weight"], w.get(p + ".bias"), quant, stride=s)
        h = ff.layer_norm(h.transpose(1, 2), w, f"{ENC}feature_encoder.layer_norms.{i}",
                          enc["layer_norm_eps"]).transpose(1, 2)
        h = F.gelu(h)
    return h.transpose(1, 2)


def relative_sinusoid(t: int, d: int, device) -> torch.Tensor:
    """(2t - 1, d): HF's ``pe`` rows for the offsets t - 1 down to -(t - 1)."""
    pos = torch.arange(0, t, dtype=torch.int64, device=device).float().unsqueeze(1)
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.int64, device=device).float()
                    * -(math.log(10000.0) / d))
    pe_pos = torch.zeros(t, d, device=device)
    pe_neg = torch.zeros(t, d, device=device)
    pe_pos[:, 0::2] = torch.sin(pos * div)
    pe_pos[:, 1::2] = torch.cos(pos * div)
    pe_neg[:, 0::2] = torch.sin(-1 * pos * div)
    pe_neg[:, 1::2] = torch.cos(-1 * pos * div)
    return torch.cat([torch.flip(pe_pos, [0]), pe_neg[1:]])


def attention(w: dict, x: torch.Tensor, p: str, pe: torch.Tensor, enc: dict,
              quant: Quant = None) -> torch.Tensor:
    """HF ``Wav2Vec2ConformerSelfAttention`` with relative positions on
    (1, T, d)."""
    b, t, d = x.shape
    nh = enc["num_attention_heads"]
    hd = d // nh

    def proj(y, name, bias=True):
        return linear(y, w[p + name + ".weight"], w[p + name + ".bias"] if bias else None, quant)

    qh = proj(x, "linear_q").view(b, t, nh, hd)
    kh = proj(x, "linear_k").view(b, t, nh, hd).transpose(1, 2)
    vh = proj(x, "linear_v").view(b, t, nh, hd).transpose(1, 2)
    u, v = w[p + "pos_bias_u"], w[p + "pos_bias_v"]
    rel = proj(pe[None], "linear_pos", bias=False).view(1, -1, nh, hd).transpose(1, 2).transpose(2, 3)
    q_u = (qh + u).transpose(1, 2)
    q_v = (qh + v).transpose(1, 2)
    ac = torch.matmul(q(q_u, quant), q(kh, quant).transpose(-2, -1))
    bd = torch.matmul(q(q_v, quant), q(rel, quant))  # (B, H, T, 2T - 1)
    pad = torch.zeros((*bd.shape[:3], 1), device=bd.device, dtype=bd.dtype)
    padded = torch.cat([pad, bd], dim=-1).view(*bd.shape[:2], bd.shape[3] + 1, bd.shape[2])
    bd = padded[:, :, 1:].view_as(bd)[:, :, :, : bd.shape[-1] // 2 + 1]
    probs = ((ac + bd) / math.sqrt(hd)).softmax(dim=-1)
    out = torch.matmul(q(probs, quant), q(vh, quant)).transpose(1, 2).reshape(b, t, d)
    return proj(out, "linear_out")


def conv_module(w: dict, x: torch.Tensor, p: str, enc: dict, quant: Quant = None) -> torch.Tensor:
    """HF ``Wav2Vec2ConformerConvolutionModule`` on (1, T, d)."""
    k = enc["conv_depthwise_kernel_size"]
    h = ff.layer_norm(x, w, p + "layer_norm", enc["layer_norm_eps"])
    h = F.glu(linear(h, w[p + "pointwise_conv1.weight"], None, quant), dim=-1).transpose(1, 2)
    h = conv1d(h, w[p + "depthwise_conv.weight"], None, quant, padding=(k - 1) // 2,
               groups=h.shape[1])
    mean, var = w[p + "batch_norm.running_mean"], w[p + "batch_norm.running_var"]
    h = ((h - mean[:, None]) / torch.sqrt(var[:, None] + BATCH_NORM_EPS)
         * w[p + "batch_norm.weight"][:, None] + w[p + "batch_norm.bias"][:, None])
    return linear(F.silu(h).transpose(1, 2), w[p + "pointwise_conv2.weight"], None, quant)


def feed_forward(w: dict, x: torch.Tensor, p: str, quant: Quant = None) -> torch.Tensor:
    h = F.silu(linear(x, w[p + "intermediate_dense.weight"], w[p + "intermediate_dense.bias"],
                      quant))
    return linear(h, w[p + "output_dense.weight"], w[p + "output_dense.bias"], quant)


def block(w: dict, h: torch.Tensor, i: int, pe: torch.Tensor, enc: dict,
          quant: Quant = None) -> torch.Tensor:
    """One Conformer block on (1, T, d)."""
    p = f"{ENC}layers.{i}."
    eps = enc["layer_norm_eps"]
    h = h + 0.5 * feed_forward(w, ff.layer_norm(h, w, p + "ffn1_layer_norm", eps), p + "ffn1.",
                               quant)
    h = h + attention(w, ff.layer_norm(h, w, p + "self_attn_layer_norm", eps), p + "self_attn.",
                      pe, enc, quant)
    h = h + conv_module(w, h, p + "conv_module.", enc, quant)
    h = h + 0.5 * feed_forward(w, ff.layer_norm(h, w, p + "ffn2_layer_norm", eps), p + "ffn2.",
                               quant)
    return ff.layer_norm(h, w, p + "final_layer_norm", eps)


def encode(w: dict, audio: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """One clip's audio (samples,) at 16 kHz -> (T, 1024) hidden states at
    the clip's frame count, samples * fps // sample_rate."""
    enc = cfg["conformer"]
    t = audio.shape[-1] * cfg["fps"] // cfg["sample_rate"]
    h = conv_features(w, ff.zero_mean_unit_var(audio.float()[None]), enc, quant)
    h = F.interpolate(h.transpose(1, 2), size=t, mode="linear", align_corners=True).transpose(1, 2)
    h = wavlm.project(w, h, enc, quant)
    pe = relative_sinusoid(t, enc["hidden_size"], h.device)
    for i in range(enc["num_hidden_layers"]):
        h = block(w, h, i, pe, enc, quant)
    return ff.layer_norm(h, w, f"{ENC}layer_norm", enc["layer_norm_eps"])[0]


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

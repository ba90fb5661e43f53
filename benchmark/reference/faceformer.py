"""Plain FaceFormer (vocaset) in f32 PyTorch: wav2vec2-base, then the
autoregressive decoder, one clip's audio to its vertex animation.

Follows Fan et al., "FaceFormer: Speech-Driven 3D Facial Animation with
Transformers" (CVPR 2022, arXiv:2112.05329) and its public code, with the
wav2vec2-base encoder of Baevski et al. (arXiv:2006.11477) as HF
``Wav2Vec2Model`` computes it in eval mode:

- the waveform normalized to zero mean and unit variance (the
  Wav2Vec2Processor, eps 1e-7);
- seven convolutions (512 channels, kernels 10,3,3,3,3,2,2, strides
  5,2,2,2,2,2,2, no bias), a per-channel group norm over time after the
  first, exact GELU after each;
- FaceFormer's fps adapter: linear interpolation (align_corners) of the
  50 fps latents to the clip's frame count, samples * fps // 16000 (the
  configuration's fps and PPE period: 60 and 60 here, as the repo
  configures FaceFormer; the paper's public vocaset code runs 30 and 30);
- layer norm and the 512 -> 768 projection; the grouped positional conv
  (kernel 128, 16 groups, padding 64, the last step dropped), GELU, added;
  a layer norm; twelve post-LN layers (12 heads, FFN 3072, exact GELU);
- the audio map 768 -> 64. The vocaset memory mask lets frame t see only
  latent t, so the cross attention's softmax over one key is 1 and its
  output is ``out_proj(v_proj(memory_t))``;
- the decoder, one frame a step: input x_t = emb_t + PPE[t mod period]; one
  post-LN ``TransformerDecoderLayer`` (d 64, 4 heads, FFN 128, ReLU, eps
  1e-5) with the biased causal mask ``-slope_h * floor((t - j) / period)``,
  slopes 2^-2, 2^-4, 2^-6, 2^-8; emb_0 = style = obj_vector(one_hot) and
  emb_{t+1} = vertice_map(vertice_map_r(h_t)) + style, with the full
  15069-wide vertex in between;
- vertices: vertice_map_r(h_t) + template, under the predictor's unit
  convention (template x ``unit_scale`` in, vertices / ``unit_scale``
  out).

The decoder keeps each step's keys and values: one decoder layer under a
causal mask gives every earlier position the same output whether the
sequence is re-decoded or extended, so this equals the paper's loop that
re-decodes the whole prefix each frame.

Weights are a dict under the port's parameter names (the benchmark's
weight maker makes them; nothing is read from the program). ``quant``
rounds both operands of every product (the control's fp8).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.common import Quant, conv1d, linear

ENC = "audio_encoder."


def zero_mean_unit_var(x: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + 1e-7)


def conv_features(w: dict, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """(1, samples) normalized audio -> (1, T50, 512) latents."""
    h = x[:, None, :]
    w2v = cfg["wav2vec2"]
    for i, s in enumerate(w2v["conv_stride"]):
        h = conv1d(h, w[f"{ENC}feature_encoder.conv_layers.{i}.weight"], None, quant, stride=s)
        if i == 0:
            mean = h.mean(dim=2, keepdim=True)
            var = h.var(dim=2, keepdim=True, unbiased=False)
            h = (h - mean) / torch.sqrt(var + w2v["layer_norm_eps"])
            h = (h * w[f"{ENC}feature_encoder.group_norm.weight"][:, None]
                 + w[f"{ENC}feature_encoder.group_norm.bias"][:, None])
        h = F.gelu(h)
    return h.transpose(1, 2)


def layer_norm(x, w, prefix, eps):
    return F.layer_norm(x, x.shape[-1:], w[prefix + ".weight"], w[prefix + ".bias"], eps)


def encoder_layer(w: dict, h: torch.Tensor, i: int, cfg: dict, quant: Quant = None):
    w2v = cfg["wav2vec2"]
    p = f"{ENC}layers.{i}."
    b, t, d = h.shape
    nh = w2v["num_attention_heads"]
    hd = d // nh

    def proj(x, name):
        return linear(x, w[p + name + ".weight"], w[p + name + ".bias"], quant)

    def heads(x):
        return x.reshape(b, t, nh, hd).transpose(1, 2)

    qh = heads(proj(h, "q_proj")) * hd ** -0.5
    kh, vh = heads(proj(h, "k_proj")), heads(proj(h, "v_proj"))
    scores = torch.matmul(quant(qh) if quant else qh, (quant(kh) if quant else kh).transpose(-1, -2))
    probs = scores.softmax(dim=-1)
    attn = torch.matmul(quant(probs) if quant else probs, quant(vh) if quant else vh)
    attn = proj(attn.transpose(1, 2).reshape(b, t, d), "out_proj")
    eps = w2v["layer_norm_eps"]
    h = layer_norm(h + attn, w, p + "layer_norm", eps)
    ff = proj(F.gelu(proj(h, "intermediate_dense")), "output_dense")
    return layer_norm(h + ff, w, p + "final_layer_norm", eps)


def encode(w: dict, audio: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """One clip's audio (samples,) at 16 kHz -> (T, 768) hidden states at
    the clip's frame count, samples * fps // sample_rate."""
    w2v = cfg["wav2vec2"]
    t = audio.shape[-1] * cfg["fps"] // cfg["sample_rate"]
    h = conv_features(w, zero_mean_unit_var(audio.float()[None]), cfg, quant)
    h = F.interpolate(h.transpose(1, 2), size=t, mode="linear", align_corners=True).transpose(1, 2)
    eps = w2v["layer_norm_eps"]
    h = layer_norm(h, w, f"{ENC}feature_projection.layer_norm", eps)
    h = linear(h, w[f"{ENC}feature_projection.projection.weight"],
               w[f"{ENC}feature_projection.projection.bias"], quant)
    k = w2v["num_conv_pos_embeddings"]
    pos = conv1d(h.transpose(1, 2), w[f"{ENC}pos_conv_embed.conv.weight"],
                 w[f"{ENC}pos_conv_embed.conv.bias"], quant, padding=k // 2,
                 groups=w2v["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    h = layer_norm(h, w, f"{ENC}layer_norm", eps)
    for i in range(w2v["num_hidden_layers"]):
        h = encoder_layer(w, h, i, cfg, quant)
    return h[0]


def cross_term(w: dict, hidden: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """(T, 768) -> (T, 64): the diagonal cross attention's output."""
    memory = linear(hidden, w["audio_feature_map.weight"], w["audio_feature_map.bias"], quant)
    v = linear(memory, w["cross_v.weight"], w["cross_v.bias"], quant)
    return linear(v, w["cross_out.weight"], w["cross_out.bias"], quant)


def ppe_table(period: int, d: int) -> torch.Tensor:
    """FaceFormer's periodic positional encoding, one period of sinusoids."""
    position = np.arange(period, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((period, d))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.tensor(pe, dtype=torch.float32)


def alibi_slopes(n_heads: int) -> torch.Tensor:
    start = 2.0 ** (-(2.0 ** -(math.log2(n_heads) - 3)))
    return torch.tensor([start * start ** i for i in range(n_heads)], dtype=torch.float32)


def decode(w: dict, one_hot: torch.Tensor, cross: torch.Tensor, cfg: dict,
           quant: Quant = None) -> torch.Tensor:
    """The decoder for a batch of independent clips, one step at a time,
    keeping each step's keys and values: ``cross`` (B, T, 64), the cross
    term of every frame -> (B, T, 64) decoder outputs h_t."""
    b, n, d = cross.shape
    nh = cfg["n_head"]
    hd, eps, period = d // nh, 1e-5, cfg["period"]
    dev = cross.device
    pe = ppe_table(period, d).to(dev)
    slopes = alibi_slopes(nh).to(dev)
    k_cache = torch.zeros(b, nh, n, hd, device=dev)
    v_cache = torch.zeros_like(k_cache)

    def lin(x, name):
        return linear(x, w[name + ".weight"], w[name + ".bias"], quant)

    def ln(x, name):
        return F.layer_norm(x, (d,), w[name + ".weight"], w[name + ".bias"], eps)

    style = linear(one_hot.float(), w["obj_vector.weight"], None, quant)
    emb = style
    outs = []
    for t in range(n):
        x = emb + pe[t % period]
        k_cache[:, :, t] = lin(x, "dec_k").reshape(b, nh, hd)
        v_cache[:, :, t] = lin(x, "dec_v").reshape(b, nh, hd)
        qh = lin(x, "dec_q").reshape(b, nh, 1, hd) / math.sqrt(hd)
        keys, vals = k_cache[:, :, : t + 1], v_cache[:, :, : t + 1]
        if quant is not None:
            qh, keys, vals = quant(qh), quant(keys), quant(vals)
        dist = torch.div(t - torch.arange(t + 1, device=dev), period, rounding_mode="floor")
        bias = -slopes[:, None] * dist[None].float()  # (H, t+1)
        scores = torch.matmul(qh, keys.transpose(-1, -2))[:, :, 0] + bias[None]
        probs = scores.softmax(dim=-1)
        if quant is not None:
            probs = quant(probs)
        attn = torch.matmul(probs[:, :, None], vals).reshape(b, d)
        h = ln(x + lin(attn, "dec_out"), "norm1")
        h = ln(h + cross[:, t], "norm2")
        h = ln(h + lin(F.relu(lin(h, "linear1")), "linear2"), "norm3")
        emb = lin(lin(h, "vertice_map_r"), "vertice_map") + style
        outs.append(h)
    return torch.stack(outs, dim=1)


def vertices(w: dict, hs: torch.Tensor, template: torch.Tensor, cfg: dict,
             quant: Quant = None) -> torch.Tensor:
    """(F, 64) decoder outputs, (V, 3) template -> (F, V, 3) vertices in
    data units."""
    scale = cfg["unit_scale"]
    motion = linear(hs, w["vertice_map_r.weight"], w["vertice_map_r.bias"], quant)
    return ((motion + template.reshape(1, -1) * scale) / scale).reshape(hs.shape[0], -1, 3)


@torch.no_grad()
def predict_clips(w: dict, audios: list, one_hot: torch.Tensor, templates: list, cfg: dict,
                  quant: Quant = None) -> list:
    """Whole clips -> their (T_i, V, 3) vertex animations, on the device of
    ``one_hot``. Each clip is encoded alone at its own length; the decoder
    runs the clips side by side, each row on its own (rows past a clip's
    end are dropped)."""
    dev = one_hot.device
    crosses = [cross_term(w, encode(w, torch.as_tensor(a, device=dev), cfg, quant), quant)
               for a in audios]
    t_max = max(c.shape[0] for c in crosses)
    cross = torch.zeros(len(audios), t_max, cfg["feature_dim"], device=dev)
    for i, c in enumerate(crosses):
        cross[i, : c.shape[0]] = c
    hs = decode(w, one_hot, cross, cfg, quant)
    return [vertices(w, hs[i, : c.shape[0]], torch.as_tensor(templates[i], device=dev), cfg, quant)
            for i, c in enumerate(crosses)]

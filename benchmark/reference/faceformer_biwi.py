"""Plain FaceFormer in its BIWI setting, in f32 PyTorch: wav2vec2-base, then
the autoregressive decoder at the published widths, one clip's audio to its
vertex animation.

Follows Fan et al., "FaceFormer: Speech-Driven 3D Facial Animation with
Transformers" (CVPR 2022, arXiv:2112.05329) and its public code run with
``--dataset BIWI --vertice_dim 70110 --feature_dim 128 --period 25``:

- the wav2vec2-base encoder of ``faceformer.py`` beside this file (the
  waveform normalized, seven convolutions, the feature projection, the
  positional conv, twelve post-LN layers), without the fps adapter: the
  50 fps latents stay as they are;
- the audio map 768 -> d (d = ``feature_dim``, 128);
- the encoder-decoder mask lets frame t see latents {2t, 2t+1} alone, so
  the cross attention (4 heads, queries ``cross_q`` of the decoder state,
  keys ``cross_k`` and values ``cross_v`` of the latents, then
  ``cross_out``) is a 2-way softmax per head;
- one post-LN ``TransformerDecoderLayer`` (d 128, 4 heads of 32, FFN 256,
  ReLU, eps 1e-5): self-attention under the biased causal mask
  ``-slope_h * floor((t - j) / period)`` (period 25, slopes 2^-2 ... 2^-8),
  the cross attention, the FFN; input x_t = emb_t + PPE[t mod 25];
- emb_0 = style = obj_vector(one_hot) and emb_{t+1} =
  vertice_map(vertice_map_r(h_t)) + style, the full 70,110-wide vertex in
  between;
- vertices: vertice_map_r(h_t) + template, under the predictor's unit
  convention (template x ``unit_scale`` in, vertices / ``unit_scale`` out).

The decoder keeps each step's keys and values (one causal layer: the same
as re-decoding the prefix each frame, as the paper's loop does).

Departures from the public code, each as the port computes a clip in its
predictor (and as the repo's JAX FaceFormer defines it):

- a clip of n samples has T = n * 25 // 16000 frames (the public code's
  inference decodes latents // 2), so a clip whose latents fall one short
  of 2T keeps its last frame;
- the latents a clip keeps: the public code trims them to an even count,
  capped at 2T. The predictor encodes each clip in a batch padded to an
  audio bucket (``predictor.bucket_seconds``); the clip's own latents are
  keys of the encoder's attention up to the batch's even, capped count, a
  row past them is the encoder's output at a padded position (zero after
  the feature projection, masked from the keys), and a row past the
  batch's count is zero. This reference encodes each clip as the longest
  clip of a batch padded to its own bucket, which is what the predictor
  does to it unless a longer clip's bucket is its group's. That exception
  moves the keys only of a clip that ends within 15 ms under a bucket
  boundary with an odd latent count (one key more of some 250 or more);
- the PPE and the biased mask are computed from indices: the public code's
  tables hold ``max_seq_len = 600`` frames (24 s at 25 fps), the clips here
  run to 60 s.

Weights are a dict under the port's parameter names; nothing is read from
the program. ``quant`` rounds both operands of every product (the
control's fp8).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import faceformer as ff
from benchmark.reference.common import Quant, conv1d, linear

ENC = ff.ENC


def n_latents(n_samples: int, w2v: dict) -> int:
    """Latents the conv stack makes of ``n_samples``."""
    for k, s in zip(w2v["conv_kernel"], w2v["conv_stride"]):
        n_samples = (n_samples - k) // s + 1
    return n_samples


def latent_rows(n_samples: int, cfg: dict) -> tuple[int, int]:
    """(keys, rows) of a clip in a batch padded to its own bucket: its
    latents that are keys of the encoder's attention, and the rows the
    encoder returns for it (at most 2T; rows past its keys are padded
    positions)."""
    sr, fps, w2v = cfg["sample_rate"], cfg["fps"], cfg["wav2vec2"]
    bucket = int(cfg["predictor"]["bucket_seconds"] * sr)
    padded = -(-max(n_samples, bucket) // bucket) * bucket
    batch = n_latents(padded, w2v)
    batch = min(batch - batch % 2, 2 * (padded * fps // sr))  # the batch's even, capped count
    return min(n_latents(n_samples, w2v), batch), min(batch, 2 * (n_samples * fps // sr))


def encoder_layer(w: dict, h: torch.Tensor, i: int, keys: int, cfg: dict,
                  quant: Quant = None) -> torch.Tensor:
    """``faceformer.encoder_layer`` with the attention's keys limited to
    the first ``keys`` rows."""
    w2v = cfg["wav2vec2"]
    p = f"{ENC}layers.{i}."
    b, t, d = h.shape
    nh = w2v["num_attention_heads"]
    hd = d // nh

    def proj(x, name):
        return linear(x, w[p + name + ".weight"], w[p + name + ".bias"], quant)

    def heads(x):
        return x.reshape(b, t, nh, hd).transpose(1, 2)

    def q(x):
        return quant(x) if quant else x

    qh = heads(proj(h, "q_proj")) * hd ** -0.5
    kh, vh = heads(proj(h, "k_proj"))[:, :, :keys], heads(proj(h, "v_proj"))[:, :, :keys]
    probs = torch.matmul(q(qh), q(kh).transpose(-1, -2)).softmax(dim=-1)
    attn = torch.matmul(q(probs), q(vh))
    attn = proj(attn.transpose(1, 2).reshape(b, t, d), "out_proj")
    eps = w2v["layer_norm_eps"]
    h = ff.layer_norm(h + attn, w, p + "layer_norm", eps)
    out = proj(F.gelu(proj(h, "intermediate_dense")), "output_dense")
    return ff.layer_norm(h + out, w, p + "final_layer_norm", eps)


def encode(w: dict, audio: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """One clip's audio (samples,) at 16 kHz -> (2T, 768) hidden states, the
    50 fps latents that frames 0 .. T - 1 read (``latent_rows``; rows past
    the encoder's are zero)."""
    w2v = cfg["wav2vec2"]
    n = audio.shape[-1]
    t = n * cfg["fps"] // cfg["sample_rate"]
    keys, rows = latent_rows(n, cfg)
    h = ff.conv_features(w, ff.zero_mean_unit_var(audio.float()[None]), cfg, quant)[:, :keys]
    eps = w2v["layer_norm_eps"]
    h = ff.layer_norm(h, w, f"{ENC}feature_projection.layer_norm", eps)
    h = linear(h, w[f"{ENC}feature_projection.projection.weight"],
               w[f"{ENC}feature_projection.projection.bias"], quant)
    h = F.pad(h, (0, 0, 0, max(rows - keys, 0)))  # padded positions: zero, not keys
    k = w2v["num_conv_pos_embeddings"]
    pos = conv1d(h.transpose(1, 2), w[f"{ENC}pos_conv_embed.conv.weight"],
                 w[f"{ENC}pos_conv_embed.conv.bias"], quant, padding=k // 2,
                 groups=w2v["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    h = ff.layer_norm(h, w, f"{ENC}layer_norm", eps)
    for i in range(w2v["num_hidden_layers"]):
        h = encoder_layer(w, h, i, keys, cfg, quant)
    return F.pad(h[0, :rows], (0, 0, 0, 2 * t - rows))


def decode(w: dict, one_hot: torch.Tensor, memory: torch.Tensor, cfg: dict,
           quant: Quant = None) -> torch.Tensor:
    """The decoder for a batch of independent clips, one step at a time,
    keeping each step's keys and values: ``memory`` (B, 2T, d), the audio
    map of every latent -> (B, T, d) decoder outputs h_t."""
    b, n2, d = memory.shape
    n = n2 // 2
    nh = cfg["n_head"]
    hd, eps, period = d // nh, 1e-5, cfg["period"]
    dev = memory.device
    pe = ff.ppe_table(period, d).to(dev)
    slopes = ff.alibi_slopes(nh).to(dev)
    k_cache = torch.zeros(b, nh, n, hd, device=dev)
    v_cache = torch.zeros_like(k_cache)

    def lin(x, name):
        return linear(x, w[name + ".weight"], w[name + ".bias"], quant)

    def ln(x, name):
        return F.layer_norm(x, (d,), w[name + ".weight"], w[name + ".bias"], eps)

    def q(x):
        return quant(x) if quant else x

    # every latent's cross key and value, (B, H, 2T, hd)
    mem_k = lin(memory, "cross_k").reshape(b, n2, nh, hd).transpose(1, 2)
    mem_v = lin(memory, "cross_v").reshape(b, n2, nh, hd).transpose(1, 2)
    style = linear(one_hot.float(), w["obj_vector.weight"], None, quant)
    emb = style
    outs = []
    for t in range(n):
        x = emb + pe[t % period]
        k_cache[:, :, t] = lin(x, "dec_k").reshape(b, nh, hd)
        v_cache[:, :, t] = lin(x, "dec_v").reshape(b, nh, hd)
        qh = lin(x, "dec_q").reshape(b, nh, 1, hd) / math.sqrt(hd)
        dist = torch.div(t - torch.arange(t + 1, device=dev), period, rounding_mode="floor")
        bias = -slopes[:, None] * dist[None].float()  # (H, t+1)
        scores = torch.matmul(q(qh), q(k_cache[:, :, : t + 1]).transpose(-1, -2))[:, :, 0]
        probs = (scores + bias[None]).softmax(dim=-1)
        attn = torch.matmul(q(probs)[:, :, None], q(v_cache[:, :, : t + 1])).reshape(b, d)
        h = ln(x + lin(attn, "dec_out"), "norm1")
        # frame t against latents 2t, 2t + 1: a 2-way softmax per head
        qc = lin(h, "cross_q").reshape(b, nh, 1, hd) / math.sqrt(hd)
        keys, vals = mem_k[:, :, 2 * t : 2 * t + 2], mem_v[:, :, 2 * t : 2 * t + 2]
        probs = torch.matmul(q(qc), q(keys).transpose(-1, -2)).softmax(dim=-1)  # (B, H, 1, 2)
        ca = torch.matmul(q(probs), q(vals)).reshape(b, d)
        h = ln(h + lin(ca, "cross_out"), "norm2")
        h = ln(h + lin(F.relu(lin(h, "linear1")), "linear2"), "norm3")
        emb = lin(lin(h, "vertice_map_r"), "vertice_map") + style
        outs.append(h)
    return torch.stack(outs, dim=1)


@torch.no_grad()
def predict_clips(w: dict, audios: list, one_hot: torch.Tensor, templates: list, cfg: dict,
                  quant: Quant = None) -> list:
    """Whole clips -> their (T_i, V, 3) vertex animations, on the device of
    ``one_hot``. Each clip is encoded alone; the decoder runs the clips side
    by side, each row on its own (rows past a clip's end are dropped)."""
    dev = one_hot.device
    memories = [linear(encode(w, torch.as_tensor(a, device=dev), cfg, quant),
                       w["audio_feature_map.weight"], w["audio_feature_map.bias"], quant)
                for a in audios]
    n2 = max(m.shape[0] for m in memories)
    memory = torch.zeros(len(audios), n2, cfg["feature_dim"], device=dev)
    for i, m in enumerate(memories):
        memory[i, : m.shape[0]] = m
    hs = decode(w, one_hot, memory, cfg, quant)
    return [ff.vertices(w, hs[i, : m.shape[0] // 2], torch.as_tensor(templates[i], device=dev),
                        cfg, quant)
            for i, m in enumerate(memories)]

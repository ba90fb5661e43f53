"""The wav2vec2-Conformer's blocks (relative positions), for the encoder of
``models/wav2vec2.py`` with ``layer_kind="conformer"``.

The block of Gulati et al., "Conformer: Convolution-augmented Transformer
for Speech Recognition" (arXiv:2005.08100), as HF
``Wav2Vec2ConformerEncoderLayer`` computes it in eval mode
(``facebook/wav2vec2-conformer-rel-pos-large``: hidden 1024, 16 heads of
64, FFN 4096, swish, depthwise kernel 31):

  x += FFN1(LN(x)) / 2
  x += MHSA_rel(LN(x))
  x += Conv(x)
  x = LN(x + FFN2(LN(x)) / 2)

with Conv = LN, pointwise 1024 -> 2048 (no bias), GLU, depthwise conv
(kernel 31, "same" padding, no bias), eval BatchNorm, SiLU, pointwise
1024 -> 1024 (no bias). The attention is Transformer-XL's (Dai et al.,
arXiv:1901.02860 §3.3, in ESPnet's form): in head h the score of query i and
key j is ``((q_i + u_h) . k_j + (q_i + v_h) . r_h(i - j)) / 8``, with
``r(m) = W_pos pe(m)`` the layer's projection of the sinusoid ``pe(m)[2k] =
sin(m w_k)``, ``pe(m)[2k + 1] = cos(m w_k)``, ``w_k = 10000^(-2k / d)``.
``u`` is folded into ``linear_q``'s bias, so that ``(q + v) . r = q' . r +
(v - u) . r``: the second term is a per-head table of scalars,
``(v - u)_h . W_pos,h pe(m)``, made in f32 from the (heads, d) fold of
``W_pos`` with ``v - u``. ``flash_attention`` takes ``r`` (heads, 2T - 1,
64) and the table and computes both terms inside K1: no (T, T) or
(T, 2T - 1) tensor exists. Each attention counts
``relpos_attention_layers``, each conv module ``conformer_conv_modules``
(``utils/spans.py``).

Products run on the time-major (B, T, C) layout through ``dense`` (both
pointwise convs included), in the caller's dtype; the residual stream
stays f32. The GLU, the depthwise conv (``conv1d``), the BatchNorm and the
SiLU run as PyTorch ops. A padded batch's padded frames are zeroed before
each depthwise conv, so every clip gets the answer of the clip alone (the
attention masks the padded keys; the rest is per frame). The blocks serve
only: the encoder refuses training and the parallel forms.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audio2face_tpu_torch.models.wav2vec2 import dense, layer_norm
from audio2face_tpu_torch.ops.attention import flash_attention, mha_reference
from audio2face_tpu_torch.utils import spans

BATCH_NORM_EPS = 1e-5  # nn.BatchNorm1d's, which HF's conv module keeps


def relative_sinusoid(t: int, d: int, device) -> torch.Tensor:
    """(2t - 1, d) f32: row m + t - 1 is ``pe(m)`` for m = -(t - 1) .. t - 1,
    in HF ``Wav2Vec2ConformerRelPositionalEmbedding``'s f32 operations."""
    m = torch.arange(-(t - 1), t, device=device, dtype=torch.int64).float()[:, None]
    div = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.int64).float()
                    * -(math.log(10000.0) / d))
    pe = torch.empty((2 * t - 1, d), device=device)
    pe[:, 0::2] = torch.sin(m * div)
    pe[:, 1::2] = torch.cos(m * div)
    return pe


class FeedForward(nn.Module):
    """The block's half-step FFN with swish (SiLU), as every public
    wav2vec2-Conformer has it."""

    def __init__(self, d: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, inner)
        self.output_dense = nn.Linear(inner, d)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return dense(F.silu(dense(x, self.intermediate_dense, dtype)), self.output_dense, dtype)


class EvalBatchNorm(nn.Module):
    """BatchNorm1d's parameters and running statistics, applied in eval
    mode as one f32 scale and shift a channel (time-major input)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + BATCH_NORM_EPS)
        return x.float() * scale + (self.bias - self.running_mean * scale)


class ConvModule(nn.Module):
    """The Conformer's convolution module on (B, T, C), one callable a
    block: LN, pointwise conv and GLU, depthwise conv over the valid
    frames, eval BatchNorm, SiLU, pointwise conv."""

    def __init__(self, d: int, kernel: int, eps: float):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"conv_depthwise_kernel_size {kernel}: want odd ('same' padding)")
        self.layer_norm = nn.LayerNorm(d, eps=eps)
        self.pointwise_conv1 = nn.Linear(d, 2 * d, bias=False)
        self.depthwise_conv = nn.Conv1d(d, d, kernel, padding=kernel // 2, groups=d, bias=False)
        self.batch_norm = EvalBatchNorm(d)
        self.pointwise_conv2 = nn.Linear(d, d, bias=False)

    def forward(self, x: torch.Tensor, valid: Optional[torch.Tensor], dtype: torch.dtype
                ) -> torch.Tensor:
        h = dense(layer_norm(x, self.layer_norm, dtype), self.pointwise_conv1, dtype)
        h = F.glu(h, dim=-1)
        if valid is not None:  # the clip alone: no padded frame reaches a valid one
            h = h * valid[..., None].to(h.dtype)
        conv = self.depthwise_conv
        w = conv.weight.to(dtype)
        if h.device.type == "cpu" and dtype != torch.float32:
            # the CPU's bf16 convs (oneDNN) are wrong at some shapes: f32
            # sums of the same bf16 operands
            h = F.conv1d(h.float().transpose(1, 2), w.float(), padding=conv.padding,
                         groups=conv.groups).transpose(1, 2)
        else:
            h = F.conv1d(h.transpose(1, 2), w, padding=conv.padding,
                         groups=conv.groups).transpose(1, 2)
        h = F.silu(self.batch_norm(h)).to(dtype)
        spans.count("conformer_conv_modules", 1)
        return dense(h, self.pointwise_conv2, dtype)


class RelPositionAttention(nn.Module):
    """Multi-head self-attention with Transformer-XL relative positions
    (module note)."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.num_heads = heads
        self.linear_q = nn.Linear(d, d)
        self.linear_k = nn.Linear(d, d)
        self.linear_v = nn.Linear(d, d)
        self.linear_out = nn.Linear(d, d)
        self.linear_pos = nn.Linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads))

    def position_terms(self, pe: torch.Tensor, dtype: torch.dtype
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """``r`` (heads, 2T - 1, hd) in ``dtype`` and the f32 table
        ``(v - u) . r`` (heads, 2T - 1) of the sinusoid ``pe``."""
        n, d = pe.shape
        nh = self.num_heads
        r = dense(pe, self.linear_pos, dtype).view(n, nh, d // nh).transpose(0, 1).contiguous()
        w = self.linear_pos.weight.float().view(nh, d // nh, d)
        fold = torch.einsum("hkc,hk->hc", w, (self.pos_bias_v - self.pos_bias_u).float())
        return r, (pe @ fold.t()).t().contiguous()

    def forward(self, x: torch.Tensor, pe: torch.Tensor, kv_lengths, dtype: torch.dtype,
                use_kernels: bool) -> torch.Tensor:
        b, s, d = x.shape
        nh, hd = self.num_heads, d // self.num_heads
        qb = self.linear_q.bias + self.pos_bias_u.reshape(-1)  # q' = q + u
        q = F.linear(x.to(dtype), self.linear_q.weight.to(dtype), qb.to(dtype))

        def split_heads(t):
            return t.reshape(b, s, nh, hd).transpose(1, 2)

        k = dense(x, self.linear_k, dtype)
        v = dense(x, self.linear_v, dtype)
        r, table = self.position_terms(pe, dtype)
        attend = flash_attention if use_kernels else mha_reference
        attn = attend(split_heads(q), split_heads(k), split_heads(v), kv_lengths=kv_lengths,
                      rel_pos=r, rel_pos_bias=table)
        spans.count("relpos_attention_layers", 1)
        return dense(attn.transpose(1, 2).reshape(b, s, d), self.linear_out, dtype)


class ConformerLayer(nn.Module):
    """One Conformer block (module note) on the f32 residual stream."""

    def __init__(self, config):
        super().__init__()
        d, eps = config.hidden_size, config.layer_norm_eps
        self.ffn1_layer_norm = nn.LayerNorm(d, eps=eps)
        self.ffn1 = FeedForward(d, config.intermediate_size)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.self_attn = RelPositionAttention(d, config.num_heads)
        self.conv_module = ConvModule(d, config.conv_depthwise_kernel_size, eps)
        self.ffn2_layer_norm = nn.LayerNorm(d, eps=eps)
        self.ffn2 = FeedForward(d, config.intermediate_size)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, pe: torch.Tensor, kv_lengths, valid, *,
                dtype: torch.dtype, use_kernels: bool) -> torch.Tensor:
        x = x.float()
        x = x + 0.5 * self.ffn1(layer_norm(x, self.ffn1_layer_norm, dtype), dtype).float()
        x = x + self.self_attn(layer_norm(x, self.self_attn_layer_norm, dtype), pe, kv_lengths,
                               dtype, use_kernels).float()
        x = x + self.conv_module(x, valid, dtype).float()
        x = x + 0.5 * self.ffn2(layer_norm(x, self.ffn2_layer_norm, dtype), dtype).float()
        return F.layer_norm(x, self.final_layer_norm.normalized_shape,
                            self.final_layer_norm.weight, self.final_layer_norm.bias,
                            self.final_layer_norm.eps)

"""wav2vec2-base encoder with the FaceFormer fps adapter.

Port of ``audio2face_tpu/models/wav2vec2.py``:

  conv feature encoder (7 layers, masked group norm after layer 0, GELU)
  -> [vocaset fps adapter: align_corners linear interp 50 fps -> frame_num]
  -> feature projection (LayerNorm + 512->768)
  -> grouped positional conv embedding (k=128, 16 groups)
  -> 12 post-LN transformer layers (768 d, 12 heads, 3072 ffn, exact GELU)

Parameters stay f32; each layer computes in the caller's ``dtype`` (f32,
or bf16 for serving), casting weights at use as the JAX modules do. The
conv stack goes through the fused conv-encoder kernel family in bf16 and
through ``conv1d`` in f32; self-attention always goes through
``flash_attention``. Each kernel wrapper runs its plain version on CPU
tensors; ``use_kernels=False`` calls the plain versions directly on any
device.

``train=True`` adds HF wav2vec2-base's regularizers, every random draw from
one explicit ``torch.Generator`` on the input's device: dropout 0.1 after
the feature projection, after the encoder's layer norm and at three places
in each layer, attention dropout inside ``flash_attention`` (one int32 seed
per call for its hash mask), SpecAugment along time and features, and
LayerDrop. The conv stack then runs its differentiable per-layer ``conv1d``
path, recomputed in the backward (``torch.utils.checkpoint``): the fused
conv-encoder kernel has no backward and is not launched in training.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from audio2face_tpu_torch.ops import conv_encoder as ce
from audio2face_tpu_torch.ops.attention import flash_attention, mha_reference
from audio2face_tpu_torch.ops.dsp import interp_linear_per_item, linear_interpolation_fps


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture hyperparameters (defaults = wav2vec2-base-960h)."""

    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2
    # feature-axis SpecAugment (base-960h ships 0, so it is off by default)
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10
    # train-time regularization matching HF wav2vec2-base: dropout on the
    # attention probabilities and stochastic layer skipping (LayerDrop)
    attention_dropout: float = 0.1
    layerdrop: float = 0.1

    def feat_extract_output_length(self, input_length: int) -> int:
        length = input_length
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


HIDDEN_DROPOUT = 0.1  # the rate of every nn.Dropout in the JAX modules


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout from an explicit generator (on x's device)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return x * (keep.to(x.dtype) / (1.0 - rate))


def compute_spec_augment_mask(
    generator: torch.Generator,
    batch: int,
    seq_len: int,
    mask_prob: float,
    mask_length: int,
    min_masks: int = 0,
    device=None,
) -> torch.Tensor:
    """SpecAugment span mask (B, seq_len), boolean: ~mask_prob of the
    positions masked in spans of mask_length, at least min_masks spans. Used
    along the time axis (positions replaced by the learned masked embedding)
    and, when mask_feature_prob > 0, along the feature axis (channels
    zeroed)."""
    num_masks = max(min_masks, int(mask_prob * seq_len / mask_length + 0.5))
    starts = torch.randint(
        0, max(seq_len - mask_length, 1), (batch, num_masks), generator=generator, device=device)
    positions = starts[..., None] + torch.arange(mask_length, device=device)  # (B, M, L)
    mask = torch.zeros((batch, seq_len), dtype=torch.bool, device=device)
    positions = positions.reshape(batch, -1)
    inside = positions < seq_len
    rows = torch.arange(batch, device=device)[:, None].expand_as(positions)
    mask[rows[inside], positions[inside]] = True
    return mask


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` computed in ``dtype`` (input and f32 weights cast at use)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, layer: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with f32 statistics, returned in ``dtype``."""
    return F.layer_norm(
        x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps
    ).to(dtype)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


class MaskedGroupNorm(nn.Module):
    """Per-channel normalization over time with optional length masking:
    statistics use only the valid positions, so padded batching is exact
    on each item's prefix. Input (B, T, C)."""

    def __init__(self, channels: int = 512, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, h: torch.Tensor, feat_lengths: Optional[torch.Tensor] = None):
        h32 = h.float()
        if feat_lengths is None:
            mean = h32.mean(dim=1, keepdim=True)
            sq = h32.square().mean(dim=1, keepdim=True)
        else:
            valid = (
                torch.arange(h.shape[1], device=h.device)[None, :]
                < feat_lengths.to(h.device)[:, None]
            ).float()[..., None]
            n = valid.sum(dim=1, keepdim=True).clamp(min=1.0)
            hv = h32 * valid
            mean = hv.sum(dim=1, keepdim=True) / n
            sq = hv.square().sum(dim=1, keepdim=True) / n
        var = (sq - mean.square()).clamp(min=0.0)
        out = (h32 - mean) * torch.rsqrt(var + self.epsilon)
        return (out * self.weight + self.bias).to(h.dtype)


class FeatureEncoder(nn.Module):
    """Raw waveform -> (B, T50, 512) latents at ~50 fps.

    bf16 without conv bias (the wav2vec2-base stack) goes through
    ``fused_conv_encoder``; f32, and every dtype when ``train`` is set (the
    fused kernel has no backward), runs the per-layer ``conv1d`` path with
    the masked group norm after layer 0."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        c_in = 1
        convs = []
        for dim, k, s in zip(config.conv_dim, config.conv_kernel, config.conv_stride):
            convs.append(nn.Conv1d(c_in, dim, k, stride=s, bias=config.conv_bias))
            c_in = dim
        self.conv_layers = nn.ModuleList(convs)
        self.group_norm = MaskedGroupNorm(config.conv_dim[0], config.layer_norm_eps)

    def _fused_ok(self, dtype: torch.dtype) -> bool:
        cfg = self.config
        return (
            not cfg.conv_bias
            and cfg.conv_kernel == ce.CONV_KERNEL
            and cfg.conv_stride == ce.CONV_STRIDE
            and all(d == ce.C for d in cfg.conv_dim)
            and dtype == torch.bfloat16
        )

    def forward(
        self, x: torch.Tensor, lengths: Optional[torch.Tensor] = None, *,
        dtype: torch.dtype = torch.float32, use_kernels: bool = True, train: bool = False,
    ) -> torch.Tensor:
        if not train and self._fused_ok(dtype):
            # the kernel family takes the JAX (k, c_in, c_out) kernel layout
            kernels = [conv.weight.permute(2, 1, 0) for conv in self.conv_layers]
            fn = ce.fused_conv_encoder if use_kernels else ce.conv_encoder_reference
            return fn(x, kernels, self.group_norm.weight, self.group_norm.bias, lengths)

        h = x[:, None, :].to(dtype)  # (B, 1, L)
        feat_lengths = lengths
        for i, conv in enumerate(self.conv_layers):
            bias = None if conv.bias is None else conv.bias.to(dtype)
            h = F.conv1d(h, conv.weight.to(dtype), bias, stride=conv.stride)
            if feat_lengths is not None:
                k, s = conv.kernel_size[0], conv.stride[0]
                feat_lengths = torch.div(feat_lengths - k, s, rounding_mode="floor") + 1
            if i == 0:
                h = self.group_norm(h.transpose(1, 2), feat_lengths).transpose(1, 2)
            h = F.gelu(h)
        return h.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = nn.LayerNorm(config.conv_dim[-1], eps=config.layer_norm_eps)
        self.projection = nn.Linear(config.conv_dim[-1], config.hidden_size)

    def forward(
        self, x: torch.Tensor, dtype: torch.dtype, *, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = dense(layer_norm(x, self.layer_norm, dtype), self.projection, dtype)
        return dropout(x, HIDDEN_DROPOUT, generator) if train else x


class PositionalConvEmbedding(nn.Module):
    """Grouped conv relative positional embedding (k=128, groups=16); the
    checkpoint's weight norm is folded into the plain kernel."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        k = config.pos_conv_kernel
        self.conv = nn.Conv1d(
            config.hidden_size, config.hidden_size, k, padding=k // 2,
            groups=config.pos_conv_groups,
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:  # (B, T, C)
        h = F.conv1d(
            x.to(dtype).transpose(1, 2), self.conv.weight.to(dtype), self.conv.bias.to(dtype),
            padding=self.conv.padding, groups=self.conv.groups,
        ).transpose(1, 2)
        if self.conv.kernel_size[0] % 2 == 0:
            h = h[:, :-1]  # HF SamePadLayer removes the extra step for even k
        return F.gelu(h)


class EncoderLayer(nn.Module):
    """Post-LN transformer layer (do_stable_layer_norm=False, base config)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        d = config.hidden_size
        self.num_heads = config.num_heads
        self.attention_dropout = config.attention_dropout
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)
        self.layer_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)
        self.intermediate_dense = nn.Linear(d, config.intermediate_size)
        self.output_dense = nn.Linear(config.intermediate_size, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=config.layer_norm_eps)

    def forward(
        self, x: torch.Tensor, kv_lengths: Optional[torch.Tensor] = None, *,
        dtype: torch.dtype = torch.float32, use_kernels: bool = True, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        b, s, d = x.shape
        nh = self.num_heads
        drop = (lambda t: dropout(t, HIDDEN_DROPOUT, generator)) if train else (lambda t: t)

        def split_heads(t):
            return t.reshape(b, s, nh, d // nh).transpose(1, 2)

        q = split_heads(dense(x, self.q_proj, dtype))
        k = split_heads(dense(x, self.k_proj, dtype))
        v = split_heads(dense(x, self.v_proj, dtype))
        attend = flash_attention if use_kernels else mha_reference
        rate, seed = 0.0, None
        if train and self.attention_dropout > 0:
            # one int32 seed per attention call for the hash mask; it stays
            # on the device (the kernels read it there)
            rate = self.attention_dropout
            seed = torch.randint(
                0, 2**31 - 1, (1,), generator=generator, device=x.device, dtype=torch.int32)
        attn = attend(q, k, v, kv_lengths=kv_lengths, dropout_rate=rate, dropout_seed=seed)
        attn = drop(dense(attn.transpose(1, 2).reshape(b, s, d), self.out_proj, dtype))
        x = layer_norm(x + attn, self.layer_norm, dtype)
        ff = drop(F.gelu(dense(x, self.intermediate_dense, dtype)))
        ff = drop(dense(ff, self.output_dense, dtype))
        return layer_norm(x + ff, self.final_layer_norm, dtype)


class Wav2Vec2Encoder(nn.Module):
    """Full encoder: waveform -> (B, T, 768) hidden states.

    ``output_len`` turns on the vocaset fps adapter (linear interp of the
    50 fps conv latents to the frame count). ``lengths`` gives per-item
    valid *sample* counts for padded batches; ``output_lengths`` the valid
    output frames per item. ``train=True`` needs a ``generator`` on the
    input's device; ``apply_spec_augment`` adds the span masks.
    ``differentiable=True`` keeps eval mode but runs the conv stack's
    ``conv1d`` path, for gradients into the conv weights (the fused kernel
    has no backward)."""

    def __init__(self, config: Wav2Vec2Config = Wav2Vec2Config()):
        super().__init__()
        self.config = config
        self.feature_encoder = FeatureEncoder(config)
        self.feature_projection = FeatureProjection(config)
        self.masked_spec_embed = nn.Parameter(torch.zeros(config.hidden_size))
        self.pos_conv_embed = PositionalConvEmbedding(config)
        self.layer_norm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.num_layers))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` in the JAX modules' scheme: LeCun
        normal kernels, zero biases, unit norms, uniform masked embedding."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                _lecun_normal_(m.weight, fan_in, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, MaskedGroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        self.masked_spec_embed.uniform_(0.0, 1.0, generator=generator)

    def forward(
        self,
        input_values: torch.Tensor,  # (B, L)
        output_len: Optional[int] = None,
        lengths: Optional[torch.Tensor] = None,
        output_lengths: Optional[torch.Tensor] = None,
        *,
        dtype: torch.dtype = torch.float32,
        use_kernels: bool = True,
        train: bool = False,
        apply_spec_augment: bool = False,
        generator: Optional[torch.Generator] = None,
        differentiable: bool = False,
    ) -> torch.Tensor:
        cfg = self.config
        if train and generator is None:
            raise ValueError("train=True needs an explicit torch.Generator")
        if differentiable and not train:
            # eval-mode gradients: the conv1d path, without the regularizers
            h = self.feature_encoder(input_values, lengths, dtype=dtype, train=True)
        elif train and torch.is_grad_enabled():
            # the conv stack's activations are the largest training buffer
            # ((B, L/5, 512) after layer 0): recompute them in the backward
            h = checkpoint(
                lambda x: self.feature_encoder(x, lengths, dtype=dtype, train=True),
                input_values, use_reentrant=False,
            )
        else:
            h = self.feature_encoder(
                input_values, lengths, dtype=dtype, use_kernels=use_kernels, train=train)

        feat_lengths = None
        if lengths is not None:
            feat_lengths = lengths
            for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
                feat_lengths = torch.div(feat_lengths - k, s, rounding_mode="floor") + 1

        if output_len is not None:
            if lengths is None:
                h = linear_interpolation_fps(h, output_len)
            else:
                if output_lengths is None:
                    # per-item frames proportional to output_len over the
                    # padded bucket, in int64 (no int32 overflow to avoid)
                    output_lengths = torch.div(
                        lengths.to(torch.int64) * output_len, input_values.shape[1],
                        rounding_mode="floor",
                    )
                h = interp_linear_per_item(h, output_len, feat_lengths, output_lengths)
                feat_lengths = output_lengths

        h = self.feature_projection(h, dtype, train=train, generator=generator)
        if train and apply_spec_augment and cfg.mask_time_prob > 0:
            mask = compute_spec_augment_mask(
                generator, h.shape[0], h.shape[1], cfg.mask_time_prob, cfg.mask_time_length,
                cfg.mask_time_min_masks, device=h.device)
            h = torch.where(mask[..., None], self.masked_spec_embed.to(h.dtype), h)
        if train and apply_spec_augment and cfg.mask_feature_prob > 0:
            # masked channels are zeroed across every time step
            fmask = compute_spec_augment_mask(
                generator, h.shape[0], h.shape[2], cfg.mask_feature_prob,
                cfg.mask_feature_length, device=h.device)
            h = h.masked_fill(fmask[:, None, :], 0.0)
        if feat_lengths is not None:
            # zero padded positions before the (global) positional conv
            valid = torch.arange(h.shape[1], device=h.device)[None, :] < feat_lengths.to(h.device)[:, None]
            h = h * valid[..., None].to(h.dtype)
        h = h + self.pos_conv_embed(h, dtype)
        h = layer_norm(h, self.layer_norm, dtype)
        skip = [False] * len(self.layers)
        if train:
            h = dropout(h, HIDDEN_DROPOUT, generator)
            if cfg.layerdrop > 0.0:
                # LayerDrop: a whole layer is skipped for the whole batch with
                # probability layerdrop; all draws come in one host read
                skip = (
                    torch.rand(len(self.layers), generator=generator, device=h.device)
                    < cfg.layerdrop
                ).tolist()
        for layer, skipped in zip(self.layers, skip):
            if skipped:
                continue
            h = layer(
                h, kv_lengths=feat_lengths, dtype=dtype, use_kernels=use_kernels, train=train,
                generator=generator,
            )
        return h

"""Shared building blocks for the frame models.

Port of ``audio2face_tpu/models/layers.py``. Activations are NCHW, as in the
reference's torch modules, and parameters stay f32: each layer computes in
the caller's ``dtype`` (f32, or bf16 for serving) and casts its weights at
use, as ``models/wav2vec2.py`` does with ``dense``. Parameter names follow
the JAX modules: ``{name}.conv.weight`` for flax ``{name}/conv/kernel``,
``{name}.bn.running_var`` for ``batch_stats/{name}/bn/var``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audio2face_tpu_torch.models.wav2vec2 import _lecun_normal_, dense
from audio2face_tpu_torch.ops.frame_epilogue import frame_epilogue
from audio2face_tpu_torch.utils import spans

BN_MOMENTUM = 0.1  # torch-style: new = (1 - m) * old + m * batch (flax: momentum 0.9)
BN_EPS = 1e-5


class TorchConv(nn.Module):
    """Conv2d with torch-style explicit symmetric padding, computed in the
    caller's dtype."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides=(1, 1),
                 padding=(0, 0), use_bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, tuple(kernel_size), stride=tuple(strides),
                              padding=tuple(padding), bias=use_bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, add_bias: bool = True) -> torch.Tensor:
        c = self.conv
        x, w = x.to(dtype), c.weight.to(dtype)
        bias = None if c.bias is None or not add_bias else c.bias.to(dtype)
        if x.device.type == "cpu" and dtype != torch.float32:
            # the CPU's bf16 conv (oneDNN) returns wrong values, even NaN, at
            # some of these shapes (a (1, 3)/stride-2 conv of a 2-wide
            # input); the same bf16 operands with f32 sums, rounded once
            out = F.conv2d(x.float(), w.float(), None if bias is None else bias.float(),
                           stride=c.stride, padding=c.padding)
            return out.to(dtype)
        return F.conv2d(x, w, bias, stride=c.stride, padding=c.padding)


def _one_pass(x: torch.Tensor, train: bool, *modules: nn.Module) -> bool:
    """Whether a block's epilogue (conv bias, BatchNorm, ReLU) runs as one
    pass of ``ops/frame_epilogue.py``: on CUDA, in eval, where autograd would
    record nothing (the kernel has no backward). Elsewhere (training, the
    CPU, eval under autograd) the per-op composition runs."""
    if x.device.type != "cuda" or train:
        return False
    return not torch.is_grad_enabled() or not (
        x.requires_grad or any(p.requires_grad for m in modules for p in m.parameters()))


class _BatchNormState(nn.Module):
    """The learned scale and shift and the running statistics of one
    BatchNorm, under torch's names."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class TorchBatchNorm(nn.Module):
    """BatchNorm2d over NCHW with torch's defaults (eps 1e-5, momentum 0.1),
    computed as flax's ``nn.BatchNorm``, which the port is held to:

    - train mode normalizes with the batch statistics, taken in f32 whatever
      the compute dtype, the variance as E[x^2] - E[x]^2 clipped at 0;
    - the running variance is updated with that **biased** batch variance.
      ``torch.nn.BatchNorm2d`` (the reference) updates it with the unbiased
      one, n/(n-1) larger for n = batch x H x W values per channel: at
      Audio2Mesh's ``artic4_pre_bn`` (H x W = 4) and Song2Face's ``reg*_bn``
      (H x W <= 8) n is little more than the batch, so the two running
      variances part by up to a factor 2 at batch 2;
    - eval mode normalizes with the running statistics (``eval_affine``), in
      one kernel pass where ``_one_pass`` allows.

    The output is in the input's dtype. ``sync_group`` is None, or the
    data-parallel group whose ranks each hold a share of the batch: the
    batch moments are then the whole batch's, from the f32 sums and sums of
    squares summed over the group (the JAX package's jit sees the global
    batch)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = _BatchNormState(channels)
        self.sync_group = None

    def eval_affine(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Eval mode's ``(mean, mul, beta)``, f32 (C,) each: ``y = (x - mean) *
        mul + beta``."""
        bn = self.bn
        return bn.running_mean, torch.rsqrt(bn.running_var + BN_EPS) * bn.weight, bn.bias

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if _one_pass(x, train, self):
            spans.count("conv_epilogues_fused", 1)
            return frame_epilogue(x.contiguous(), bn=self.eval_affine())
        bn = self.bn
        if train:
            xf = x.float()
            if self.sync_group is None:
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
            else:
                from audio2face_tpu_torch.parallel import comm

                c = xf.shape[1]
                n = torch.full((1,), xf.numel() / c, device=x.device)
                sums = comm.sum_over_group(
                    torch.cat([xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3)), n]),
                    self.sync_group)
                mean = sums[:c] / sums[2 * c]
                var = torch.clamp(sums[c : 2 * c] / sums[2 * c] - mean.square(), min=0.0)
            with torch.no_grad():
                bn.running_mean.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
                bn.running_var.mul_(1.0 - BN_MOMENTUM).add_(BN_MOMENTUM * var.detach())
            mul = torch.rsqrt(var + BN_EPS) * bn.weight
        else:
            mean, mul, _ = self.eval_affine()
        y = (x.float() - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
        return y.to(x.dtype)


class VertexDecoderMLP(nn.Module):
    """The shared vertex head ``[in -> 72 -> 128 -> tanh -> 50 -> n_verts]``
    of Audio2Mesh, VOCA and Song2Face: tanh only after the second linear,
    every other layer purely linear."""

    def __init__(self, in_features: int, n_verts: int):
        super().__init__()
        self.fc0 = nn.Linear(in_features, 72)
        self.fc1 = nn.Linear(72, 128)
        self.fc2 = nn.Linear(128, 50)
        self.fc3 = nn.Linear(50, n_verts)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = dense(dense(x, self.fc0, dtype), self.fc1, dtype)
        return dense(dense(torch.tanh(x), self.fc2, dtype), self.fc3, dtype)


def tile_onehot_rows(one_hot: torch.Tensor, n_rows: int, width: int) -> torch.Tensor:
    """The reference's one-hot tiling ``one_hot.repeat(1, width).view(bs,
    n_rows, width)``: rows are *rotated* copies when width % n_onehot != 0
    (Audio2Mesh: 32 columns against 12 entries)."""
    bs, n_onehot = one_hot.shape
    return one_hot.repeat(1, (n_rows * width) // n_onehot).reshape(bs, n_rows, width)


class ScanLSTM(nn.Module):
    """Unidirectional LSTM, torch gate order (i, f, g, o), batch first.

    As the JAX module computes it: the input projection ``x W_ih + b_ih +
    b_hh`` is hoisted out of the recurrence as one product in f32 and cast
    to the compute dtype; the recurrence runs one step at a time in the
    compute dtype with ``W_hh`` cast to it. Weights are kept in torch's
    (4H, in) layout under the JAX names ``w_ih``, ``w_hh``, ``b_ih``,
    ``b_hh``."""

    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        h4 = 4 * hidden_size
        self.hidden_size = hidden_size
        self.w_ih = nn.Parameter(torch.empty(h4, in_features))
        self.w_hh = nn.Parameter(torch.empty(h4, hidden_size))
        self.b_ih = nn.Parameter(torch.empty(h4))
        self.b_hh = nn.Parameter(torch.empty(h4))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:  # (B, T, F)
        b, t, _ = x.shape
        hs = self.hidden_size
        x_proj = (F.linear(x.float(), self.w_ih) + self.b_ih + self.b_hh).to(dtype)
        w_hh = self.w_hh.to(dtype).t()
        h = x.new_zeros((b, hs), dtype=dtype)
        c = x.new_zeros((b, hs), dtype=dtype)
        ys = []
        for step in range(t):
            gates = torch.addmm(x_proj[:, step], h, w_hh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1)  # (B, T, H)


def add_conv_blocks(module: nn.Module, in_channels: int, blocks: Sequence[dict]) -> int:
    """Register the layers of ``blocks`` on ``module`` under the JAX names:
    a ``TorchConv`` as ``name`` and, unless ``bn`` is False, a
    ``TorchBatchNorm`` as ``name + "_bn"``. Each block is a dict with keys
    ``features, kernel, stride, pad, bn (bool), relu (bool), name``.
    Returns the output channels."""
    for blk in blocks:
        module.add_module(blk["name"], TorchConv(
            in_channels, blk["features"], blk["kernel"], blk["stride"], blk["pad"]))
        if blk.get("bn", True):
            module.add_module(blk["name"] + "_bn", TorchBatchNorm(blk["features"]))
        in_channels = blk["features"]
    return in_channels


def conv_block(conv: TorchConv, bn: Optional[TorchBatchNorm], x: torch.Tensor, train: bool,
               dtype: torch.dtype, relu: bool = True) -> torch.Tensor:
    """``conv``, then ``bn`` unless it is None, then ReLU if ``relu``. Where
    ``_one_pass`` allows, the conv runs without its bias, and the bias, the
    BatchNorm and the ReLU follow in one pass over its output, in place; the
    counter ``conv_epilogues_fused`` counts such blocks."""
    if _one_pass(x, train, conv, *([] if bn is None else [bn])):
        y = conv(x.contiguous(), dtype, add_bias=False)
        b = conv.conv.bias
        spans.count("conv_epilogues_fused", 1)
        return frame_epilogue(y, None if b is None else b.to(dtype),
                              None if bn is None else bn.eval_affine(), relu, out=y)
    x = conv(x, dtype)
    if bn is not None:
        x = bn(x, train)
    return F.relu(x) if relu else x


def conv_stack(module: nn.Module, x: torch.Tensor, blocks: Sequence[dict], train: bool,
               dtype: torch.dtype) -> torch.Tensor:
    """Apply the conv/bn/relu blocks that ``add_conv_blocks`` registered."""
    for blk in blocks:
        bn = getattr(module, blk["name"] + "_bn") if blk.get("bn", True) else None
        x = conv_block(getattr(module, blk["name"]), bn, x, train, dtype, blk.get("relu", True))
    return x


@torch.no_grad()
def init_frame_model(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator`` in the JAX modules' scheme: LeCun
    normal conv and dense kernels, zero biases, unit BatchNorm scales with
    zero/one running statistics, and U(-k, k) LSTM weights, k =
    1/sqrt(hidden)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _BatchNormState):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, ScanLSTM):
            k = 1.0 / math.sqrt(m.hidden_size)
            for p in (m.w_ih, m.w_hh, m.b_ih, m.b_hh):
                p.uniform_(-k, k, generator=generator)

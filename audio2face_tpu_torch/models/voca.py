"""VOCA: a windowed feature encoder with 8-subject styles.

Port of ``audio2face_tpu/models/voca.py``. The input is a (B, 29, 16)
feature window; the one-hot is cut to the first 8 training subjects and
tiled to an (8, 16) block, giving 29 + 8 = 37 input channels; four (3, 1)/
stride-(2, 1) time convs (32 -> 32 -> 64 -> 64, ReLU, no BatchNorm) collapse
the 16 time steps to 1; the vertex head runs on the result beside the
8-entry one-hot, and the template is added. NCHW, as the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio2face_tpu_torch.models.layers import (
    VertexDecoderMLP,
    add_conv_blocks,
    conv_stack,
    init_frame_model,
    tile_onehot_rows,
)

TIME_CONV_CHANNELS = (32, 32, 64, 64)
TIME_CONV_BLOCKS = tuple(
    dict(features=ch, kernel=(3, 1), stride=(2, 1), pad=(1, 0), bn=False, name=f"time_conv{i}")
    for i, ch in enumerate(TIME_CONV_CHANNELS)
)


class Voca(nn.Module):
    def __init__(self, n_verts: int, n_onehot: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_verts = n_verts
        self.n_onehot = n_onehot
        self.dtype = dtype
        add_conv_blocks(self, 37, TIME_CONV_BLOCKS)
        self.decoder = VertexDecoderMLP(64 + 8, n_verts)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_frame_model(self, generator)

    def forward(self, x: torch.Tensor, one_hot: torch.Tensor, template: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        """x: (B, 29, 16) features; one_hot: (B, >=8); template: (B, V, 3).
        Returns (B, V, 3) f32 vertices."""
        cdt = self.dtype or torch.float32
        bs = x.shape[0]
        one_hot8 = one_hot[:, :8]
        onehot_img = tile_onehot_rows(one_hot8, 8, x.shape[2])
        h = torch.cat([x.float(), onehot_img.float()], dim=1)  # (B, 37, 16)
        # channels = 37, H = 16 (time), W = 1
        h = h[..., None].to(cdt)
        h = conv_stack(self, h, TIME_CONV_BLOCKS, train, cdt)  # (B, 64, 1, 1)
        h = torch.cat([h.reshape(bs, -1), one_hot8.to(h.dtype)], dim=1)
        out = self.decoder(h, cdt).float()
        return out.reshape(bs, -1, 3) + template

"""Audio2Mesh: a formant-analysis conv stack and an identity-conditioned MLP.

Port of ``audio2face_tpu/models/audio2mesh.py``. The input is a (B, 52, 32)
MFCC feature image; the 12-entry identity one-hot is tiled to a (12, 32)
block below it (rows 52..63); five (1, 3)/stride-(1, 2) "analysis" convs
collapse the 32-wide feature axis (channels 1 -> 72 -> 108 -> 162 -> 243 ->
256, BatchNorm + ReLU each); five (3, 1)/(4, 1) "articulation" convs
collapse the 64-tall time axis to 1 with the reference's irregular BN
placement; the vertex head runs on the result beside the raw one-hot, and
the template is added. NCHW, as the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio2face_tpu_torch.models.layers import (
    TorchBatchNorm,
    TorchConv,
    VertexDecoderMLP,
    add_conv_blocks,
    conv_block,
    conv_stack,
    init_frame_model,
    tile_onehot_rows,
)

ANALYSIS_CHANNELS = (72, 108, 162, 243, 256)
ANALYSIS_BLOCKS = tuple(
    dict(features=ch, kernel=(1, 3), stride=(1, 2), pad=(0, 1), name=f"analysis{i}")
    for i, ch in enumerate(ANALYSIS_CHANNELS)
)
ARTIC_BLOCKS = tuple(
    dict(features=256, kernel=(3, 1), stride=(2, 1), pad=(1, 0), name=f"artic{i}")
    for i in range(3)
)


class Audio2Mesh(nn.Module):
    def __init__(self, n_verts: int, n_onehot: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_verts = n_verts
        self.n_onehot = n_onehot
        self.dtype = dtype
        ch = add_conv_blocks(self, 1, ANALYSIS_BLOCKS)
        ch = add_conv_blocks(self, ch, ARTIC_BLOCKS)
        self.artic3_pre_bn = TorchBatchNorm(ch)
        self.artic3 = TorchConv(ch, 256, (3, 1), (2, 1), (1, 0))
        self.artic4_pre_bn = TorchBatchNorm(256)
        self.artic4 = TorchConv(256, 256, (4, 1), (4, 1), (0, 0))
        self.output = VertexDecoderMLP(256 + n_onehot, n_verts)

    def init_parameters(self, generator: torch.Generator) -> None:
        init_frame_model(self, generator)

    def forward(self, x: torch.Tensor, one_hot: torch.Tensor, template: torch.Tensor, *,
                train: bool = False) -> torch.Tensor:
        """x: (B, 52, 32) features; one_hot: (B, 12); template: (B, V, 3).
        Returns (B, V, 3) f32 vertices."""
        cdt = self.dtype or torch.float32
        bs = x.shape[0]
        onehot_img = tile_onehot_rows(one_hot, self.n_onehot, x.shape[2])
        # rows: 52 feature rows then 12 one-hot rows -> (B, 1, 64, 32)
        h = torch.cat([x.float(), onehot_img.float()], dim=1)[:, None].to(cdt)

        h = conv_stack(self, h, ANALYSIS_BLOCKS, train, cdt)  # (B, 256, 64, 1)
        # articulation: conv/bn/relu x3, then bn, conv, relu, bn, conv, relu
        h = conv_stack(self, h, ARTIC_BLOCKS, train, cdt)
        h = conv_block(self.artic3, None, self.artic3_pre_bn(h, train), train, cdt)
        h = conv_block(self.artic4, None, self.artic4_pre_bn(h, train), train, cdt)

        h = h.reshape(bs, -1)  # (B, 256)
        h = torch.cat([h, one_hot.to(h.dtype)], dim=1)
        out = self.output(h, cdt).float()
        return out.reshape(bs, -1, 3) + template

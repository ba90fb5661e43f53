"""Song2Face: a conv + LSTM singing-voice variant.

Port of ``audio2face_tpu/models/song2face.py``. The input is a (B, 52, 32)
feature image with the tiled 12-entry one-hot below it (64 rows); five
conv/BN/ReLU blocks ((1, 5) and (1, 3) kernels, stride (1, 2)) collapse the
32-wide axis to 1 (channels 1 -> 72 -> 108 -> 162 -> 243 -> 256); the
(B, 256, 64) result feeds two stacked unidirectional LSTMs (64 -> 256 ->
256) that run over the 256 conv *channels* as time, as the reference does;
the hidden axis is compressed 256 -> 32 by linear interpolation
(``align_corners=False``); four (3, 1)/stride-(2, 1) regression convs (the
last without BatchNorm) collapse it to 1; the vertex head runs on the result
beside the one-hot, and the template is added. NCHW, as the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio2face_tpu_torch.models.layers import (
    ScanLSTM,
    VertexDecoderMLP,
    add_conv_blocks,
    conv_stack,
    init_frame_model,
    tile_onehot_rows,
)
from audio2face_tpu_torch.ops.dsp import interp_linear

ENCODER_BLOCKS = tuple(
    dict(features=ch, kernel=(1, kw), stride=(1, 2), pad=(0, pw), name=f"enc{i}")
    for i, (ch, kw, pw) in enumerate(((72, 5, 2), (108, 5, 2), (162, 3, 1), (243, 3, 1), (256, 3, 1)))
)
REGRESSION_BLOCKS = tuple(
    dict(features=256, kernel=(3, 1), stride=(2, 1), pad=(1, 0), name=f"reg{i}") for i in range(3)
) + (dict(features=256, kernel=(3, 1), stride=(2, 1), pad=(0, 0), bn=False, name="reg3"),)


class Song2Face(nn.Module):
    def __init__(self, n_verts: int, n_onehot: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_verts = n_verts
        self.n_onehot = n_onehot
        self.dtype = dtype
        add_conv_blocks(self, 1, ENCODER_BLOCKS)
        self.lstm1 = ScanLSTM(64, 256)
        self.lstm2 = ScanLSTM(256, 256)
        add_conv_blocks(self, 256, REGRESSION_BLOCKS)
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
        h = torch.cat([x.float(), onehot_img.float()], dim=1)[:, None].to(cdt)  # (B, 1, 64, 32)

        h = conv_stack(self, h, ENCODER_BLOCKS, train, cdt)  # (B, 256, 64, 1)
        # a sequence over the 256 channels, 64 features (the rows) each
        h = h[..., 0]  # (B, 256, 64)
        h = self.lstm1(h, cdt)
        h = self.lstm2(h, cdt)  # (B, 256, 256)

        # compress the hidden axis 256 -> 32 (the reference's
        # F.interpolate(size=(32, 1), mode="bilinear"))
        h = interp_linear(h, 32, axis=2, align_corners=False)  # (B, 256, 32)
        h = conv_stack(self, h[..., None], REGRESSION_BLOCKS, train, cdt)  # (B, 256, 1, 1)

        h = torch.cat([h.reshape(bs, -1), one_hot.to(h.dtype)], dim=1)
        out = self.output(h, cdt).float()
        return out.reshape(bs, -1, 3) + template

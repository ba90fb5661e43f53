"""Reference FaceFormer PyTorch checkpoint -> the port's state dict.

Port of ``audio2face_tpu/compat/faceformer_convert.py``. Source names follow
the reference module's attributes: ``audio_encoder.*`` (HF wav2vec2),
``audio_feature_map``, ``vertice_map``, ``vertice_map_r``, ``obj_vector``
(no bias) and ``transformer_decoder.layers.0.*``, one torch
``nn.TransformerDecoderLayer`` whose q, k and v projections are packed in
one ``in_proj`` and are split here.

The cross-attention q/k projections are inert under vocaset's diagonal
memory mask (a softmax over one element is 1), so only its value and output
projections are carried; BIWI's 2-way alignment makes q/k live, and
``dataset="biwi"`` carries them too. The buffers (``PPE.pe``,
``biased_mask``) are recomputed, not carried. The decoder's width d is the
checkpoint's (``audio_feature_map``'s outputs: 64 in the repo's models, 128
in the upstream BIWI model), and each packed ``in_proj`` (3d, d) is split
at it.
"""

from __future__ import annotations

from typing import Mapping

import torch

from audio2face_tpu_torch.compat.torch_convert import _t
from audio2face_tpu_torch.compat.wav2vec2_convert import convert_wav2vec2, strip_prefix


def convert_faceformer(sd: Mapping, dataset: str = "vocaset") -> dict[str, torch.Tensor]:
    d = _t(sd["audio_feature_map.weight"]).shape[0]
    out = {f"audio_encoder.{k}": v
           for k, v in convert_wav2vec2(strip_prefix(sd, "audio_encoder.")).items()}

    def put(dst: str, src: str, bias: bool = True) -> None:
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    for name in ("audio_feature_map", "vertice_map", "vertice_map_r"):
        put(name, name)
    put("obj_vector", "obj_vector", bias=False)

    layer = "transformer_decoder.layers.0"

    def split(prefix: str, names) -> None:
        w, b = _t(sd[f"{prefix}.in_proj_weight"]), _t(sd[f"{prefix}.in_proj_bias"])
        for i, name in names:
            out[f"{name}.weight"] = w[i * d : (i + 1) * d].clone()
            out[f"{name}.bias"] = b[i * d : (i + 1) * d].clone()

    split(f"{layer}.self_attn", ((0, "dec_q"), (1, "dec_k"), (2, "dec_v")))
    put("dec_out", f"{layer}.self_attn.out_proj")
    cross = ((2, "cross_v"),) + (((0, "cross_q"), (1, "cross_k")) if dataset == "biwi" else ())
    split(f"{layer}.multihead_attn", cross)
    put("cross_out", f"{layer}.multihead_attn.out_proj")
    put("linear1", f"{layer}.linear1")
    put("linear2", f"{layer}.linear2")
    for i in (1, 2, 3):
        put(f"norm{i}", f"{layer}.norm{i}")
    return out

"""HF wav2vec2 PyTorch weights -> the port's ``Wav2Vec2Encoder`` state dict.

Port of ``audio2face_tpu/compat/wav2vec2_convert.py`` (the inbound
direction). Both weight-norm namings of the positional conv
(``weight_g``/``weight_v`` and ``parametrizations.weight.original{0,1}``)
are folded into a plain kernel, g * v / ||v||, numerically identical at
inference. Names follow HF ``Wav2Vec2Model``; keys may carry a
``wav2vec2.`` or ``audio_encoder.`` prefix, which the caller strips
(``strip_prefix``).
"""

from __future__ import annotations

from typing import Mapping

import torch

from audio2face_tpu_torch.compat.torch_convert import _t


def _pos_conv_weight(sd: Mapping) -> torch.Tensor:
    """The positional conv's (O, I/groups, k) kernel, weight norm folded."""
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in sd:
        g, v = _t(sd[f"{base}.weight_g"]), _t(sd[f"{base}.weight_v"])
    elif f"{base}.parametrizations.weight.original0" in sd:
        g = _t(sd[f"{base}.parametrizations.weight.original0"])
        v = _t(sd[f"{base}.parametrizations.weight.original1"])
    elif f"{base}.weight" in sd:
        return _t(sd[f"{base}.weight"])
    else:
        raise KeyError(f"positional conv weights not found under {base}")
    # torch weight_norm(dim=2): one norm per kernel position, over (O, I)
    norm = v.double().square().sum(dim=(0, 1), keepdim=True).sqrt()
    return (g.double() * v.double() / norm.clamp(min=1e-12)).float()


def convert_wav2vec2(sd: Mapping, num_layers: int = 12) -> dict[str, torch.Tensor]:
    """HF Wav2Vec2Model state dict -> the port's Wav2Vec2Encoder state dict."""
    out: dict = {}

    def put(dst: str, src: str, bias: bool = True) -> None:
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    n_convs = sum(1 for k in sd if k.startswith("feature_extractor.conv_layers")
                  and k.endswith("conv.weight"))
    for i in range(n_convs):
        src = f"feature_extractor.conv_layers.{i}.conv"
        put(f"feature_encoder.conv_layers.{i}", src, bias=f"{src}.bias" in sd)
    put("feature_encoder.group_norm", "feature_extractor.conv_layers.0.layer_norm")
    put("feature_projection.layer_norm", "feature_projection.layer_norm")
    put("feature_projection.projection", "feature_projection.projection")
    out["pos_conv_embed.conv.weight"] = _pos_conv_weight(sd)
    out["pos_conv_embed.conv.bias"] = _t(sd["encoder.pos_conv_embed.conv.bias"])
    put("layer_norm", "encoder.layer_norm")
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"layers.{i}.{name}", f"{p}.attention.{name}")
        put(f"layers.{i}.layer_norm", f"{p}.layer_norm")
        for name in ("intermediate_dense", "output_dense"):
            put(f"layers.{i}.{name}", f"{p}.feed_forward.{name}")
        put(f"layers.{i}.final_layer_norm", f"{p}.final_layer_norm")
    if "masked_spec_embed" in sd:
        out["masked_spec_embed"] = _t(sd["masked_spec_embed"])
    else:
        out["masked_spec_embed"] = torch.zeros(out["feature_projection.projection.weight"].shape[0])
    return out


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

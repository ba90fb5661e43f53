"""HF wav2vec2 PyTorch weights <-> the port's ``Wav2Vec2Encoder`` state dict.

Port of ``audio2face_tpu/compat/wav2vec2_convert.py``. Inbound
(``convert_wav2vec2``): both weight-norm namings of the positional conv
(``weight_g``/``weight_v`` and ``parametrizations.weight.original{0,1}``)
are folded into a plain kernel, g * v / ||v||, numerically identical at
inference. Names follow HF ``Wav2Vec2Model``; keys may carry a
``wav2vec2.`` or ``audio_encoder.`` prefix, which the caller strips
(``strip_prefix``). Outbound (``export_wav2vec2``): the exact inverse, with
the positional conv re-parameterized into torch's weight-norm form.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from audio2face_tpu_torch.compat.jax_params import _np
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


# ---------------------------------------------------------------------------
# Outbound: the port's Wav2Vec2Encoder state dict -> HF state-dict names.
# ---------------------------------------------------------------------------


def _np32(x) -> np.ndarray:
    return np.asarray(_np(x), dtype=np.float32)


def export_wav2vec2(sd: Mapping) -> dict[str, np.ndarray]:
    """The port's Wav2Vec2Encoder state dict -> HF ``Wav2Vec2Model`` state
    dict (numpy f32), every layer ``sd`` holds.

    The exact inverse of :func:`convert_wav2vec2`: the positional conv kernel
    is re-parameterized into torch's ``parametrizations.weight.original{0,1}``
    weight-norm form (dim=2: one norm per kernel position over (O, I)), so
    ``g * v / ||v||`` gives the folded kernel back at load. Lets FaceFormer
    models trained by the port load into the reference's module, which
    expects the full ``audio_encoder.*`` key set."""
    out: dict[str, np.ndarray] = {}

    def put(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = _np32(sd[f"{src}.weight"])
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = _np32(sd[f"{src}.bias"])

    i = 0
    while f"feature_encoder.conv_layers.{i}.weight" in sd:
        put(f"feature_extractor.conv_layers.{i}.conv", f"feature_encoder.conv_layers.{i}")
        i += 1
    put("feature_extractor.conv_layers.0.layer_norm", "feature_encoder.group_norm")
    put("feature_projection.layer_norm", "feature_projection.layer_norm")
    put("feature_projection.projection", "feature_projection.projection")

    w = _np32(sd["pos_conv_embed.conv.weight"])  # (O, I/groups, k)
    # one norm per kernel position over its (O, I) block, summed over the
    # block as contiguous memory (numpy's pairwise sum), as the JAX exporter
    # sums its (k, I, O) kernel; a strided f32 sum over k-minor memory
    # drifts by ~1e-5
    w_kio = np.ascontiguousarray(w.transpose(2, 1, 0))
    g = np.sqrt((w_kio**2).sum(axis=(1, 2)))[None, None, :]  # (1, 1, k)
    base = "encoder.pos_conv_embed.conv"
    out[f"{base}.parametrizations.weight.original0"] = g
    # torch weight-norm reconstructs w = g * v/||v||: an all-zero kernel
    # slice (g == 0) would make v/||v|| a 0/0 NaN, so give those slices a
    # unit direction; g = 0 still reproduces the zero weights exactly
    v = w.copy()
    zero = g[0, 0] == 0
    if zero.any():
        v[0, 0, zero] = 1.0
    out[f"{base}.parametrizations.weight.original1"] = v
    out[f"{base}.bias"] = _np32(sd["pos_conv_embed.conv.bias"])

    put("encoder.layer_norm", "layer_norm")
    num_layers = sum(1 for k in sd if k.startswith("layers.") and k.endswith(".q_proj.weight"))
    for i in range(num_layers):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{p}.attention.{name}", f"layers.{i}.{name}")
        for name in ("intermediate_dense", "output_dense"):
            put(f"{p}.feed_forward.{name}", f"layers.{i}.{name}")
        put(f"{p}.layer_norm", f"layers.{i}.layer_norm")
        put(f"{p}.final_layer_norm", f"layers.{i}.final_layer_norm")
    out["masked_spec_embed"] = _np32(sd["masked_spec_embed"])
    return out

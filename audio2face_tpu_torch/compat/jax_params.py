"""Carry FaceFormer weights from the JAX package's parameter tree.

``faceformer_state_dict_from_jax(params)`` takes the JAX FaceFormer's
``variables["params"]`` as a nested dict of numpy arrays (what
``jax.tree.map(np.asarray, variables["params"])`` gives) and returns the
port's state dict. Conversions: flax Dense ``(in, out)`` kernels transpose
into ``nn.Linear`` weights; flax conv kernels ``(k, c_in/groups, c_out)``
become ``(c_out, c_in/groups, k)``; LayerNorm/GroupNorm ``scale`` becomes
``weight``. The positional conv is already weight-norm-folded on the JAX
side. Imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _dense(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def wav2vec2_state_dict_from_jax(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """The port's Wav2Vec2Encoder state dict from the JAX encoder's params."""
    out: dict[str, torch.Tensor] = {}
    fe = params["feature_encoder"]
    n_conv = sum(1 for k in fe if k.startswith("conv"))
    for i in range(n_conv):
        _conv(out, f"{prefix}feature_encoder.conv_layers.{i}", fe[f"conv{i}"])
    _norm(out, f"{prefix}feature_encoder.group_norm", fe["group_norm"])
    fp = params["feature_projection"]
    _norm(out, f"{prefix}feature_projection.layer_norm", fp["layer_norm"])
    _dense(out, f"{prefix}feature_projection.projection", fp["projection"])
    out[f"{prefix}masked_spec_embed"] = _t(params["masked_spec_embed"])
    _conv(out, f"{prefix}pos_conv_embed.conv", params["pos_conv_embed"]["conv"])
    _norm(out, f"{prefix}layer_norm", params["layer_norm"])
    n_layers = sum(1 for k in params if k.startswith("layer") and k[5:].isdigit())
    for i in range(n_layers):
        lp = params[f"layer{i}"]
        lpre = f"{prefix}layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "intermediate_dense", "output_dense"):
            _dense(out, f"{lpre}.{name}", lp[name])
        _norm(out, f"{lpre}.layer_norm", lp["layer_norm"])
        _norm(out, f"{lpre}.final_layer_norm", lp["final_layer_norm"])
    return out


def faceformer_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's FaceFormer state dict from the JAX FaceFormer's params."""
    if "cross_q_kernel" in params:
        raise NotImplementedError("BIWI FaceFormer weights are not ported yet")
    out = wav2vec2_state_dict_from_jax(params["audio_encoder"], "audio_encoder.")
    dense_names = (
        "audio_feature_map", "obj_vector", "vertice_map", "vertice_map_r",
        "dec_q", "dec_k", "dec_v", "dec_out", "cross_v", "cross_out",
        "linear1", "linear2",
    )
    for name in dense_names:
        p = {"kernel": params[f"{name}_kernel"]}
        if f"{name}_bias" in params:
            p["bias"] = params[f"{name}_bias"]
        _dense(out, name, p)
    for i in (1, 2, 3):
        _norm(out, f"norm{i}", {"scale": params[f"norm{i}_scale"], "bias": params[f"norm{i}_bias"]})
    return out

"""Carry FaceFormer weights from the JAX package's parameter tree.

``faceformer_state_dict_from_jax(params)`` takes the JAX FaceFormer's
``variables["params"]`` as a nested dict of numpy arrays (what
``jax.tree.map(np.asarray, variables["params"])`` gives) and returns the
port's state dict. Conversions: flax Dense ``(in, out)`` kernels transpose
into ``nn.Linear`` weights; flax conv kernels ``(k, c_in/groups, c_out)``
become ``(c_out, c_in/groups, k)``; LayerNorm/GroupNorm ``scale`` becomes
``weight``. The positional conv is already weight-norm-folded on the JAX
side. ``faceformer_jax_tree_from_state_dict`` is the inverse map: it lays a
port state dict, or a dict of the port's gradients under the same names,
out as the JAX tree, so that tests compare gradients leaf by leaf with
``jax.grad``'s. Imports no JAX.
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


_DENSE_NAMES = (
    "audio_feature_map", "obj_vector", "vertice_map", "vertice_map_r",
    "dec_q", "dec_k", "dec_v", "dec_out", "cross_v", "cross_out",
    "linear1", "linear2",
)
# live only in BIWI mode (the vocaset diagonal makes them inert, so vocaset
# trees omit them)
_BIWI_DENSE_NAMES = ("cross_q", "cross_k")


def faceformer_state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The port's FaceFormer state dict from the JAX FaceFormer's params; a
    BIWI tree carries ``cross_q``/``cross_k`` too."""
    out = wav2vec2_state_dict_from_jax(params["audio_encoder"], "audio_encoder.")
    names = _DENSE_NAMES + (_BIWI_DENSE_NAMES if "cross_q_kernel" in params else ())
    for name in names:
        p = {"kernel": params[f"{name}_kernel"]}
        if f"{name}_bias" in params:
            p["bias"] = params[f"{name}_bias"]
        _dense(out, name, p)
    for i in (1, 2, 3):
        _norm(out, f"norm{i}", {"scale": params[f"norm{i}_scale"], "bias": params[f"norm{i}_bias"]})
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _module_tree(sd: Mapping, prefix: str, kind: str) -> dict:
    """One flax module's leaves from ``{prefix}.weight`` / ``{prefix}.bias``:
    ``kind`` is "dense" (transpose), "conv" ((c_out, c_in, k) -> (k, c_in,
    c_out)) or "norm" (``weight`` is ``scale``)."""
    w = _np(sd[f"{prefix}.weight"])
    if kind == "norm":
        out = {"scale": w}
    elif kind == "conv":
        out = {"kernel": np.transpose(w, (2, 1, 0))}
    else:
        out = {"kernel": w.T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def wav2vec2_jax_tree_from_state_dict(sd: Mapping, prefix: str = "") -> dict:
    """The JAX encoder's parameter tree (numpy) from a port state dict, or
    from a dict of gradients under the state dict's names."""
    fe = {}
    i = 0
    while f"{prefix}feature_encoder.conv_layers.{i}.weight" in sd:
        fe[f"conv{i}"] = _module_tree(sd, f"{prefix}feature_encoder.conv_layers.{i}", "conv")
        i += 1
    fe["group_norm"] = _module_tree(sd, f"{prefix}feature_encoder.group_norm", "norm")
    tree = {
        "feature_encoder": fe,
        "feature_projection": {
            "layer_norm": _module_tree(sd, f"{prefix}feature_projection.layer_norm", "norm"),
            "projection": _module_tree(sd, f"{prefix}feature_projection.projection", "dense"),
        },
        "masked_spec_embed": _np(sd[f"{prefix}masked_spec_embed"]),
        "pos_conv_embed": {"conv": _module_tree(sd, f"{prefix}pos_conv_embed.conv", "conv")},
        "layer_norm": _module_tree(sd, f"{prefix}layer_norm", "norm"),
    }
    i = 0
    while f"{prefix}layers.{i}.q_proj.weight" in sd:
        lpre = f"{prefix}layers.{i}"
        layer = {
            name: _module_tree(sd, f"{lpre}.{name}", "dense")
            for name in ("q_proj", "k_proj", "v_proj", "out_proj", "intermediate_dense", "output_dense")
        }
        layer["layer_norm"] = _module_tree(sd, f"{lpre}.layer_norm", "norm")
        layer["final_layer_norm"] = _module_tree(sd, f"{lpre}.final_layer_norm", "norm")
        tree[f"layer{i}"] = layer
        i += 1
    return tree


def faceformer_jax_tree_from_state_dict(sd: Mapping) -> dict:
    """The JAX FaceFormer's parameter tree (numpy) from a port state dict, or
    from a dict of gradients under the state dict's names: the inverse of
    ``faceformer_state_dict_from_jax``."""
    tree = {"audio_encoder": wav2vec2_jax_tree_from_state_dict(sd, "audio_encoder.")}
    names = _DENSE_NAMES + (_BIWI_DENSE_NAMES if "cross_q.weight" in sd else ())
    for name in names:
        for leaf, value in _module_tree(sd, name, "dense").items():
            tree[f"{name}_{leaf}"] = value
    for i in (1, 2, 3):
        for leaf, value in _module_tree(sd, f"norm{i}", "norm").items():
            tree[f"norm{i}_{leaf}"] = value
    return tree

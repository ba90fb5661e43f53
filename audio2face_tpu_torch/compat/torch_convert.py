"""Reference PyTorch checkpoints -> the port's state dicts.

Port of ``audio2face_tpu/compat/torch_convert.py``. The reference names its
layers by their index in ``nn.Sequential`` stacks (``analysis_net.0.weight``);
the port names them after the JAX modules (``analysis0.conv.weight``). Both
sides are torch, so each converter is a renaming: no layout changes. Inputs
are mappings name -> tensor or numpy array (``state_dict_to_numpy`` on a
live module, or ``load_torch_checkpoint`` on a ``.ckpt``/``.pt`` file, which
strips the LightningModule's ``model.`` prefix); outputs are the port's
state dicts of f32 CPU tensors. BatchNorm's ``num_batches_tracked`` is not
carried (the port's BatchNorm keeps no step count).
"""

from __future__ import annotations

import pickle
import warnings
from typing import Mapping

import numpy as np
import torch

from audio2face_tpu_torch.compat.jax_params import _t


def state_dict_to_numpy(module_or_dict) -> dict[str, np.ndarray]:
    """torch module or state_dict -> plain {name: np.ndarray}."""
    if hasattr(module_or_dict, "state_dict"):
        module_or_dict = module_or_dict.state_dict()
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
            for k, v in module_or_dict.items()}


def load_torch_checkpoint(path: str, strip_prefix: str = "model.") -> dict[str, torch.Tensor]:
    """A torch/Lightning checkpoint file as {name: f32 CPU tensor}, with the
    LightningModule's ``model.`` attribute prefix stripped.

    The file is read with ``weights_only=True``. A Lightning checkpoint that
    also pickles its ``hyper_parameters`` or loop state as Python objects is
    refused by that loader; such a file is then read with
    ``weights_only=False``, which can run code from the file: load only
    checkpoints you trust."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(
            f"{path} holds pickled Python objects besides its tensors; reading it "
            "with weights_only=False", stacklevel=2)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    out = {}
    for k, v in sd.items():
        if strip_prefix and k.startswith(strip_prefix):
            k = k[len(strip_prefix):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().float()
    return out


def _copy(out: dict, sd: Mapping, dst: str, src: str, leaves) -> None:
    for dst_leaf, src_leaf in leaves:
        out[f"{dst}.{dst_leaf}"] = _t(sd[f"{src}.{src_leaf}"])


def _conv(out: dict, sd: Mapping, dst: str, src: str) -> None:
    _copy(out, sd, f"{dst}.conv", src, (("weight", "weight"), ("bias", "bias")))


def _bn(out: dict, sd: Mapping, dst: str, src: str) -> None:
    names = ("weight", "bias", "running_mean", "running_var")
    _copy(out, sd, f"{dst}.bn", src, zip(names, names))


def _lstm(out: dict, sd: Mapping, dst: str, src: str) -> None:
    _copy(out, sd, dst, src, (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                              ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")))


def _mlp_head(out: dict, sd: Mapping, dst: str, src: str) -> None:
    # Sequential [Linear, Linear, Tanh, Linear, Linear] -> indices 0, 1, 3, 4
    for i, idx in enumerate((0, 1, 3, 4)):
        _copy(out, sd, f"{dst}.fc{i}", f"{src}.{idx}", (("weight", "weight"), ("bias", "bias")))


def convert_audio2mesh(sd: Mapping) -> dict[str, torch.Tensor]:
    """Reference Audio2Mesh state dict -> the port's. analysis_net convs at
    0, 3, 6, 9, 12 and BNs at 1, 4, 7, 10, 13; articulation_net convs at 0,
    3, 6, 10, 13 and BNs at 1, 4, 7, 9, 12; output_net linears at 0, 1, 3,
    4."""
    out: dict = {}
    for i, idx in enumerate((0, 3, 6, 9, 12)):
        _conv(out, sd, f"analysis{i}", f"analysis_net.{idx}")
        _bn(out, sd, f"analysis{i}_bn", f"analysis_net.{idx + 1}")
    for i, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4), (6, 7))):
        _conv(out, sd, f"artic{i}", f"articulation_net.{conv_idx}")
        _bn(out, sd, f"artic{i}_bn", f"articulation_net.{bn_idx}")
    _bn(out, sd, "artic3_pre_bn", "articulation_net.9")
    _conv(out, sd, "artic3", "articulation_net.10")
    _bn(out, sd, "artic4_pre_bn", "articulation_net.12")
    _conv(out, sd, "artic4", "articulation_net.13")
    _mlp_head(out, sd, "output", "output_net")
    return out


def convert_voca(sd: Mapping) -> dict[str, torch.Tensor]:
    """Reference VOCA state dict -> the port's: time_conv convs at 0, 2, 4,
    6; decoder linears at 0, 1, 3, 4. No BatchNorm."""
    out: dict = {}
    for i, idx in enumerate((0, 2, 4, 6)):
        _conv(out, sd, f"time_conv{i}", f"time_conv.{idx}")
    _mlp_head(out, sd, "decoder", "decoder")
    return out


def convert_song2face(sd: Mapping) -> dict[str, torch.Tensor]:
    """Reference Song2Face state dict -> the port's: each
    ``vocal_encoder_nn.{i}`` / ``regression_net.{i}`` is a nested Sequential
    [conv, (bn), relu]; two LSTMs; the output_net head."""
    out: dict = {}
    for i in range(5):
        _conv(out, sd, f"enc{i}", f"vocal_encoder_nn.{i}.0")
        _bn(out, sd, f"enc{i}_bn", f"vocal_encoder_nn.{i}.1")
    _lstm(out, sd, "lstm1", "vocal_encoder_lstm1")
    _lstm(out, sd, "lstm2", "vocal_encoder_lstm2")
    for i in range(3):
        _conv(out, sd, f"reg{i}", f"regression_net.{i}.0")
        _bn(out, sd, f"reg{i}_bn", f"regression_net.{i}.1")
    _conv(out, sd, "reg3", "regression_net.3.0")
    _mlp_head(out, sd, "output", "output_net")
    return out


_MODEL_CONVERTERS = {
    "audio2mesh": convert_audio2mesh,
    "voca": convert_voca,
    "song2face": convert_song2face,
}


def convert_state_dict(modelname: str, sd: Mapping) -> dict[str, torch.Tensor]:
    """Dispatch by model name. FaceFormer goes to
    ``compat.faceformer_convert.convert_faceformer`` (vocaset)."""
    if modelname == "faceformer":
        from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer

        return convert_faceformer(sd)
    try:
        return _MODEL_CONVERTERS[modelname](sd)
    except KeyError:
        raise KeyError(f"No converter for model {modelname!r}") from None

"""The port's state dicts -> reference PyTorch state dicts (outbound).

Port of ``audio2face_tpu/compat/torch_export.py``, the inverse of
``compat/torch_convert.py`` and ``compat/faceformer_convert.py``: models
trained by the port load back into the reference's PyTorch modules, under
their ``nn.Sequential`` names (``analysis_net.0.weight`` for the port's
``analysis0.conv.weight``). Both sides are torch, so each exporter is a
renaming, plus FaceFormer's packed ``in_proj`` and the positional conv's
weight norm. Inputs are the port's state dicts (tensors on any device, or
numpy arrays); outputs are {name: numpy f32}. BatchNorm's
``num_batches_tracked`` is written as int64 0: the port keeps no step
count.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from audio2face_tpu_torch.compat.jax_params import _np


def _np32(x) -> np.ndarray:
    return np.asarray(_np(x), dtype=np.float32)


def _copy(out: dict, sd: Mapping, dst: str, src: str, leaves) -> None:
    for dst_leaf, src_leaf in leaves:
        out[f"{dst}.{dst_leaf}"] = _np32(sd[f"{src}.{src_leaf}"])


def _conv(out: dict, sd: Mapping, dst: str, src: str) -> None:
    _copy(out, sd, dst, f"{src}.conv", (("weight", "weight"), ("bias", "bias")))


def _bn(out: dict, sd: Mapping, dst: str, src: str) -> None:
    names = ("weight", "bias", "running_mean", "running_var")
    _copy(out, sd, dst, f"{src}.bn", zip(names, names))
    out[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)


def _lstm(out: dict, sd: Mapping, dst: str, src: str) -> None:
    _copy(out, sd, dst, src, (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                              ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")))


def _mlp_head(out: dict, sd: Mapping, dst: str, src: str) -> None:
    # Sequential [Linear, Linear, Tanh, Linear, Linear] -> indices 0, 1, 3, 4
    for i, idx in enumerate((0, 1, 3, 4)):
        _copy(out, sd, f"{dst}.{idx}", f"{src}.fc{i}", (("weight", "weight"), ("bias", "bias")))


def export_audio2mesh(sd: Mapping) -> dict[str, np.ndarray]:
    out: dict = {}
    for i, idx in enumerate((0, 3, 6, 9, 12)):
        _conv(out, sd, f"analysis_net.{idx}", f"analysis{i}")
        _bn(out, sd, f"analysis_net.{idx + 1}", f"analysis{i}_bn")
    for i, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4), (6, 7))):
        _conv(out, sd, f"articulation_net.{conv_idx}", f"artic{i}")
        _bn(out, sd, f"articulation_net.{bn_idx}", f"artic{i}_bn")
    _bn(out, sd, "articulation_net.9", "artic3_pre_bn")
    _conv(out, sd, "articulation_net.10", "artic3")
    _bn(out, sd, "articulation_net.12", "artic4_pre_bn")
    _conv(out, sd, "articulation_net.13", "artic4")
    _mlp_head(out, sd, "output_net", "output")
    return out


def export_voca(sd: Mapping) -> dict[str, np.ndarray]:
    out: dict = {}
    for i, idx in enumerate((0, 2, 4, 6)):
        _conv(out, sd, f"time_conv.{idx}", f"time_conv{i}")
    _mlp_head(out, sd, "decoder", "decoder")
    return out


def export_song2face(sd: Mapping) -> dict[str, np.ndarray]:
    out: dict = {}
    for i in range(5):
        _conv(out, sd, f"vocal_encoder_nn.{i}.0", f"enc{i}")
        _bn(out, sd, f"vocal_encoder_nn.{i}.1", f"enc{i}_bn")
    _lstm(out, sd, "vocal_encoder_lstm1", "lstm1")
    _lstm(out, sd, "vocal_encoder_lstm2", "lstm2")
    for i in range(3):
        _conv(out, sd, f"regression_net.{i}.0", f"reg{i}")
        _bn(out, sd, f"regression_net.{i}.1", f"reg{i}_bn")
    _conv(out, sd, "regression_net.3.0", "reg3")
    _mlp_head(out, sd, "output_net", "output")
    return out


def export_faceformer(sd: Mapping) -> dict[str, np.ndarray]:
    """Full-model export: the decoder plus the ``audio_encoder.*`` key set
    the reference's Faceformer expects (the HF Wav2Vec2Model under that
    attribute), the positional conv in weight-norm form. The decoder's q, k
    and v are packed into one ``in_proj``. The cross-attention q/k
    projections are inert under vocaset's diagonal memory mask and are
    exported as zeros; a BIWI model's live ones round-trip."""
    from audio2face_tpu_torch.compat.wav2vec2_convert import export_wav2vec2, strip_prefix

    out = {f"audio_encoder.{k}": v
           for k, v in export_wav2vec2(strip_prefix(sd, "audio_encoder.")).items()}
    d = _np32(sd["dec_q.weight"]).shape[1]

    def put(dst: str, src: str, bias: bool = True) -> None:
        out[f"{dst}.weight"] = _np32(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _np32(sd[f"{src}.bias"])

    for name in ("audio_feature_map", "vertice_map", "vertice_map_r"):
        put(name, name)
    put("obj_vector", "obj_vector", bias=False)

    layer = "transformer_decoder.layers.0"
    out[f"{layer}.self_attn.in_proj_weight"] = np.concatenate(
        [_np32(sd[f"dec_{n}.weight"]) for n in ("q", "k", "v")], axis=0)
    out[f"{layer}.self_attn.in_proj_bias"] = np.concatenate(
        [_np32(sd[f"dec_{n}.bias"]) for n in ("q", "k", "v")])
    put(f"{layer}.self_attn.out_proj", "dec_out")
    cross_w = np.zeros((3 * d, d), np.float32)
    cross_b = np.zeros((3 * d,), np.float32)
    cross_w[2 * d :] = _np32(sd["cross_v.weight"])
    cross_b[2 * d :] = _np32(sd["cross_v.bias"])
    if "cross_q.weight" in sd:  # biwi mode: live q/k projections round-trip
        cross_w[:d] = _np32(sd["cross_q.weight"])
        cross_b[:d] = _np32(sd["cross_q.bias"])
        cross_w[d : 2 * d] = _np32(sd["cross_k.weight"])
        cross_b[d : 2 * d] = _np32(sd["cross_k.bias"])
    out[f"{layer}.multihead_attn.in_proj_weight"] = cross_w
    out[f"{layer}.multihead_attn.in_proj_bias"] = cross_b
    put(f"{layer}.multihead_attn.out_proj", "cross_out")
    put(f"{layer}.linear1", "linear1")
    put(f"{layer}.linear2", "linear2")
    for i in (1, 2, 3):
        put(f"{layer}.norm{i}", f"norm{i}")
    return out


_EXPORTERS = {
    "audio2mesh": export_audio2mesh,
    "voca": export_voca,
    "song2face": export_song2face,
    "faceformer": export_faceformer,
}


def export_state_dict(modelname: str, port_state_dict: Mapping) -> dict[str, np.ndarray]:
    """The port's state dict -> a reference-named numpy state dict (wrap the
    values with ``torch.as_tensor`` to load them into the PyTorch modules)."""
    try:
        exporter = _EXPORTERS[modelname]
    except KeyError:
        raise KeyError(
            f"No exporter for model {modelname!r}; available: {sorted(_EXPORTERS)}"
        ) from None
    return exporter(port_state_dict)

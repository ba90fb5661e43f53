"""HF wav2vec2 PyTorch weights <-> the port's ``Wav2Vec2Encoder`` state dict.

Port of ``audio2face_tpu/compat/wav2vec2_convert.py``. Inbound
(``convert_wav2vec2``): both weight-norm namings of the positional conv
(``weight_g``/``weight_v`` and ``parametrizations.weight.original{0,1}``)
are folded into a plain kernel, g * v / ||v||, numerically identical at
inference. Names follow HF ``Wav2Vec2Model``; keys may carry a
``wav2vec2.`` or ``audio_encoder.`` prefix, which the caller strips
(``strip_prefix``). Outbound (``export_wav2vec2``): the exact inverse, with
the positional conv re-parameterized into torch's weight-norm form.

HF ``WavLMModel`` names convert too: a LayerNorm after every conv
(``feature_extractor.conv_layers.{i}.layer_norm``, to the port's
``feature_encoder.layer_norms.{i}``), each layer's gate
(``attention.gru_rel_pos_linear``, ``attention.gru_rel_pos_const`` of shape
(1, heads, 1, 1), to (heads,)) and layer 0's relative-position table
(``attention.rel_attn_embed``, to the encoder's ``rel_attn_embed``, which
every layer shares). The layer count is the weights' own.

HF ``Wav2Vec2ConformerModel`` names convert inbound too (a depthwise conv
in layer 0 tells them): the conv biases, each block's ``ffn1``, ``ffn2``,
their LayerNorms, ``self_attn.linear_{q,k,v,out,pos}``, ``pos_bias_u`` and
``pos_bias_v``, and ``conv_module.*`` (the pointwise convs' (out, in, 1)
kernels as (out, in) matrices, the BatchNorm's affine and running
statistics; ``num_batches_tracked`` dropped) keep their names under
``layers.{i}``; the positional conv, which the Conformer builds and never
calls, is skipped. The outbound direction refuses Conformer weights.
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


def _count(sd: Mapping, pattern: str) -> int:
    """How many i make ``pattern.format(i)`` a key of ``sd``, counting from 0."""
    n = 0
    while pattern.format(n) in sd:
        n += 1
    return n


def convert_wav2vec2(sd: Mapping) -> dict[str, torch.Tensor]:
    """HF Wav2Vec2Model (or WavLMModel) state dict -> the port's
    Wav2Vec2Encoder state dict."""
    out: dict = {}

    def put(dst: str, src: str, bias: bool = True) -> None:
        out[f"{dst}.weight"] = _t(sd[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])

    n_convs = _count(sd, "feature_extractor.conv_layers.{}.conv.weight")
    for i in range(n_convs):
        src = f"feature_extractor.conv_layers.{i}.conv"
        put(f"feature_encoder.conv_layers.{i}", src, bias=f"{src}.bias" in sd)
    if "feature_extractor.conv_layers.1.layer_norm.weight" in sd:  # a norm after every conv
        for i in range(n_convs):
            put(f"feature_encoder.layer_norms.{i}", f"feature_extractor.conv_layers.{i}.layer_norm")
    else:
        put("feature_encoder.group_norm", "feature_extractor.conv_layers.0.layer_norm")
    put("feature_projection.layer_norm", "feature_projection.layer_norm")
    put("feature_projection.projection", "feature_projection.projection")
    if "encoder.layers.0.conv_module.depthwise_conv.weight" in sd:
        put("layer_norm", "encoder.layer_norm")
        _convert_conformer_blocks(sd, out)
        return _masked_spec_embed(sd, out)
    out["pos_conv_embed.conv.weight"] = _pos_conv_weight(sd)
    out["pos_conv_embed.conv.bias"] = _t(sd["encoder.pos_conv_embed.conv.bias"])
    put("layer_norm", "encoder.layer_norm")
    for i in range(_count(sd, "encoder.layers.{}.attention.q_proj.weight")):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"layers.{i}.{name}", f"{p}.attention.{name}")
        if f"{p}.attention.gru_rel_pos_linear.weight" in sd:
            put(f"layers.{i}.gru_rel_pos_linear", f"{p}.attention.gru_rel_pos_linear")
            out[f"layers.{i}.gru_rel_pos_const"] = _t(sd[f"{p}.attention.gru_rel_pos_const"]).reshape(-1)
        put(f"layers.{i}.layer_norm", f"{p}.layer_norm")
        for name in ("intermediate_dense", "output_dense"):
            put(f"layers.{i}.{name}", f"{p}.feed_forward.{name}")
        put(f"layers.{i}.final_layer_norm", f"{p}.final_layer_norm")
    if "encoder.layers.0.attention.rel_attn_embed.weight" in sd:
        out["rel_attn_embed.weight"] = _t(sd["encoder.layers.0.attention.rel_attn_embed.weight"])
    return _masked_spec_embed(sd, out)


def _masked_spec_embed(sd: Mapping, out: dict) -> dict:
    if "masked_spec_embed" in sd:
        out["masked_spec_embed"] = _t(sd["masked_spec_embed"])
    else:
        out["masked_spec_embed"] = torch.zeros(out["feature_projection.projection.weight"].shape[0])
    return out


# a Conformer block's tensors whose names the port keeps
_CONFORMER_KEPT = tuple(
    [f"{n}.{leaf}" for n in ("ffn1_layer_norm", "self_attn_layer_norm", "ffn2_layer_norm",
                             "final_layer_norm", "conv_module.layer_norm",
                             "ffn1.intermediate_dense", "ffn1.output_dense",
                             "ffn2.intermediate_dense", "ffn2.output_dense", "self_attn.linear_q",
                             "self_attn.linear_k", "self_attn.linear_v", "self_attn.linear_out")
     for leaf in ("weight", "bias")]
    + ["self_attn.linear_pos.weight", "self_attn.pos_bias_u", "self_attn.pos_bias_v",
       "conv_module.depthwise_conv.weight"]
    + [f"conv_module.batch_norm.{leaf}" for leaf in ("weight", "bias", "running_mean",
                                                      "running_var")])


def _convert_conformer_blocks(sd: Mapping, out: dict) -> None:
    """HF ``Wav2Vec2ConformerEncoderLayer`` tensors -> the port's
    ``layers.{i}`` (module note)."""
    for i in range(_count(sd, "encoder.layers.{}.self_attn.linear_q.weight")):
        src, dst = f"encoder.layers.{i}.", f"layers.{i}."
        for name in _CONFORMER_KEPT:
            out[dst + name] = _t(sd[src + name])
        for name in ("pointwise_conv1", "pointwise_conv2"):
            out[f"{dst}conv_module.{name}.weight"] = _t(
                sd[f"{src}conv_module.{name}.weight"]).squeeze(-1)


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Outbound: the port's Wav2Vec2Encoder state dict -> HF state-dict names.
# ---------------------------------------------------------------------------


def _np32(x) -> np.ndarray:
    return np.asarray(_np(x), dtype=np.float32)


def export_wav2vec2(sd: Mapping) -> dict[str, np.ndarray]:
    """The port's Wav2Vec2Encoder state dict -> HF ``Wav2Vec2Model`` (or,
    with WavLM's weights, ``WavLMModel``) state dict (numpy f32), every
    layer ``sd`` holds.

    The exact inverse of :func:`convert_wav2vec2`: the positional conv kernel
    is re-parameterized into torch's ``parametrizations.weight.original{0,1}``
    weight-norm form (dim=2: one norm per kernel position over (O, I)), so
    ``g * v / ||v||`` gives the folded kernel back at load. Lets FaceFormer
    models trained by the port load into the reference's module, which
    expects the full ``audio_encoder.*`` key set. Conformer weights are
    refused."""
    if "layers.0.conv_module.depthwise_conv.weight" in sd:
        raise ValueError("export_wav2vec2 writes wav2vec2 and WavLM names; the Conformer "
                         "encoder's outbound names are not mapped")
    out: dict[str, np.ndarray] = {}

    def put(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = _np32(sd[f"{src}.weight"])
        if f"{src}.bias" in sd:
            out[f"{dst}.bias"] = _np32(sd[f"{src}.bias"])

    n_convs = _count(sd, "feature_encoder.conv_layers.{}.weight")
    for i in range(n_convs):
        put(f"feature_extractor.conv_layers.{i}.conv", f"feature_encoder.conv_layers.{i}")
        if "feature_encoder.layer_norms.0.weight" in sd:
            put(f"feature_extractor.conv_layers.{i}.layer_norm", f"feature_encoder.layer_norms.{i}")
    if "feature_encoder.group_norm.weight" in sd:
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
    for i in range(_count(sd, "layers.{}.q_proj.weight")):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{p}.attention.{name}", f"layers.{i}.{name}")
        if f"layers.{i}.gru_rel_pos_linear.weight" in sd:
            put(f"{p}.attention.gru_rel_pos_linear", f"layers.{i}.gru_rel_pos_linear")
            out[f"{p}.attention.gru_rel_pos_const"] = _np32(
                sd[f"layers.{i}.gru_rel_pos_const"]).reshape(1, -1, 1, 1)
        for name in ("intermediate_dense", "output_dense"):
            put(f"{p}.feed_forward.{name}", f"layers.{i}.{name}")
        put(f"{p}.layer_norm", f"layers.{i}.layer_norm")
        put(f"{p}.final_layer_norm", f"layers.{i}.final_layer_norm")
    if "rel_attn_embed.weight" in sd:
        out["encoder.layers.0.attention.rel_attn_embed.weight"] = _np32(sd["rel_attn_embed.weight"])
    out["masked_spec_embed"] = _np32(sd["masked_spec_embed"])
    return out

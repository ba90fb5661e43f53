"""FaceFormer (vocaset) with the wav2vec2-Conformer Large speech encoder
(relative positions), at the published widths: weights, the program's
entries and the plain reference, for
``faceformer_conformer_relpos_large.json``.

The weights are the parameters of FaceFormer under the port's names, made
from the seed on the device by the rule of ``faceformer_vocaset.py``, with
the Conformer's own: a bias on every conv of the stack and a LayerNorm
after each (no group norm), no positional conv, and 24 blocks (two FFNs,
the relative-position attention with ``linear_pos``, ``pos_bias_u`` and
``pos_bias_v``, the conv module with its BatchNorm's running statistics).
``linear_pos`` is drawn at 4 sqrt(2) times the LeCun scale: the
sinusoid's entries have a mean square of 1/2, so ``r``'s entries have a
variance of 16 and ``q' . r``'s logits four times the spread of ``q .
k``'s, heads led by position as a trained Conformer's local heads are. At
sqrt(2) (``q . r`` as large as ``q . k``) the reference without ``q' . r``
read 0.089-0.123 against the port's 0.025-0.057 (H100, 3 and 10 seeds),
too close for a limit between them; at 4 sqrt(2) it reads 0.37-0.39 and
the port 0.030-0.044 (2 seeds).
The same tensors go to the program and to the reference. The program is
the port's ``FaceFormerPredictor``, which builds the encoder the weights
hold.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from benchmark import weights as wmake
from benchmark.counts import faceformer_conformer as counts
from benchmark.counts import work
from benchmark.reference import faceformer_conformer as ref
from benchmark.run import load_module

_vocaset = load_module(Path(__file__).with_name("faceformer_vocaset.py"), "bench_config_ff_base")
ENC = ref.ENC
POS_GAIN = 4.0 * math.sqrt(2.0)


def shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter, under the port's names."""
    enc = cfg["conformer"]
    h, f, k = enc["hidden_size"], enc["intermediate_size"], enc["conv_depthwise_kernel_size"]
    heads = enc["num_attention_heads"]
    # the decoder and the head as vocaset's; the encoder's layers replaced
    base = {**enc, "num_hidden_layers": 0, "num_conv_pos_embeddings": 1,
            "num_conv_pos_embedding_groups": 1}
    out = {n: s for n, s in _vocaset.shapes({**cfg, "wav2vec2": base}).items()
           if not n.startswith((f"{ENC}pos_conv_embed.", f"{ENC}feature_encoder.group_norm."))}
    for i, c in enumerate(enc["conv_dim"]):
        out[f"{ENC}feature_encoder.conv_layers.{i}.bias"] = (c,)
        out[f"{ENC}feature_encoder.layer_norms.{i}.weight"] = (c,)
        out[f"{ENC}feature_encoder.layer_norms.{i}.bias"] = (c,)

    def linear(name, n_in, n_out, bias=True):
        out[name + ".weight"] = (n_out, n_in)
        if bias:
            out[name + ".bias"] = (n_out,)

    def norm(name, n):
        out[name + ".weight"] = (n,)
        out[name + ".bias"] = (n,)

    for i in range(enc["num_hidden_layers"]):
        p = f"{ENC}layers.{i}."
        for ffn in ("ffn1", "ffn2"):
            norm(p + ffn + "_layer_norm", h)
            linear(p + ffn + ".intermediate_dense", h, f)
            linear(p + ffn + ".output_dense", f, h)
        norm(p + "self_attn_layer_norm", h)
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            linear(p + "self_attn." + name, h, h)
        linear(p + "self_attn.linear_pos", h, h, bias=False)
        out[p + "self_attn.pos_bias_u"] = (heads, h // heads)
        out[p + "self_attn.pos_bias_v"] = (heads, h // heads)
        norm(p + "conv_module.layer_norm", h)
        linear(p + "conv_module.pointwise_conv1", h, 2 * h, bias=False)
        out[p + "conv_module.depthwise_conv.weight"] = (h, 1, k)
        norm(p + "conv_module.batch_norm", h)
        out[p + "conv_module.batch_norm.running_mean"] = (h,)
        out[p + "conv_module.batch_norm.running_var"] = (h,)
        linear(p + "conv_module.pointwise_conv2", h, h, bias=False)
        norm(p + "final_layer_norm", h)
    return out


def rule(name: str, shape: tuple) -> tuple:
    if name.endswith("running_mean"):
        return ("normal", 0.1, 0.0)
    if name.endswith("running_var"):
        return ("lognormal", 0.1, 0.0)
    if name.endswith(("pos_bias_u", "pos_bias_v")):
        return ("normal", 0.5, 0.0)
    if name.endswith("linear_pos.weight"):
        return ("normal", wmake.lecun(shape, POS_GAIN), 0.0)
    return _vocaset.rule(name, shape)


def weights(cfg: dict, seed: int, device) -> dict:
    return wmake.make(shapes(cfg), rule, seed, device)


def predictor(cfg: dict, w: dict, device):
    """The port's offline predictor, serving these weights in bf16; the
    encoder is the one the weights hold."""
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    p = cfg["predictor"]
    return FaceFormerPredictor(
        n_verts=cfg["vertice_dim"], n_onehot=cfg["n_styles"], state_dict=w,
        bf16=cfg["compute_dtype"] == "bfloat16", max_batch=p["max_batch"],
        bucket_seconds=p["bucket_seconds"], unit_scale=cfg["unit_scale"], device=device)


def install_spans(pred, span) -> None:
    """Harness spans around the predictor's model call, the audio encoder
    inside it, each block's conv module inside that, and the vertex head
    with the copy to the host."""
    pred._hidden_fn = span("model", pred._hidden_fn)
    enc = pred.model.audio_encoder
    enc.forward = span("encode", enc.forward)
    for layer in enc.layers:
        layer.conv_module.forward = span("conv_module", layer.conv_module.forward)
    pred._emit_vertices = span("output", pred._emit_vertices)


def reference(cfg: dict, w: dict, audios: list, one_hot: np.ndarray, templates: list,
              device, quant=None) -> list:
    return ref.predict_clips(w, audios, torch.as_tensor(one_hot, device=device), templates,
                             cfg, quant)


def flops(cfg: dict, n_samples: int) -> float:
    return counts.faceformer_conformer_flops(n_samples, cfg)


def kernel_work(cfg: dict, lengths: list) -> dict:
    """Valid work of the clips' K1 (16 heads of 64 in each of the 24
    blocks, with the Transformer-XL term, over each clip's 60 fps frames)
    and K3 launches: {kernel: (operations, bytes, peak operations/s)}."""
    enc = cfg["conformer"]
    frames = [work.frame_count(n, cfg["fps"], cfg["sample_rate"]) for n in lengths]
    heads = enc["num_attention_heads"]
    f1, b1 = counts.k1_xl_work(frames, frames, heads, enc["hidden_size"] // heads)
    n_layers = enc["num_hidden_layers"]
    f3, b3 = work.k3_work(frames, cfg["period"])
    return {"k1_xl": (n_layers * f1, n_layers * b1, work.PEAK_BF16_FLOPS),
            "k3": (f3, b3, work.PEAK_F32_FLOPS)}

"""FaceFormer (vocaset) with wav2vec2-base: weights, the program's entries
and the plain reference, for ``faceformer_vocaset.json``.

The weights are the parameters of FaceFormer under the port's names, made
from the seed on the device (``benchmark/weights.py``); the same tensors go
to the program and to the reference. The program is the port's
``FaceFormerPredictor``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import weights as wmake
from benchmark.counts import work
from benchmark.reference import faceformer as ref

ENC = ref.ENC


def shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter, under the port's names."""
    w2v = cfg["wav2vec2"]
    h, f, d, v = w2v["hidden_size"], w2v["intermediate_size"], cfg["feature_dim"], cfg["vertice_dim"]
    out, c_in = {}, 1
    for i, (c, k) in enumerate(zip(w2v["conv_dim"], w2v["conv_kernel"])):
        out[f"{ENC}feature_encoder.conv_layers.{i}.weight"] = (c, c_in, k)
        c_in = c
    c = w2v["conv_dim"][-1]

    def linear(name, n_in, n_out, bias=True):
        out[name + ".weight"] = (n_out, n_in)
        if bias:
            out[name + ".bias"] = (n_out,)

    def norm(name, n):
        out[name + ".weight"] = (n,)
        out[name + ".bias"] = (n,)

    norm(f"{ENC}feature_encoder.group_norm", c)
    norm(f"{ENC}feature_projection.layer_norm", c)
    linear(f"{ENC}feature_projection.projection", c, h)
    out[f"{ENC}masked_spec_embed"] = (h,)
    groups, k = w2v["num_conv_pos_embedding_groups"], w2v["num_conv_pos_embeddings"]
    out[f"{ENC}pos_conv_embed.conv.weight"] = (h, h // groups, k)
    out[f"{ENC}pos_conv_embed.conv.bias"] = (h,)
    norm(f"{ENC}layer_norm", h)
    for i in range(w2v["num_hidden_layers"]):
        p = f"{ENC}layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(p + name, h, h)
        norm(p + "layer_norm", h)
        linear(p + "intermediate_dense", h, f)
        linear(p + "output_dense", f, h)
        norm(p + "final_layer_norm", h)
    linear("audio_feature_map", h, d)
    linear("obj_vector", cfg["n_styles"], d, bias=False)
    linear("vertice_map", v, d)
    linear("vertice_map_r", d, v)
    for name in ("dec_q", "dec_k", "dec_v", "dec_out", "cross_v", "cross_out"):
        linear(name, d, d)
    linear("linear1", d, cfg["dim_feedforward"])
    linear("linear2", cfg["dim_feedforward"], d)
    for i in (1, 2, 3):
        norm(f"norm{i}", d)
    return out


# the feedback map vertice_map . vertice_map_r has a gain near this, so
# the decoder's carried embedding stays of the style's size
FEEDBACK_GAIN = 0.5


def rule(name: str, shape: tuple) -> tuple:
    if "norm" in name:  # layer and group norms
        return ("normal", 0.1, 1.0) if name.endswith("weight") else ("normal", 0.1, 0.0)
    if name.endswith("bias"):
        return ("normal", 0.02, 0.0)
    if name.endswith("masked_spec_embed"):
        return ("normal", 0.1, 0.0)
    if name == "vertice_map.weight":
        return ("normal", wmake.lecun(shape, FEEDBACK_GAIN), 0.0)
    return ("normal", wmake.lecun(shape), 0.0)


def weights(cfg: dict, seed: int, device) -> dict:
    return wmake.make(shapes(cfg), rule, seed, device)


def predictor(cfg: dict, w: dict, device):
    """The port's offline predictor, serving these weights in bf16."""
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    p = cfg["predictor"]
    return FaceFormerPredictor(
        n_verts=cfg["vertice_dim"], n_onehot=cfg["n_styles"], state_dict=w,
        bf16=cfg["compute_dtype"] == "bfloat16", max_batch=p["max_batch"],
        bucket_seconds=p["bucket_seconds"], unit_scale=cfg["unit_scale"], device=device)


def install_spans(pred, span) -> None:
    """Harness spans around the predictor's model call and its vertex head
    with the copy to the host."""
    pred._hidden_fn = span("model", pred._hidden_fn)
    pred._emit_vertices = span("output", pred._emit_vertices)


def reference(cfg: dict, w: dict, audios: list, one_hot: np.ndarray, templates: list,
              device, quant=None) -> list:
    return ref.predict_clips(w, audios, torch.as_tensor(one_hot, device=device), templates,
                             cfg, quant)


def flops(cfg: dict, n_samples: int) -> float:
    return work.faceformer_flops(n_samples, cfg)


def kernel_work(cfg: dict, lengths: list) -> dict:
    """Valid work of the clips' K1 (every encoder layer) and K3 launches:
    {kernel: (operations, bytes, peak operations/s)}."""
    frames = [work.frame_count(n, cfg["fps"], cfg["sample_rate"]) for n in lengths]
    w2v = cfg["wav2vec2"]
    heads = w2v["num_attention_heads"]
    f1, b1 = work.k1_work(frames, frames, heads, w2v["hidden_size"] // heads)
    n_layers = w2v["num_hidden_layers"]
    f3, b3 = work.k3_work(frames, cfg["period"])
    return {"k1": (n_layers * f1, n_layers * b1, work.PEAK_BF16_FLOPS),
            "k3": (f3, b3, work.PEAK_F32_FLOPS)}

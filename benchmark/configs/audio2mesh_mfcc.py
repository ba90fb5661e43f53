"""Audio2Mesh on MFCC (the repo's default ``config.yaml``): weights, the
program's entry and the plain reference, for ``audio2mesh_mfcc.json``.

The weights are the model's parameters and batch-norm statistics under the
port's names, made from the seed on the device; the same tensors go to the
program and to the reference. The program is the port's
``FramePredictor``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import weights as wmake
from benchmark.counts import work
from benchmark.reference import audio2mesh as ref

# the MFCC image's entries are tens of dB (the first coefficient up to
# ~1,000): the first conv's kernels are scaled down by this, and the later
# convs take the ReLU gain sqrt(2), so each layer's input stays near unit
# size and the tanh of the vertex MLP is not saturated
FEATURE_SCALE = 40.0


def shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter and batch-norm statistic."""
    out = {}

    def conv(name, c_in, c_out, kh, kw):
        out[name + ".conv.weight"] = (c_out, c_in, kh, kw)
        out[name + ".conv.bias"] = (c_out,)

    def bn(name, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{s}"] = (c,)

    c_in = 1
    for i, c in enumerate(cfg["analysis_channels"]):
        conv(f"analysis{i}", c_in, c, 1, 3)
        bn(f"analysis{i}_bn", c)
        c_in = c
    for i, (k, _, _) in enumerate(cfg["articulation"]):
        if i < 3:
            conv(f"artic{i}", c_in, 256, k, 1)
            bn(f"artic{i}_bn", 256)
        else:
            bn(f"artic{i}_pre_bn", c_in)
            conv(f"artic{i}", c_in, 256, k, 1)
        c_in = 256
    dims = [c_in + cfg["n_styles"]] + list(cfg["mlp"]) + [cfg["vertice_dim"]]
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"output.fc{i}.weight"] = (b, a)
        out[f"output.fc{i}.bias"] = (b,)
    return out


def rule(name: str, shape: tuple) -> tuple:
    if ".bn." in name:
        if name.endswith("running_var"):
            return ("lognormal", 0.2, 0.0)
        return ("normal", 0.1, 1.0) if name.endswith("weight") else ("normal", 0.1, 0.0)
    if name.endswith("bias"):
        return ("normal", 0.02, 0.0)
    if name == "analysis0.conv.weight":
        return ("normal", wmake.lecun(shape) / FEATURE_SCALE, 0.0)
    if ".conv." in name:
        return ("normal", wmake.lecun(shape, math.sqrt(2.0)), 0.0)
    return ("normal", wmake.lecun(shape), 0.0)


def weights(cfg: dict, seed: int, device) -> dict:
    return wmake.make(shapes(cfg), rule, seed, device)


def exp_config(cfg: dict):
    """The port's experiment config for this file (``config.yaml``'s keys)."""
    from audio2face_tpu_torch.config import ExpConfig

    keys = ("batch_size", "modelname", "split_frame", "percision", "lr", "feature_extractor",
            "sample_rate", "n_feature", "out_dim", "win_length", "hop_length")
    return ExpConfig.from_dict({**{k: cfg[k] for k in keys}, "vertex_count": cfg["vertice_dim"],
                                "one_hot_size": cfg["n_styles"]})


def predictor(cfg: dict, w: dict, device):
    """The port's frame predictor, serving these weights in bf16."""
    from audio2face_tpu_torch.serving import FramePredictor

    p = cfg["predictor"]
    return FramePredictor(exp_config(cfg), state_dict=w, max_batch=p["max_batch"],
                          frame_batch=p["frame_batch"], bucket_seconds=p["bucket_seconds"],
                          unit_scale=cfg["unit_scale"], device=device)


def install_spans(pred, span) -> None:
    """Harness spans around each chunk's model call and, inside it, the
    features."""
    pred._chunk_fn = span("model", pred._chunk_fn)
    pred.extractor = span("features", pred.extractor)


def reference(cfg: dict, w: dict, audios: list, one_hot: np.ndarray, templates: list,
              device, quant=None) -> list:
    return ref.predict_clips(w, audios, torch.as_tensor(one_hot, device=device), templates,
                             cfg, quant)


def flops(cfg: dict, n_samples: int) -> float:
    return work.audio2mesh_flops(n_samples, cfg)


def kernel_work(cfg: dict, lengths: list) -> dict:
    return {}

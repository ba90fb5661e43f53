"""FaceFormer in its BIWI setting with wav2vec2-base, at the published
widths: weights, the program's entries and the plain reference, for
``faceformer_biwi.json``.

The weights are the parameters of FaceFormer under the port's names,
``cross_q`` and ``cross_k`` included (the 2-way cross softmax makes them
live), made from the seed on the device by the rule of
``faceformer_vocaset.py``; the same tensors go to the program and to the
reference. The program is the port's ``FaceFormerPredictor`` with
``dataset="biwi"``, whose decoder is as wide as the weights'.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import weights as wmake
from benchmark.counts import faceformer_biwi as counts
from benchmark.reference import faceformer_biwi as ref
from benchmark.run import load_module

_vocaset = load_module(Path(__file__).with_name("faceformer_vocaset.py"), "bench_config_ff_base")


def shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter, under the port's names."""
    out = _vocaset.shapes(cfg)
    d = cfg["feature_dim"]
    for name in ("cross_q", "cross_k"):
        out[name + ".weight"] = (d, d)
        out[name + ".bias"] = (d,)
    return out


def weights(cfg: dict, seed: int, device) -> dict:
    return wmake.make(shapes(cfg), _vocaset.rule, seed, device)


def predictor(cfg: dict, w: dict, device):
    """The port's offline predictor, serving these weights in bf16 at 25 fps
    (the predictor's BIWI mode fixes fps and period at 25)."""
    from audio2face_tpu_torch.serving import FaceFormerPredictor

    if (cfg["fps"], cfg["period"]) != (25, 25):
        raise ValueError("the predictor's BIWI mode runs 25 fps and period 25")
    p = cfg["predictor"]
    return FaceFormerPredictor(
        n_verts=cfg["vertice_dim"], n_onehot=cfg["n_styles"], state_dict=w,
        bf16=cfg["compute_dtype"] == "bfloat16", max_batch=p["max_batch"],
        bucket_seconds=p["bucket_seconds"], unit_scale=cfg["unit_scale"], device=device,
        dataset="biwi")


def install_spans(pred, span) -> None:
    """Harness spans around the predictor's model call, the decoder inside
    it (the latents' cross projections and the decode loop), and its
    vertex head with the copy to the host."""
    pred._hidden_fn = span("model", pred._hidden_fn)
    pred.model.decode = span("decode", pred.model.decode)
    pred._emit_vertices = span("output", pred._emit_vertices)


def reference(cfg: dict, w: dict, audios: list, one_hot: np.ndarray, templates: list,
              device, quant=None) -> list:
    return ref.predict_clips(w, audios, torch.as_tensor(one_hot, device=device), templates,
                             cfg, quant)


def flops(cfg: dict, n_samples: int) -> float:
    return counts.faceformer_biwi_flops(n_samples, cfg)


def kernel_work(cfg: dict, lengths: list) -> dict:
    """Valid work of the clips' K1 (every encoder layer, over each clip's
    50 fps latents) and K3 (at the configuration's width) launches:
    {kernel: (operations, bytes, peak operations/s)}."""
    from benchmark.counts import work

    w2v = cfg["wav2vec2"]
    latents = [work.conv_stack_lengths(n, w2v["conv_kernel"], w2v["conv_stride"])[-1]
               for n in lengths]
    heads = w2v["num_attention_heads"]
    f1, b1 = work.k1_work(latents, latents, heads, w2v["hidden_size"] // heads)
    n_layers = w2v["num_hidden_layers"]
    frames = [work.frame_count(n, cfg["fps"], cfg["sample_rate"]) for n in lengths]
    f3, b3 = counts.k3_work(frames, cfg["feature_dim"], cfg["period"])
    return {"k1": (n_layers * f1, n_layers * b1, work.PEAK_BF16_FLOPS),
            "k3": (f3, b3, work.PEAK_F32_FLOPS)}

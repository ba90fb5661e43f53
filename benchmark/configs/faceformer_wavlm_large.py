"""FaceFormer (vocaset) with the WavLM Large speech encoder, at the
published widths: weights, the program's entries and the plain reference,
for ``faceformer_wavlm_large.json``.

The weights are the parameters of FaceFormer under the port's names, made
from the seed on the device by the rule of ``faceformer_vocaset.py``, with
WavLM's own: a LayerNorm after every conv (no group norm), each layer's
gate (``gru_rel_pos_linear``, LeCun-normal; ``gru_rel_pos_const`` near 1)
and the shared relative-position table ``rel_attn_embed`` (standard
normal, so the gated bias moves the softmax as much as the scores do). The
same tensors go to the program and to the reference. The program is the
port's ``FaceFormerPredictor``, which builds the encoder the weights hold.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark import weights as wmake
from benchmark.counts import faceformer_wavlm as counts
from benchmark.counts import work
from benchmark.reference import faceformer_wavlm as ref
from benchmark.run import load_module

_vocaset = load_module(Path(__file__).with_name("faceformer_vocaset.py"), "bench_config_ff_base")
ENC = ref.ENC


def radius(enc: dict) -> int:
    """The key - query distance past which WavLM's bucket stays the same."""
    rel = torch.arange(enc["max_bucket_distance"] + 1)
    b = ref.bucket(rel, enc["num_buckets"], enc["max_bucket_distance"])
    return int(torch.nonzero(b != b[-1]).max()) + 1


def shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter, under the port's names."""
    enc = cfg["wavlm"]
    out = _vocaset.shapes({**cfg, "wav2vec2": enc})
    for leaf in ("weight", "bias"):
        del out[f"{ENC}feature_encoder.group_norm.{leaf}"]
        for i, c in enumerate(enc["conv_dim"]):
            out[f"{ENC}feature_encoder.layer_norms.{i}.{leaf}"] = (c,)
    heads = enc["num_attention_heads"]
    hd = enc["hidden_size"] // heads
    for i in range(enc["num_hidden_layers"]):
        p = f"{ENC}layers.{i}."
        out[p + "gru_rel_pos_linear.weight"] = (8, hd)
        out[p + "gru_rel_pos_linear.bias"] = (8,)
        out[p + "gru_rel_pos_const"] = (heads,)
    out[f"{ENC}rel_attn_embed.weight"] = (enc["num_buckets"], heads)
    return out


def rule(name: str, shape: tuple) -> tuple:
    if name.endswith("rel_attn_embed.weight"):
        return ("normal", 1.0, 0.0)
    if name.endswith("gru_rel_pos_const"):
        return ("normal", 0.1, 1.0)
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
    inside it, and its vertex head with the copy to the host."""
    pred._hidden_fn = span("model", pred._hidden_fn)
    enc = pred.model.audio_encoder
    enc.forward = span("encode", enc.forward)
    pred._emit_vertices = span("output", pred._emit_vertices)


def reference(cfg: dict, w: dict, audios: list, one_hot: np.ndarray, templates: list,
              device, quant=None) -> list:
    return ref.predict_clips(w, audios, torch.as_tensor(one_hot, device=device), templates,
                             cfg, quant)


def flops(cfg: dict, n_samples: int) -> float:
    return counts.faceformer_wavlm_flops(n_samples, cfg)


def kernel_work(cfg: dict, lengths: list) -> dict:
    """Valid work of the clips' K1 (16 heads of 64 in each of the 24
    layers, with the gated bias, over each clip's 60 fps frames) and K3
    launches: {kernel: (operations, bytes, peak operations/s)}."""
    enc = cfg["wavlm"]
    frames = [work.frame_count(n, cfg["fps"], cfg["sample_rate"]) for n in lengths]
    heads = enc["num_attention_heads"]
    f1, b1 = counts.k1_relpos_work(frames, frames, heads, enc["hidden_size"] // heads,
                                   radius(enc))
    n_layers = enc["num_hidden_layers"]
    f3, b3 = work.k3_work(frames, cfg["period"])
    return {"k1": (n_layers * f1, n_layers * b1, work.PEAK_BF16_FLOPS),
            "k3": (f3, b3, work.PEAK_F32_FLOPS)}

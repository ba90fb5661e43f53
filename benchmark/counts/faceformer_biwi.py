"""The work of FaceFormer in its BIWI setting at any decoder width d,
counted from the clips' valid lengths by the rules of ``work.py``
(multiply-adds of the valid frames, two operations each; each input byte
read once and each output byte written once).

A clip of n samples has T = n * 25 // 16000 frames and reads 2T latents of
the 50 fps encoder; each decode step runs the dense chain (q | k | v,
W_o, the cross query W_cq and output W_co, the FFN of 2d, the composed
feedback W_fb: 11 d^2 multiply-adds), the self-attention over the t + 1
cached keys and the 2-way cross softmax over its two latents.
"""

from __future__ import annotations

from typing import Sequence

from benchmark.counts import work


def k3_work(frames: Sequence[int], d: int, period: int = 25, elem_bytes: int = 2
            ) -> tuple[float, float]:
    """(operations, bytes) of the BIWI decode loop at width ``d`` over items
    of ``frames[i]`` valid frames: per step the dense chain, the attention
    over the t + 1 cached keys (QK and PV) and the 2-way cross attention
    (QK and PV over 2 latents); the latents' cross keys and values read, the
    hidden states written, a style row an item, the positional table and
    the weights (11 d^2 + 10 d in the compute type, the layer norms' 6 d in
    f32) once."""
    dense = 2.0 * 11 * d * d
    flops = sum(t * (dense + 4.0 * d * 2) + 4.0 * d * t * (t + 1) / 2 for t in frames)
    weight_bytes = elem_bytes * (11 * d * d + 10 * d) + 4 * 6 * d
    nbytes = (elem_bytes * (2 * 2 * d * sum(frames) + d * sum(frames) + d * len(frames)
                            + period * d) + weight_bytes)
    return flops, nbytes


def faceformer_biwi_flops(n_samples: int, cfg: dict) -> float:
    """Operations of FaceFormer (BIWI) on one valid clip of ``n_samples``
    at 16 kHz: the encoder on its 2T latents, the audio map and the
    latents' cross keys and values, the decode loop and the vertex head."""
    t = work.frame_count(n_samples, cfg["fps"], cfg["sample_rate"])
    d, v = cfg["feature_dim"], cfg["vertice_dim"]
    flops = work.wav2vec2_flops(n_samples, 2 * t, cfg["wav2vec2"])
    flops += 2.0 * 2 * t * cfg["wav2vec2"]["hidden_size"] * d + 2.0 * 2 * t * d * d * 2
    flops += k3_work([t], d, cfg["period"])[0]
    return flops + 2.0 * t * d * v

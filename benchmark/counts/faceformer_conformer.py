"""The work of FaceFormer (vocaset) with the wav2vec2-Conformer Large
encoder (relative positions), counted from the clips' valid lengths by the
rules of ``work.py`` (multiply-adds of the valid frames, two operations
each; each input byte read once and each output byte written once).

The encoder: the conv stack (with its biases, not counted), the
projection, then in each of the 24 blocks two FFNs, the q/k/v/out
products, the projection of the offsets' sinusoid (``linear_pos``, 2T - 1
rows), the conv module's two pointwise products and its depthwise conv,
and attention with Transformer-XL's term (``k1_xl_work``). No positional
conv.
"""

from __future__ import annotations

from typing import Sequence

from benchmark.counts import work


def k1_xl_work(q_lens: Sequence[int], kv_lens: Sequence[int], heads: int, head_dim: int,
               elem_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one relative-position flash-attention forward
    over items with ``q_lens[i]`` queries and ``kv_lens[i]`` keys:
    ``work.k1_work``, one more ``head_dim``-wide multiply-add a (query, key,
    head) for ``q' . r(i - j)`` and one add for the table; the bytes of
    ``work.k1_work`` and, per item, the head's rows of R (``head_dim``
    values of ``elem_bytes``) and of the f32 table over the item's 2T - 1
    offsets. The same whatever the kernel does."""
    flops, nbytes = work.k1_work(q_lens, kv_lens, heads, head_dim, elem_bytes)
    pairs = sum(q * kv for q, kv in zip(q_lens, kv_lens))
    flops += (2.0 * head_dim + 1.0) * heads * pairs
    offsets = sum(q + kv - 1 for q, kv in zip(q_lens, kv_lens))
    nbytes += heads * offsets * (head_dim * elem_bytes + 4.0)
    return flops, nbytes


def conformer_flops(n_samples: int, n_frames: int, enc: dict) -> float:
    """Operations of the encoder on one clip (module note)."""
    dims = enc["conv_dim"]
    lengths = work.conv_stack_lengths(n_samples, enc["conv_kernel"], enc["conv_stride"])
    c_in, flops = 1, 0.0
    for length, k, c_out in zip(lengths, enc["conv_kernel"], dims):
        flops += 2.0 * length * k * c_in * c_out
        c_in = c_out
    h, f, t = enc["hidden_size"], enc["intermediate_size"], n_frames
    heads, k = enc["num_attention_heads"], enc["conv_depthwise_kernel_size"]
    flops += 2.0 * t * dims[-1] * h
    per_layer = (2.0 * t * h * f * 4            # two FFNs
                 + 2.0 * t * h * h * 4          # q, k, v, out
                 + 2.0 * (2 * t - 1) * h * h    # linear_pos on the sinusoid
                 + 2.0 * t * h * h * 3          # pointwise 1024 -> 2048 and 1024 -> 1024
                 + 2.0 * t * h * k)             # depthwise
    per_layer += k1_xl_work([t], [t], heads, h // heads)[0]
    return flops + enc["num_hidden_layers"] * per_layer


def faceformer_conformer_flops(n_samples: int, cfg: dict) -> float:
    """Operations of FaceFormer (vocaset) with the Conformer on one valid
    clip of ``n_samples`` at 16 kHz: the encoder, the audio map and cross
    term, the decode loop and the vertex head."""
    enc = cfg["conformer"]
    t = work.frame_count(n_samples, cfg["fps"], cfg["sample_rate"])
    d, v = cfg["feature_dim"], cfg["vertice_dim"]
    flops = conformer_flops(n_samples, t, enc)
    flops += 2.0 * t * enc["hidden_size"] * d + 2.0 * t * d * d * 2
    flops += work.k3_work([t], cfg["period"])[0]
    return flops + 2.0 * t * d * v

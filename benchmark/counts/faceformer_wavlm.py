"""The work of FaceFormer (vocaset) with the WavLM Large encoder, counted
from the clips' valid lengths by the rules of ``work.py`` (multiply-adds of
the valid frames, two operations each; each input byte read once and each
output byte written once).

Beside wav2vec2's work (``work.wav2vec2_flops``: the conv stack, the
projection, the positional conv, the layers' products and attention) each
of WavLM's layers computes the gate (the head's 64 channels through the
(2, 4)-summed 64 -> 2 map, two multiply-adds a channel and head) and adds
the gated bias to every score (one multiply-add a query, key and head).
"""

from __future__ import annotations

from typing import Sequence

from benchmark.counts import work


def k1_relpos_work(q_lens: Sequence[int], kv_lens: Sequence[int], heads: int, head_dim: int,
                   radius: int, elem_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one biased flash-attention forward over items
    with ``q_lens[i]`` queries and ``kv_lens[i]`` keys: ``work.k1_work``
    and one multiply-add a (query, key, head) for the bias; the bytes of
    ``work.k1_work``, the f32 gate of every query row and head, and the
    (heads, 2 radius + 1) f32 table once."""
    flops, nbytes = work.k1_work(q_lens, kv_lens, heads, head_dim, elem_bytes)
    pairs = sum(q * kv for q, kv in zip(q_lens, kv_lens))
    flops += 2.0 * heads * pairs
    nbytes += 4.0 * heads * sum(q_lens) + 4.0 * heads * (2 * radius + 1)
    return flops, nbytes


def faceformer_wavlm_flops(n_samples: int, cfg: dict) -> float:
    """Operations of FaceFormer (vocaset) with WavLM on one valid clip of
    ``n_samples`` at 16 kHz: ``work.faceformer_flops`` with the WavLM
    encoder's widths, and each layer's gate and gated bias."""
    enc = cfg["wavlm"]
    t = work.frame_count(n_samples, cfg["fps"], cfg["sample_rate"])
    flops = work.faceformer_flops(n_samples, {**cfg, "wav2vec2": enc})
    per_layer = 2.0 * t * enc["hidden_size"] * 2 + 2.0 * enc["num_attention_heads"] * t * t
    return flops + enc["num_hidden_layers"] * per_layer

"""The work each kernel and each model needs, counted from the clips' valid
lengths, and the H100's published peaks that turn work into a time bound.

Counting rules (the same for every implementation of the work):

- operations: the multiply-adds the algorithm needs for the valid frames,
  two operations each; a clip's attention covers its valid queries against
  its valid keys, and the decoder one step a valid frame;
- bytes: each input byte read once and each output byte written once.

Nothing here reads the program's padded shapes, so a change to bucketing,
batching or a kernel leaves the counts as they are; padding shows as a
lower share of the bound.
"""

from __future__ import annotations

import math
from typing import Sequence

# published dense peaks of one H100 SXM (NVIDIA data sheet, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time the chip can take: the larger of bytes over the HBM
    bandwidth and operations over the peak."""
    return max(nbytes / PEAK_HBM_BYTES, flops / peak_flops)


# ---------------------------------------------------------------- K1 ----

def k1_work(q_lens: Sequence[int], kv_lens: Sequence[int], heads: int = 12,
            head_dim: int = 64, elem_bytes: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one flash-attention forward over items with
    ``q_lens[i]`` queries and ``kv_lens[i]`` keys: QK^T and PV, 4 h d per
    (query, key) pair; q read and out written, k and v read, one f32
    log-sum-exp a query row and one int32 length an item."""
    pairs = sum(q * kv for q, kv in zip(q_lens, kv_lens))
    flops = 4.0 * heads * head_dim * pairs
    nbytes = (2.0 * heads * head_dim * elem_bytes * (sum(q_lens) + sum(kv_lens))
              + 4.0 * heads * sum(q_lens) + 4.0 * len(q_lens))
    return flops, nbytes


# ---------------------------------------------------------------- K3 ----

D = 64
# per step: qkv (64x192), out (64x64), FFN (64x128, 128x64), feedback (64x64)
K3_DENSE_FLOPS = 2.0 * (D * 3 * D + D * D + D * 2 * D + 2 * D * D + D * D)
# the decoder's weights: five 64x64 products, the two FFN matrices and
# their biases in the compute type (bf16), and three layer norms in f32
K3_WEIGHT_BYTES = 2 * (5 * D * D + 2 * D * 2 * D + 5 * D + 2 * D + D) + 4 * 6 * D


def k3_work(frames: Sequence[int], period: int = 60, elem_bytes: int = 2
            ) -> tuple[float, float]:
    """(operations, bytes) of FaceFormer's decode loop over items of
    ``frames[i]`` valid frames: per step the dense products and the
    attention over the t + 1 cached keys (4 heads x 16 lanes, QK and PV);
    the cross term read and the hidden states written, a style row an item,
    the positional table and the weights once."""
    flops = sum(t * K3_DENSE_FLOPS + 4.0 * D * t * (t + 1) / 2 for t in frames)
    nbytes = (elem_bytes * (2 * D * sum(frames) + D * len(frames) + period * D)
              + K3_WEIGHT_BYTES)
    return flops, nbytes


# ----------------------------------------------------- wav2vec2-base ----

def conv_stack_lengths(n_samples: int, kernels: Sequence[int], strides: Sequence[int]) -> list:
    lengths, n = [], n_samples
    for k, s in zip(kernels, strides):
        n = (n - k) // s + 1
        lengths.append(n)
    return lengths


def wav2vec2_flops(n_samples: int, n_frames: int, w2v: dict) -> float:
    """Operations of the wav2vec2-base encoder on one clip: the conv
    stack on its samples, then the projection, the positional conv and the
    layers on its ``n_frames`` frames (FaceFormer's 60 fps adapter)."""
    dims = w2v["conv_dim"]
    lengths = conv_stack_lengths(n_samples, w2v["conv_kernel"], w2v["conv_stride"])
    c_in, flops = 1, 0.0
    for length, k, c_out in zip(lengths, w2v["conv_kernel"], dims):
        flops += 2.0 * length * k * c_in * c_out
        c_in = c_out
    h, f, t = w2v["hidden_size"], w2v["intermediate_size"], n_frames
    flops += 2.0 * t * dims[-1] * h
    flops += 2.0 * t * h * (h // w2v["num_conv_pos_embedding_groups"]) * w2v["num_conv_pos_embeddings"]
    per_layer = 2.0 * t * h * h * 4 + 2.0 * t * h * f * 2 + 4.0 * t * t * h
    return flops + w2v["num_hidden_layers"] * per_layer


def faceformer_flops(n_samples: int, cfg: dict) -> float:
    """Operations of FaceFormer (vocaset) on one valid clip of ``n_samples``
    at 16 kHz: the encoder, the audio map and cross term, the decode loop
    and the vertex head."""
    t = frame_count(n_samples, cfg["fps"], cfg["sample_rate"])
    d, v = cfg["feature_dim"], cfg["vertice_dim"]
    flops = wav2vec2_flops(n_samples, t, cfg["wav2vec2"])
    flops += 2.0 * t * cfg["wav2vec2"]["hidden_size"] * d + 2.0 * t * d * d * 2
    flops += k3_work([t], cfg["period"])[0]
    return flops + 2.0 * t * d * v


def frame_count(n_samples: int, fps: int, sample_rate: int) -> int:
    """Frames of a clip: samples * fps // sample_rate."""
    return n_samples * fps // sample_rate


# ------------------------------------------------- Audio2Mesh on MFCC ----

def mfcc_flops(cfg: dict) -> float:
    """Operations of one window's MFCC: the windowed real FFTs (2.5 N log2 N
    each), the power, the mel filterbank and the DCT."""
    n_fft, hop = cfg["n_fft"], cfg["hop_length"]
    window = 2 * int(cfg["sample_rate"] * cfg["window_seconds"] / 2)
    frames = 1 + window // hop
    bins = n_fft // 2 + 1
    fft = 2.5 * n_fft * math.log2(n_fft) + n_fft
    return frames * (fft + 3.0 * bins + 2.0 * bins * cfg["n_mels"]
                     + 2.0 * cfg["n_mels"] * cfg["n_feature"])


def audio2mesh_frame_flops(cfg: dict) -> float:
    """Operations of Audio2Mesh on one frame's feature image: the five
    analysis convs, the five articulation convs and the vertex MLP."""
    h, w = cfg["out_dim"] + cfg["n_styles"], cfg["n_feature"]
    c_in, flops = 1, 0.0
    for c_out in cfg["analysis_channels"]:
        w = (w + 2 - 3) // 2 + 1
        flops += 2.0 * c_out * c_in * 3 * h * w
        c_in = c_out
    for k, s, p in cfg["articulation"]:
        h = (h + 2 * p - k) // s + 1
        flops += 2.0 * 256 * c_in * k * h * w
        c_in = 256
    dims = [c_in + cfg["n_styles"]] + list(cfg["mlp"]) + [cfg["vertice_dim"]]
    return flops + sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))


def audio2mesh_flops(n_samples: int, cfg: dict) -> float:
    """Operations of the frame request on one valid clip: per frame its
    window's MFCC and the model."""
    t = frame_count(n_samples, cfg["fps"], cfg["sample_rate"])
    return t * (mfcc_flops(cfg) + audio2mesh_frame_flops(cfg))


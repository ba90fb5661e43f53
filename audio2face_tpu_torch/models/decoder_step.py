"""The FaceFormer per-frame decoder step, shared by every KV-cached live
serving path.

Port of ``audio2face_tpu/models/decoder_step.py``. ``streaming.py`` (one
live stream) and ``multistream.py`` (a pooled slot batch) both step this
function over a chunk's frames, so the decode math (pre-composed feedback
projection, q/k/v against the growing cache, period-bucketed ALiBi
attention, the three layer norms and the ReLU FFN) lives in one place.

Semantics: the KV-cached equivalent of the attention the reference's
per-frame recompute loop performs for its newest position
(src/model/faceformer.py:154-185). The step runs in f32 whatever the
encoder's dtype, as in JAX; its attention is
``ops/attention.py decode_step_attention`` (plain torch operations: the
JAX package runs it as XLA einsums, not as a kernel). A chunk is a Python
loop of steps, ~30 small launches each.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from audio2face_tpu_torch.models.faceformer import FEATURE_DIM, N_HEADS, PERIOD
from audio2face_tpu_torch.ops.attention import decode_step_attention


def decoder_step_params(model) -> dict:
    """The step's weights from a vocaset ``FaceFormer``, under the JAX
    serving tree's flat names: kernels in (in, out) order, f32, plus the
    periodic positional encoding table ``ppe`` (period, d). The live paths
    decode at width 64 only: another width raises."""
    check_live_width(model.feature_dim)
    p = {}
    for name in ("dec_q", "dec_k", "dec_v", "dec_out", "linear1", "linear2",
                 "vertice_map", "vertice_map_r"):
        layer = getattr(model, name)
        p[f"{name}_kernel"] = layer.weight.detach().float().T
        p[f"{name}_bias"] = layer.bias.detach().float()
    for name in ("norm1", "norm2", "norm3"):
        norm = getattr(model, name)
        p[f"{name}_scale"] = norm.weight.detach().float()
        p[f"{name}_bias"] = norm.bias.detach().float()
    p["ppe"] = model.ppe.float()
    return p


def check_live_width(width: int) -> None:
    """The live paths (this step, ``streaming.py``, ``multistream.py``)
    decode at the width ``FEATURE_DIM`` (64) alone; another raises."""
    if width != FEATURE_DIM:
        raise ValueError(
            f"the live decoder runs width {FEATURE_DIM}; these weights are {width} wide "
            "(serve them with FaceFormerPredictor)")


def make_decoder_step(
    p: dict,
    *,
    styles: torch.Tensor,
    t0: torch.Tensor,
    n_valid: Optional[torch.Tensor] = None,
    t_scratch: Optional[int] = None,
):
    """The step advancing a batch of S decoder states by one frame each.

    carry: ``(emb (S, d), k_cache (S, H, Tmax, hd), v_cache (S, H, Tmax,
    hd))``; the caches are written in place. xt: ``(i, cross_t)``, the local
    frame index (an int) and the (S, d) cross-attention output for frame i.
    styles: (S, d) per-stream style embeddings added into the feedback.
    t0: (S,) int64 absolute start frames (stream j decodes frame t0[j] + i).
    n_valid: optional (S,) valid frame counts: streams with i >= n_valid
    write their k/v into cache row ``t_scratch`` (past every active
    position, so the causal mask never admits it) and keep their carried
    embedding, so an idle slot equals one that never stepped.

    Returns ``step(carry, xt) -> (carry, h)`` with h (S, d) the hidden state
    before the vertex head."""
    if n_valid is not None and t_scratch is None:
        # a defaulted scratch row of 0 would be a valid cache position that
        # the causal mask attends at every later step
        raise ValueError("n_valid requires t_scratch (a cache row beyond "
                         "every active position, e.g. the cache length - 1)")
    d = FEATURE_DIM
    hd = d // N_HEADS
    pe = p["ppe"]
    # the reference chains two linears for the feedback; composing them is
    # exact (both are affine) and saves a (V)-wide product per step
    fb_k = p["vertice_map_r_kernel"] @ p["vertice_map_kernel"]
    fb_b = p["vertice_map_r_bias"] @ p["vertice_map_kernel"] + p["vertice_map_bias"]
    qkv_k = torch.cat([p["dec_q_kernel"], p["dec_k_kernel"], p["dec_v_kernel"]], dim=1)
    qkv_b = torch.cat([p["dec_q_bias"], p["dec_k_bias"], p["dec_v_bias"]])
    rows = torch.arange(styles.shape[0], device=styles.device)

    def layer_norm(x, name):
        return F.layer_norm(x, (d,), p[f"{name}_scale"], p[f"{name}_bias"], 1e-5)

    def step(carry, xt):
        emb, kc, vc = carry
        i, cross_t = xt
        s = emb.shape[0]
        t = t0 + i  # (S,) absolute frame of each stream
        x = emb + pe[t % PERIOD]
        q, k, v = torch.addmm(qkv_b, x, qkv_k).reshape(s, 3, N_HEADS, hd).unbind(1)
        if n_valid is None:
            t_write, active = t, None
        else:
            active = n_valid > i
            t_write = torch.where(active, t, t_scratch)
        kc[rows, :, t_write] = k
        vc[rows, :, t_write] = v
        attn = decode_step_attention(q, kc, vc, t, alibi_period=PERIOD)
        sa = torch.addmm(p["dec_out_bias"], attn.reshape(s, d), p["dec_out_kernel"])
        h = layer_norm(x + sa, "norm1")
        h = layer_norm(h + cross_t, "norm2")
        ff = torch.relu(torch.addmm(p["linear1_bias"], h, p["linear1_kernel"]))
        ff = torch.addmm(p["linear2_bias"], ff, p["linear2_kernel"])
        h = layer_norm(h + ff, "norm3")
        emb_next = torch.addmm(fb_b, h, fb_k) + styles
        if active is not None:
            emb_next = torch.where(active[:, None], emb_next, emb)
        return (emb_next, kc, vc), h

    return step


def run_decoder_steps(step, carry, cross: torch.Tensor):
    """Apply ``step`` to the frames of ``cross`` (S, F, d) in order: the
    port's counterpart of JAX's ``lax.scan``. Returns the final carry and the
    hidden states (S, F, d)."""
    hs = []
    for i in range(cross.shape[1]):
        carry, h = step(carry, (i, cross[:, i]))
        hs.append(h)
    return carry, torch.stack(hs, dim=1)

"""FaceFormer: wav2vec2 encoder + autoregressive mesh decoder.

Port of ``audio2face_tpu/models/faceformer.py``. The decoder is the single
sequential KV-cached pass that equals the reference's per-frame re-decoding
loop:

- vocaset: the diagonal-only cross attention reduces exactly to
  ``out_proj(v_proj(memory[t]))``, hoisted out of the loop as one product;
- ``dataset="biwi"``: frames run at 25 fps against the untouched 50 fps
  latents, and mesh frame t cross-attends the latents {2t, 2t+1} with a true
  2-way softmax; ``cross_q``/``cross_k`` are live parameters that exist only
  in this mode, and the key/value projections of all latents are computed
  once before the loop;
- the per-step feedback ``vertice_map(vertice_map_r(h_t)) + style`` runs
  through the composed 64x64 matrix ``W_r W_m``; vertices come after the
  loop from one (B*T, 64) @ (64, 3V) product;
- the periodic positional encoding is a (period, 64) table indexed mod
  period; the ALiBi bias is computed from indices.

Padded batches carry ``lengths`` (samples) and return a frame mask. In
inference on CUDA the decode loop is one launch of the decode kernel
(``select_decode_impl``), whatever the autograd state: the kernel has no
backward and raises when a gradient is asked of it. Gradients come only on
request: ``train=True`` or ``differentiable=True`` decode with the
differentiable step loop ``decode_kernel.decode_steps``. With
``train=True`` the loop applies the five dropout keep-masks of the reference
decoder layer (p = 0.1), drawn once for all frames before the loop, and
checkpoints the loop at chunk granularity over frames, so that the per-step
residuals live only inside one chunk's recomputed backward.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder, _lecun_normal_
from audio2face_tpu_torch.ops import decode_kernel
from audio2face_tpu_torch.ops.dsp import wav2vec2_zero_mean_unit_var

FEATURE_DIM = 64
N_HEADS = 4
PERIOD = 60
FPS = 60
AUDIO_SR = 16000
DECODER_DROPOUT = 0.1
MAX_DECODE_CHUNK = 64


def periodic_positional_encoding(period: int = PERIOD, d_model: int = FEATURE_DIM) -> np.ndarray:
    """The (period, d_model) sinusoid table of the reference PPE; position t
    uses row t % period."""
    position = np.arange(period, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))
    pe = np.zeros((period, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def normalize_waveform(audio: torch.Tensor, lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Wav2Vec2Processor zero-mean/unit-var normalization, masked to each
    item's valid prefix for padded batches."""
    if lengths is None:
        return wav2vec2_zero_mean_unit_var(audio)
    n_samples = audio.shape[1]
    lengths = lengths.to(audio.device)
    valid = (torch.arange(n_samples, device=audio.device)[None, :] < lengths[:, None]).float()
    n = lengths.float().clamp(min=1.0)[:, None]
    mean = (audio * valid).sum(dim=1, keepdim=True) / n
    var = ((audio - mean).square() * valid).sum(dim=1, keepdim=True) / n
    return (audio - mean) / torch.sqrt(var + 1e-7) * valid


def frame_count(n_samples, fps: int = FPS):
    """frame_num = samples * fps // 16000, for python ints or integer
    tensors, evaluated as ``q*fps + r*fps//SR`` (n = q*SR + r) so int32
    sample counts cannot overflow."""
    q, r = n_samples // AUDIO_SR, n_samples % AUDIO_SR
    return q * fps + r * fps // AUDIO_SR


def select_decode_impl(
    device: torch.device, dataset: str = "vocaset", *, train: bool = False
) -> str:
    """The decode implementation for ``device``: ``"fused"`` (the decode
    kernel) for inference on CUDA, ``"loop"`` (its plain Python loop)
    elsewhere, ``"steps"`` (the differentiable step loop) for training on any
    device: the kernel is inference only.

    The kernel keeps its KV cache in device memory, so its only capacity
    limit is shared memory for the weights (more of them in its BIWI
    variant): on a card where those do not fit this raises (there is no
    fallback)."""
    if dataset not in ("vocaset", "biwi"):
        raise ValueError(f"unknown dataset {dataset!r}; available: vocaset, biwi")
    if train:
        return "steps"
    device = torch.device(device)
    if device.type != "cuda":
        return "loop"
    biwi = dataset == "biwi"
    if not decode_kernel.smem_fits(device, biwi):
        raise RuntimeError(
            f"the decode kernel needs {decode_kernel.smem_bytes(biwi)} bytes of shared "
            f"memory per block, more than {torch.cuda.get_device_name(device)} offers"
        )
    return "fused"


def decode_chunk_size(n_frames: int) -> int:
    """Frames per checkpointed chunk: the largest divisor of ``n_frames``
    that is at most ``MAX_DECODE_CHUNK``."""
    c = min(MAX_DECODE_CHUNK, n_frames)
    while c > 1 and n_frames % c:
        c -= 1
    return max(c, 1)


def decoder_keep_masks(
    n_frames: int, bsz: int, dtype: torch.dtype, generator: torch.Generator, device,
    rate: float = DECODER_DROPOUT, batch_rows=None,
) -> dict:
    """The five dropout keep-multipliers (0 or 1/(1-rate)) of the decoder
    layer, for all frames at once: after the positional encoding (``m_pe``),
    the self-attention (``m_sa``), the cross term (``m_ca``), inside the FFN
    (``m_ff1``, 128 wide) and after it (``m_ff2``). Each is (T, B, width).
    ``batch_rows=(offset, total)``: the batch is those rows of a batch of
    ``total``, and each mask that slice of the whole batch's."""
    d = FEATURE_DIM
    b0, total = (0, bsz) if batch_rows is None else batch_rows

    def keep(width):
        m = torch.rand((n_frames, total, width), generator=generator, device=device) < (1.0 - rate)
        return (m[:, b0 : b0 + bsz].float() / (1.0 - rate)).to(dtype)

    return {"m_pe": keep(d), "m_sa": keep(d), "m_ca": keep(d), "m_ff1": keep(2 * d), "m_ff2": keep(d)}


class FaceFormer(nn.Module):
    """FaceFormer; parameter names follow the JAX module.

    ``remat_scan=False`` turns the chunk checkpointing of the training
    decode loop off (every step's residuals are kept; only viable for small
    B*T^2). ``period`` is the PPE / ALiBi bucket period (the reference
    hardcodes 60; the upstream FaceFormer uses 25 for BIWI)."""

    def __init__(
        self,
        n_verts: int,
        n_onehot: int,
        dtype: Optional[torch.dtype] = None,
        dataset: str = "vocaset",
        encoder_config: Wav2Vec2Config = Wav2Vec2Config(),
        remat_scan: Optional[bool] = None,
        period: int = PERIOD,
    ):
        super().__init__()
        if dataset not in ("vocaset", "biwi"):
            raise ValueError(f"unknown dataset {dataset!r}; available: vocaset, biwi")
        d = FEATURE_DIM
        self.n_verts = n_verts
        self.n_onehot = n_onehot
        self.dtype = dtype
        self.dataset = dataset
        self.period = period
        self.fps = 25 if dataset == "biwi" else FPS
        self.remat_scan = remat_scan
        self.audio_encoder = Wav2Vec2Encoder(encoder_config)
        self.audio_feature_map = nn.Linear(encoder_config.hidden_size, d)
        self.obj_vector = nn.Linear(n_onehot, d, bias=False)
        self.vertice_map = nn.Linear(n_verts, d)
        self.vertice_map_r = nn.Linear(d, n_verts)
        self.dec_q = nn.Linear(d, d)
        self.dec_k = nn.Linear(d, d)
        self.dec_v = nn.Linear(d, d)
        self.dec_out = nn.Linear(d, d)
        self.cross_v = nn.Linear(d, d)
        self.cross_out = nn.Linear(d, d)
        if dataset == "biwi":
            # the vocaset diagonal makes these mathematically inert, so
            # vocaset checkpoints omit them
            self.cross_q = nn.Linear(d, d)
            self.cross_k = nn.Linear(d, d)
        self.linear1 = nn.Linear(d, 2 * d)
        self.linear2 = nn.Linear(2 * d, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)
        self.register_buffer(
            "ppe", torch.from_numpy(periodic_positional_encoding(period)), persistent=False
        )

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` in the JAX module's scheme: LeCun
        normal kernels, zero biases, unit norms; the motion maps
        ``vertice_map``/``vertice_map_r`` start at zero."""
        self.audio_encoder.init_parameters(generator)
        for name, m in self.named_children():
            if isinstance(m, nn.Linear):
                if name in ("vertice_map", "vertice_map_r"):
                    m.weight.zero_()
                else:
                    _lecun_normal_(m.weight, m.in_features, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(
        self,
        audio: torch.Tensor,  # (B, S) float waveform @ 16 kHz
        one_hot: torch.Tensor,  # (B, n_onehot)
        template: torch.Tensor,  # (B, V, 3)
        lengths: Optional[torch.Tensor] = None,  # (B,) valid sample counts
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_hidden: bool = False,
        use_kernels: bool = True,
        encoder_hidden: Optional[torch.Tensor] = None,
        differentiable: bool = False,
        batch_rows=None,
    ):
        """Returns (B, T, V, 3) vertices with T = frame_count(S, fps) (60 fps;
        BIWI 25), plus a (B, T) frame validity mask when ``lengths`` is given.

        ``train=True`` turns on every regularizer (encoder dropouts,
        SpecAugment, LayerDrop, attention dropout, the decoder's five
        keep-masks), all drawn from ``generator`` (required, on the input's
        device), and decodes with the chunk-checkpointed step loop.
        ``return_hidden=True`` returns the decoder hidden states (B, T, 64)
        instead of vertices (serving applies the vertex head per time chunk;
        training runs it inside the chunked loss). ``encoder_hidden`` takes
        externally computed encoder states (B, T, 768) in place of running
        the encoder. ``use_kernels=False`` runs the plain versions of every
        kernel. ``differentiable=True`` asks for gradients in eval mode: the
        decode is the step loop without masks and the conv stack runs its
        ``conv1d`` path, in place of the two inference-only kernels (which
        raise on CUDA when a gradient is asked of them). ``batch_rows=(offset,
        total)``: the batch is those rows of a batch of ``total`` (a
        data-parallel rank's share), and every random draw is this share of
        the whole batch's."""
        cdt = self.dtype or torch.float32
        biwi = self.dataset == "biwi"
        bsz, n_samples = audio.shape
        n_frames = frame_count(n_samples, self.fps)
        frame_lengths = (
            None if lengths is None else frame_count(lengths.to(audio.device), self.fps))
        if train and generator is None:
            raise ValueError("train=True needs an explicit torch.Generator")

        if encoder_hidden is not None:
            hidden = encoder_hidden
        else:
            hidden = self.audio_encoder(
                normalize_waveform(audio, lengths), output_len=n_frames, lengths=lengths,
                output_lengths=None if biwi else frame_lengths, dataset=self.dataset,
                dtype=cdt, use_kernels=use_kernels,
                train=train, apply_spec_augment=train, generator=generator,
                differentiable=differentiable, batch_rows=batch_rows,
            )  # (B, T, 768); biwi: (B, <= 2T, 768), the 50 fps latents untouched
        if biwi and hidden.shape[1] != 2 * n_frames:
            # the 2-way alignment needs exactly 2 latents per frame: a short
            # encode is zero-padded at the end, a long one trimmed
            pad = max(2 * n_frames - hidden.shape[1], 0)
            hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))[:, : 2 * n_frames]

        def mm(x, layer):  # f32 products, as JAX promotes bf16 x f32 params
            return torch.nn.functional.linear(x.float(), layer.weight, layer.bias)

        memory = mm(hidden, self.audio_feature_map)  # (B, T, 64); biwi: (B, 2T, 64)
        mem = {}
        if biwi:
            # cross keys and values of every latent, (B, H, 2T, hd); each
            # step attends rows {2t, 2t+1}
            def heads(x):
                return x.reshape(bsz, -1, N_HEADS, FEATURE_DIM // N_HEADS).transpose(1, 2).to(cdt)

            cross = None
            mem = dict(mem_k=heads(mm(memory, self.cross_k)), mem_v=heads(mm(memory, self.cross_v)))
        else:
            cross = mm(mm(memory, self.cross_v), self.cross_out).to(cdt)
        style = mm(one_hot, self.obj_vector).to(cdt)  # (B, 64)
        pe = self.ppe.to(device=audio.device, dtype=cdt)
        weights = self.decoder_weights(cdt)
        impl = "loop"
        if train or differentiable or use_kernels:
            impl = select_decode_impl(audio.device, self.dataset, train=train or differentiable)
        if impl == "steps":
            masks = (decoder_keep_masks(n_frames, bsz, cdt, generator, audio.device,
                                        batch_rows=batch_rows) if train else None)
            chunk = decode_chunk_size(n_frames) if train and self.remat_scan is not False else None
            hs = decode_kernel.decode_steps(
                cross, style, pe, weights, period=self.period, masks=masks, chunk=chunk, **mem)
        elif impl == "fused":
            hs = decode_kernel.faceformer_decode_loop(
                cross, style, pe, weights, period=self.period, **mem)
        else:
            hs = decode_kernel.decode_loop_reference(
                cross, style, pe, weights, period=self.period, **mem)

        frame_mask = None
        if lengths is not None:
            frame_mask = (
                torch.arange(n_frames, device=audio.device)[None, :] < frame_lengths[:, None]
            ).float()
        out = hs if return_hidden else self.vertex_head(hs, template)
        return out if frame_mask is None else (out, frame_mask)

    def decoder_weights(self, dtype: torch.dtype) -> dict:
        """The decode loop's weights under the JAX kernel's keys, kernels in
        (in, out) order, cast to ``dtype`` as the JAX module casts them. The
        feedback is the composed 64x64 ``vertice_map(vertice_map_r(h)) =
        h @ fb_kernel + fb_bias``, computed in f32."""
        wr, wm = self.vertice_map_r.weight.T, self.vertice_map.weight.T  # (64, V), (V, 64)
        w = {"fb_kernel": wr @ wm, "fb_bias": self.vertice_map_r.bias @ wm + self.vertice_map.bias}
        layers = [("q", self.dec_q), ("k", self.dec_k), ("v", self.dec_v),
                  ("o", self.dec_out), ("f1", self.linear1), ("f2", self.linear2)]
        if self.dataset == "biwi":
            layers += [("cq", self.cross_q), ("co", self.cross_out)]
        for key, layer in layers:
            w[f"{key}_kernel"] = layer.weight.T
            w[f"{key}_bias"] = layer.bias
        w = {k: v.to(dtype) for k, v in w.items()}
        for i, norm in enumerate((self.norm1, self.norm2, self.norm3), start=1):
            w[f"ln{i}_scale"] = norm.weight
            w[f"ln{i}_bias"] = norm.bias
        return w

    def vertex_head(self, hs: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
        """(B, T, 64) hidden states -> (B, T, V, 3) f32 vertices: one
        (B*T, 64) @ (64, 3V) product plus the template."""
        bsz, n_frames, d = hs.shape
        verts = torch.nn.functional.linear(
            hs.reshape(-1, d).float(), self.vertice_map_r.weight, self.vertice_map_r.bias
        ).reshape(bsz, n_frames, -1)
        verts = verts + template.reshape(bsz, 1, -1).float()
        return verts.reshape(bsz, n_frames, -1, 3)

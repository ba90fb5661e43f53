"""Pipeline parallelism: the wav2vec2 transformer stack split into stages
over the mesh, microbatches streamed GPipe-style between them.

Port of ``audio2face_tpu/parallel/pipeline.py``:

- the layers are split into ``n_stages`` contiguous stages
  (``stack_stage_params``), one per rank along the chosen mesh axis; each
  rank runs only its own stage's layers;
- the batch is cut into ``n_micro`` microbatches, and the GPipe schedule
  runs ``n_micro + n_stages - 1`` ticks: each tick every stage applies its
  layers to its buffer (stage 0 takes in the next microbatch; the last
  stage writes the finished one), then the buffers move one stage on
  around the ring (``comm.ring_shift``); a stage in the warm-up or drain
  bubble passes its buffer on without computing;
- attention runs per microbatch over its full T, so each item's valid
  length (indexed on every rank, nothing to ship) masks as in the
  unsharded encoder;
- the last stage's outputs reach every rank by one sum over the stage
  group; with ``data_axis`` the microbatches are also sharded over that
  axis (DP x PP on a 2-D mesh) and the result gathered.

Differentiable: the ring shift's backward shifts the other way, so a
backward through ``pipeline_parallel_layers`` runs the ring in reverse and
gives each stage its layers' gradients. Every rank must then run every
tick's backward shift in the same order: each shift's output feeds the
next tick on every stage (stage 0 adds its received buffer times zero to
the microbatch it takes in, the last tick's buffer enters the result times
zero), so the backward chain is the same on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from audio2face_tpu_torch.parallel import comm
from audio2face_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size


def stack_stage_params(params: Wav2Vec2Encoder, n_stages: int, config: Wav2Vec2Config) -> list:
    """The encoder's layers in ``n_stages`` contiguous stages, each an
    ``nn.ModuleList`` of ``num_layers / n_stages`` layers (stage k is what
    rank k of the pipeline axis runs)."""
    n_layers = config.num_layers
    if n_layers % n_stages != 0:
        raise ValueError(f"num_layers={n_layers} must divide evenly into {n_stages} stages")
    per = n_layers // n_stages
    layers = list(params.layers[:n_layers])
    return [nn.ModuleList(layers[k * per : (k + 1) * per]) for k in range(n_stages)]


def pipeline_parallel_layers(
    params: Wav2Vec2Encoder,
    h: torch.Tensor,
    mesh,
    *,
    n_micro: Optional[int] = None,
    feat_lengths: Optional[torch.Tensor] = None,
    config: Wav2Vec2Config = Wav2Vec2Config(),
    dtype: torch.dtype = torch.float32,
    use_kernels: bool = True,
    axis: str = MODEL_AXIS,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run the transformer stack pipeline-parallel over ``mesh``'s ``axis``.

    params: the encoder (only its ``layers`` are run, each rank its own
    stage's). h: (B, T, D) hidden states at the ``pre_layers_only`` split
    point, the same on every rank. n_micro: the microbatch count (must
    divide B; default B, microbatches of one). feat_lengths: optional (B,)
    valid token counts. data_axis: also shard each microbatch over this
    mesh axis (B / n_micro must divide by its size). Returns (B, T, D) on
    every rank. The gradient with respect to ``h`` lands on stage 0."""
    group = mesh.get_group(axis)
    n_stages, s = axis_size(mesh, axis), mesh.get_local_rank(axis)
    b, t, d = h.shape
    if n_micro is None:
        n_micro = b
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    mb = b // n_micro
    if data_axis is not None and mb % axis_size(mesh, data_axis) != 0:
        raise ValueError(
            f"microbatch size {mb} not divisible by mesh axis "
            f"{data_axis!r}={axis_size(mesh, data_axis)}")

    stage = stack_stage_params(params, n_stages, config)[s]
    x = h.reshape(n_micro, mb, t, d)
    if feat_lengths is None:
        kvlen = torch.full((n_micro, mb), t, dtype=torch.int32, device=h.device)
    else:
        kvlen = feat_lengths.to(device=h.device, dtype=torch.int32).reshape(n_micro, mb)
    if data_axis is not None:
        c = mb // axis_size(mesh, data_axis)
        lo = mesh.get_local_rank(data_axis) * c
        x, kvlen = x[:, lo : lo + c], kvlen[:, lo : lo + c]

    last = n_stages - 1
    needs_grad = torch.is_grad_enabled() and (
        h.requires_grad or any(p.requires_grad for p in stage.parameters()))
    buf = torch.zeros_like(x[0]).requires_grad_(needs_grad)
    outs = []
    for i in range(n_micro + n_stages - 1):
        if s == 0 and i < n_micro:
            buf = x[i] + 0 * buf  # take in microbatch i (the buffer stays in the graph)
        j = i - s  # the microbatch at this stage on this tick
        y = buf
        if 0 <= j < n_micro:
            for layer in stage:
                y = layer(y, kv_lengths=kvlen[j], dtype=dtype, use_kernels=use_kernels)
        if s == last and j >= 0:
            outs.append(y)
        buf = comm.ring_shift(y, group)
    out = torch.stack(outs) if s == last else torch.zeros_like(x)
    out = comm.reduce_from_group(out + 0 * buf.sum(), group)
    if data_axis is not None:
        out = comm.gather_along(out, 1, mesh.get_group(data_axis), reduce_grad=False)
    return out.reshape(b, t, d)


def pipeline_parallel_encode(
    variables: Wav2Vec2Encoder,
    input_values: torch.Tensor,
    mesh,
    *,
    n_micro: Optional[int] = None,
    output_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
    output_lengths: Optional[torch.Tensor] = None,
    config: Wav2Vec2Config = Wav2Vec2Config(),
    dtype: torch.dtype = torch.float32,
    use_kernels: bool = True,
    axis: str = MODEL_AXIS,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Full waveform -> hidden states with the transformer stack
    pipeline-parallel: a drop-in for ``Wav2Vec2Encoder.forward`` at
    inference (the same encoder, the same output)."""
    h, feat_lengths = variables(
        input_values, output_len, lengths, output_lengths, dtype=dtype,
        use_kernels=use_kernels, pre_layers_only=True,
    )
    return pipeline_parallel_layers(
        variables, h, mesh, n_micro=n_micro, feat_lengths=feat_lengths, config=config,
        dtype=dtype, use_kernels=use_kernels, axis=axis, data_axis=data_axis,
    )

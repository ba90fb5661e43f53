"""Sequence (context) parallelism: one long clip across the mesh.

Port of ``audio2face_tpu/parallel/sequence.py``. Data parallelism shards
independent clips; this shards the time axis of one wav2vec2 forward over
the mesh's ``data`` axis, for long-form audio, where the encoder's
self-attention grows as T^2.

Split point: everything up to the transformer stack (conv feature encoder,
fps interpolation, feature projection, positional conv, layer norm) is
O(T) and runs unsharded on every rank (``Wav2Vec2Encoder(pre_layers_only=
True)``). The layers then run on each rank's T/n rows: projections, FFN
and layer norms are token-local, and attention all-gathers K and V per
layer (``EncoderLayer(time_group=)``), so the flash-attention kernel takes
T/n local queries against all T keys.

T is padded up to a multiple of n; the padded tail is masked out of
attention through ``kv_lengths`` (global counts) and sliced off, so the
result equals the unsharded encoder's to float round-off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from audio2face_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from audio2face_tpu_torch.parallel import comm
from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from audio2face_tpu_torch.utils.shapes import round_up as _round_up


def sequence_parallel_layers(
    params: Wav2Vec2Encoder,
    h: torch.Tensor,
    mesh,
    *,
    feat_lengths: Optional[torch.Tensor] = None,
    config: Wav2Vec2Config = Wav2Vec2Config(),
    dtype: torch.dtype = torch.float32,
    use_kernels: bool = True,
    axis: str = DATA_AXIS,
    gather_output: bool = False,
) -> torch.Tensor:
    """Run the transformer stack time-sharded over ``mesh``'s ``axis``.

    params: the encoder (only its ``layers`` are run). h: (B, T, D) hidden
    states at the ``pre_layers_only`` split point, the same on every rank.
    feat_lengths: optional (B,) valid token counts for padded batches.

    Returns this rank's rows of the (B, T, D) result: rows ``r * T_pad / n``
    up to the next rank's first, of which those below T (the rank's share
    of the time-sharded array the JAX function returns). With
    ``gather_output`` the shares are all-gathered inside the call and every
    rank returns the whole (B, T, D): what a replicated consumer (the
    decoder and its kernel in serving) needs."""
    group = mesh.get_group(axis)
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    b, t, _ = h.shape
    t_pad = _round_up(t, n)
    if feat_lengths is None:
        kvlen = torch.full((b,), t, dtype=torch.int32, device=h.device)
    else:
        kvlen = feat_lengths.to(device=h.device, dtype=torch.int32)
    if t_pad != t:
        h = F.pad(h, (0, 0, 0, t_pad - t))
    c = t_pad // n
    x = h[:, r * c : (r + 1) * c]
    for layer in params.layers[: config.num_layers]:
        x = layer(x, kv_lengths=kvlen, dtype=dtype, use_kernels=use_kernels, time_group=group)
    if gather_output:
        return comm.gather_along(x, 1, group, reduce_grad=False)[:, :t]
    return x[:, : max(0, min(c, t - r * c))]


def sequence_parallel_encode(
    variables: Wav2Vec2Encoder,
    input_values: torch.Tensor,
    mesh,
    *,
    output_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
    output_lengths: Optional[torch.Tensor] = None,
    config: Wav2Vec2Config = Wav2Vec2Config(),
    dtype: torch.dtype = torch.float32,
    use_kernels: bool = True,
    axis: str = DATA_AXIS,
    gather_output: bool = False,
    dataset: str = "vocaset",
) -> torch.Tensor:
    """Full waveform -> hidden states with the transformer stack sharded on
    time: a drop-in for ``Wav2Vec2Encoder.forward`` at inference (the same
    encoder, the same output, rows as in ``sequence_parallel_layers``).
    ``dataset`` picks the pre-layers alignment (vocaset's 60 fps
    interpolation or BIWI's even trim); both run before the time split."""
    h, feat_lengths = variables(
        input_values, output_len, lengths, output_lengths, dataset=dataset, dtype=dtype,
        use_kernels=use_kernels, pre_layers_only=True,
    )
    return sequence_parallel_layers(
        variables, h, mesh, feat_lengths=feat_lengths, config=config, dtype=dtype,
        use_kernels=use_kernels, axis=axis, gather_output=gather_output,
    )

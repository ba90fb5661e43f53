"""Parallelism on ``torch.distributed``: data, Megatron tensor, FSDP
(ZeRO-3), sequence and pipeline parallelism (``audio2face_tpu/parallel``'s
counterparts; ``comm.py`` holds the hand-written collectives)."""

from audio2face_tpu_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    replicate,
    batch_sharding,
    wav2vec2_param_spec,
    shard_params_tensor_parallel,
    shard_state_tensor_parallel,
)
from audio2face_tpu_torch.parallel.sequence import (
    sequence_parallel_encode,
    sequence_parallel_layers,
)
from audio2face_tpu_torch.parallel.pipeline import (
    pipeline_parallel_encode,
    pipeline_parallel_layers,
    stack_stage_params,
)
from audio2face_tpu_torch.parallel.fsdp import (
    fsdp_spec,
    shard_state_fsdp,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "batch_sharding",
    "wav2vec2_param_spec",
    "shard_params_tensor_parallel",
    "shard_state_tensor_parallel",
    "sequence_parallel_encode",
    "sequence_parallel_layers",
    "pipeline_parallel_encode",
    "pipeline_parallel_layers",
    "stack_stage_params",
    "fsdp_spec",
    "shard_state_fsdp",
]

"""FSDP / ZeRO-3: parameters and optimizer moments sharded over the data axis.

Port of ``audio2face_tpu/parallel/fsdp.py``. Plain data parallelism keeps
every parameter and both Adam moments whole on every rank; FSDP shards each
large-enough parameter, and with it its moments, over the mesh's ``data``
axis, gathers it for use in the forward and backward, and reduce-scatters
its gradient. Here that is FSDP2's ``fully_shard`` over the ``data``
sub-mesh, one unit per wav2vec2 layer and one for the rest of the module,
with the JAX package's placement rule (``fsdp_spec``): the largest
dimension that divides the axis and that tensor parallelism has not taken
(FSDP2 alone would take dimension 0). Parameters the rule leaves whole
(fewer than ``MIN_FSDP_ELEMS`` elements, or no dimension divides) stay out
of FSDP, replicated: the caller reduces their gradients.

Under tensor parallelism FSDP composes around the Megatron shard: a split
layer's local parameter keeps its ``model`` dimension and FSDP takes
another, e.g. the FFN's (3072, 768) ``intermediate_dense`` weight goes to
``("model", "data")``.

Gradients are summed over the data axis, not averaged (``fully_shard``'s
divide factor set to 1): the trainer's losses are normalized by global
counts (``training/trainer.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard

from audio2face_tpu_torch.models.wav2vec2 import EncoderLayer
from audio2face_tpu_torch.parallel import comm
from audio2face_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    shard_state_tensor_parallel,
    wav2vec2_param_spec,
)

# below this many elements a parameter stays replicated: the bytes saved
# are few while every use still pays a gather
MIN_FSDP_ELEMS = 1 << 15


def _best_dim(shape, n_data: int, base: tuple, min_elems: int):
    """The largest dimension of a leaf of at least ``min_elems`` elements
    that ``base`` does not take and ``n_data`` divides, or None."""
    size = 1
    for d in shape:
        size *= d
    if size < min_elems:
        return None
    taken = tuple(base) + (None,) * (len(shape) - len(tuple(base)))
    best = -1
    for i, d in enumerate(shape):
        if taken[i] is None and d % n_data == 0 and d > (shape[best] if best >= 0 else 0):
            best = i
    return None if best < 0 else best


def fsdp_spec(shape, n_data: int, base: tuple = (), min_elems: int = MIN_FSDP_ELEMS) -> tuple:
    """``base`` with ``DATA_AXIS`` inserted on the best shardable dimension.

    Picks the largest dimension that (a) ``base`` does not take (e.g. a
    tensor-parallel ``model`` axis) and (b) divides by ``n_data``. Returns
    ``base`` unchanged when the leaf is too small, no dimension qualifies,
    or the mesh has a single data shard. Specs are tuples of axis names or
    None, equal to the JAX package's ``PartitionSpec``s."""
    best = _best_dim(shape, n_data, base, min_elems) if n_data > 1 else None
    if best is None:
        return tuple(base)
    taken = tuple(base) + (None,) * (len(shape) - len(tuple(base)))
    axes = list(taken)
    axes[best] = DATA_AXIS
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def _megatron_param(module: nn.Module, name: str):
    """``name`` relative to the ``EncoderLayer`` in its Megatron form that
    holds parameter (or buffer) ``name`` of ``module``, or None."""
    owner = name
    while owner:
        owner = owner.rpartition(".")[0]
        mod = module.get_submodule(owner)
        if isinstance(mod, EncoderLayer):
            if mod.tp_group is None:
                return None
            return name[len(owner) + 1:] if owner else name
    return None


def tp_split_dim(module: nn.Module, name: str):
    """The dimension along which tensor parallelism split parameter (or
    buffer) ``name`` of ``module``, or None: only the split weights of an
    ``EncoderLayer`` in its Megatron form have one."""
    rel = _megatron_param(module, name)
    spec = () if rel is None else wav2vec2_param_spec(rel)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_state_fsdp(mesh, tree: nn.Module, tensor_parallel: bool = False,
                     min_elems: int = MIN_FSDP_ELEMS) -> nn.Module:
    """Shard a module's parameters with FSDP (optionally x TP), in place.

    With ``tensor_parallel`` every ``audio_encoder`` first goes to its
    Megatron form (``shard_state_tensor_parallel``); layers already in that
    form keep it. Then each parameter gets ``fsdp_spec`` of its global
    shape with its tensor-parallel dimension taken (on a one-way data axis,
    where the spec shards nothing, the dimension it would pick on a wider
    one: a one-way shard is the whole tensor, and FSDP's path still runs).
    ``fully_shard`` over the ``data`` sub-mesh shards it along the chosen
    dimension (each wav2vec2 layer a unit of its own, the rest of the
    module the root unit); a parameter the spec leaves whole stays
    replicated outside FSDP, as do the biases of a Megatron layer's row-parallel products (the
    model group's first rank adds each, so only it has their gradients: the
    caller sums them over ``model``). The optimizer must be made
    afterwards: its moments then take the same shards. Returns the
    module."""
    if tensor_parallel:
        shard_state_tensor_parallel(mesh, tree)
    n_data = axis_size(mesh, DATA_AXIS)
    dims, ignored = {}, set()
    for name, p in tree.named_parameters():
        shape = list(p.shape)
        tp_dim = tp_split_dim(tree, name)
        base = ()
        if tp_dim is not None:
            shape[tp_dim] *= dist.get_world_size(mesh.get_group(MODEL_AXIS))
            base = tuple(MODEL_AXIS if i == tp_dim else None for i in range(tp_dim + 1))
        best = _best_dim(shape, n_data, base, min_elems)
        if best is None or _megatron_param(tree, name) in ("out_proj.bias", "output_dense.bias"):
            ignored.add(p)
        else:
            dims[p] = best
    data_mesh = mesh[DATA_AXIS]

    def placement(p):
        return Shard(dims[p])

    units = [m for m in tree.modules() if isinstance(m, EncoderLayer)] + [tree]
    for unit in units:
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=placement, ignored_params=ignored)
        # a sum over the data axis, by plain sums (gloo has no pre-scaled one)
        unit.set_gradient_divide_factor(1.0)
        unit.set_force_sum_reduction_for_comms(True)
    return tree


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def state_memory_bytes(tree) -> int:
    """This rank's bytes of a state: a module's parameters and buffers, or
    the tensors of a nested dict/list (an optimizer's ``state_dict()``),
    counting a sharded tensor's local part only."""
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = []

        def walk(x):
            if isinstance(x, torch.Tensor):
                tensors.append(x)
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        walk(tree)
    return sum(_local(t).numel() * _local(t).element_size() for t in tensors)


def gather_full(mesh, module: nn.Module, name: str, value: torch.Tensor) -> torch.Tensor:
    """The whole tensor of ``module``'s parameter or buffer ``name`` (or of
    a state tensor shaped like it, an Adam moment) from this rank's
    ``value``: FSDP's shards gathered over ``data``, then the tensor-parallel
    parts over ``model``. Every rank must call it."""
    if isinstance(value, DTensor):
        value = value.full_tensor()
    dim = tp_split_dim(module, name)
    if dim is not None:
        value = comm.all_gather(value, dim, mesh.get_group(MODEL_AXIS))
    return value


def scatter_full(mesh, module: nn.Module, name: str, full: torch.Tensor,
                 like: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor ``full``, shaped and placed as
    ``like`` (the rank's parameter or state tensor ``name``): the inverse of
    ``gather_full``."""
    dim = tp_split_dim(module, name)
    if dim is not None:
        m = axis_size(mesh, MODEL_AXIS)
        full = full.chunk(m, dim=dim)[mesh.get_local_rank(MODEL_AXIS)]
    if isinstance(like, DTensor):
        (shard,) = like.placements
        local = full.chunk(like.device_mesh.size(), dim=shard.dim)[like.device_mesh.get_local_rank()]
        return DTensor.from_local(local.to(like.device, like.dtype).contiguous(),
                                  like.device_mesh, like.placements, run_check=False)
    return full.to(like.device, like.dtype)

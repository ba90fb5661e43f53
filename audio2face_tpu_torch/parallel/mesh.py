"""Device mesh, batch sharding and Megatron tensor parallelism on
``torch.distributed``.

Port of ``audio2face_tpu/parallel/mesh.py``. JAX runs one controller over a
global array; here every device has a process of its own (one program, many
controllers). Every rank runs the same call with the same host inputs,
computes its share, and the results are gathered so that every rank returns
what the JAX call returns:

- a 2-D ``(data, model)`` ``DeviceMesh`` over all ranks (``make_mesh``),
  NCCL on the card, gloo on the CPU, rank ``LOCAL_RANK`` on
  ``cuda:LOCAL_RANK``;
- batches sharded on ``data``: each rank keeps its rows (``shard_batch``),
  and ``shard_map_data`` runs a function on each rank's rows and gathers
  its outputs;
- wav2vec2's attention heads and FFN split over ``model`` (Megatron tensor
  parallelism: q/k/v and the FFN's first product split by columns,
  ``out_proj`` and ``output_dense`` by rows), the collectives written by
  hand in ``parallel/comm.py``, so that the kernels see plain local
  tensors.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from audio2face_tpu_torch.models.wav2vec2 import EncoderLayer
from audio2face_tpu_torch.parallel import comm
from audio2face_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def _join_default_group() -> None:
    """Join the default process group if none exists: from ``torchrun``'s
    environment when it is set, else as a world of one rank. NCCL where
    CUDA is available, gloo otherwise."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: tuple[int, int] = (-1, 1), devices: Optional[list] = None) -> DeviceMesh:
    """Create a (data, model) mesh over ``devices`` (global ranks; default
    every rank of the default group, which is joined first if there is
    none). ``-1`` absorbs the remaining ranks. Every rank of the group must
    make the mesh."""
    _join_default_group()
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    d, m = shape
    if d == -1 and m == -1:
        raise ValueError("at most one mesh axis may be -1")
    if d == -1:
        d = n // m
    if m == -1:
        m = n // d
    if d * m != n:
        raise ValueError(f"mesh shape {(d, m)} does not cover {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if device_type == "cuda":
        torch.cuda.set_device(_local_rank())
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(d, m),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh: DeviceMesh, device="cuda", what: str = "the mesh") -> torch.device:
    """This rank's device on ``mesh``: ``cuda:LOCAL_RANK`` on a CUDA mesh,
    the CPU on a gloo one. ``device`` (the entry point's argument) must be
    of the mesh's type; nothing falls back to the CPU."""
    device = resolve_device(device, what)
    if device.type != mesh.device_type:
        raise ValueError(f"{what}: device {device} is not on the {mesh.device_type} mesh")
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Leading-axis (batch) sharding over the data axis, as ``DTensor``
    placements over the mesh's (data, model) dimensions."""
    del mesh
    return (Shard(0), Replicate())


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: DeviceMesh, tree):
    """``tree`` with the mesh's first rank's values on every rank, on each
    rank's device: numpy arrays and tensors in nested dicts, lists and
    tuples, or an ``nn.Module`` (its parameters and buffers overwritten in
    place)."""
    dev = mesh_device(mesh, mesh.device_type)
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, nn.Module):
        tree.to(dev)
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                comm.broadcast_(t.data, src)
        return tree
    return _map(lambda x: comm.broadcast_(torch.as_tensor(np.asarray(x) if not isinstance(
        x, torch.Tensor) else x).to(dev).contiguous(), src), tree)


def data_rows(mesh: DeviceMesh, n_rows: int) -> Optional[tuple[int, int]]:
    """``(offset, n_rows)``: the first of this rank's rows of a batch of
    ``n_rows`` sharded on ``data`` (``shard_batch``), or None when the batch
    stays whole on every rank (``n_rows`` not divisible by the axis)."""
    n = axis_size(mesh, DATA_AXIS)
    if n_rows % n:
        return None
    return mesh.get_local_rank(DATA_AXIS) * (n_rows // n), n_rows


def shard_batch(mesh: DeviceMesh, batch: dict) -> dict:
    """A host batch on this rank's device, sharded along the batch axis:
    each rank keeps its rows of every per-item array along ``data``;
    scalars, and arrays whose leading dimension the axis does not divide
    (the last, odd-sized val batch), stay whole on every rank."""
    n, i = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)
    dev = mesh_device(mesh, mesh.device_type)

    def put(x):
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] % n != 0:
            return torch.as_tensor(x).to(dev)
        c = x.shape[0] // n
        return torch.as_tensor(x[i * c : (i + 1) * c]).to(dev)

    return _map(put, batch)


def _spec_dim(spec) -> Optional[int]:
    spec = () if spec is None else tuple(spec)
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


def shard_map_data(mesh: DeviceMesh, fn, in_specs, out_specs):
    """``fn`` run on each rank's share of the data axis, its outputs
    gathered: the counterpart of JAX's ``shard_map`` of a batch-parallel
    function.

    A spec is a tuple with one entry per dimension, ``DATA_AXIS`` on the
    sharded one (JAX's ``PartitionSpec`` entries: ``("data",)``); ``()``
    leaves an argument whole. Each argument with ``DATA_AXIS`` in its spec
    (a tensor or numpy array) is cut along that dimension and the rank's
    part handed to ``fn``, which must therefore take sizes from its inputs'
    shapes; each output with it is all-gathered along that dimension, so
    every rank returns the whole result. ``out_specs`` is one spec, or a
    tuple of specs for a tuple of outputs."""
    group = mesh.get_group(DATA_AXIS)
    n, i = axis_size(mesh, DATA_AXIS), mesh.get_local_rank(DATA_AXIS)
    multi = isinstance(out_specs, tuple) and any(
        isinstance(s, tuple) or s is None for s in out_specs)

    def cut(x, spec):
        dim = _spec_dim(spec)
        if dim is None:
            return x
        if x.shape[dim] % n:
            raise ValueError(
                f"dimension {dim} of size {x.shape[dim]} does not divide over the "
                f"{n}-way data axis")
        c = x.shape[dim] // n
        return x[(slice(None),) * dim + (slice(i * c, (i + 1) * c),)]

    def gather(y, spec):
        dim = _spec_dim(spec)
        return y if dim is None else comm.gather_along(y, dim, group, reduce_grad=False)

    def sharded(*args):
        out = fn(*(cut(a, s) for a, s in zip(args, in_specs)))
        if multi:
            return tuple(gather(y, s) for y, s in zip(out, out_specs))
        return gather(out, out_specs)

    return sharded


def wav2vec2_param_spec(path, leaf=None) -> tuple:
    """Tensor-parallel spec of a wav2vec2 parameter by its path: a tuple of
    mesh axis names (or None) per dimension, equal to the JAX package's
    ``PartitionSpec`` for the same path.

    ``path``: a dotted name (``"layers.0.q_proj.weight"``) or a sequence of
    names or JAX path keys. Column-parallel (the output dimension split):
    q/k/v projections and the FFN's ``intermediate_dense``; row-parallel
    (the input dimension split): ``out_proj`` and ``output_dense``, whose
    bias stays whole (added once, after the reduce); everything else
    whole. A JAX ``kernel`` is (in, out), a torch ``weight`` (out, in): the
    spec is in the leaf's own layout."""
    del leaf
    names = path.split(".") if isinstance(path, str) else [
        getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    joined = "/".join(str(n) for n in names)
    last = str(names[-1])
    two_d = last in ("kernel", "weight")
    if any(f"{n}_proj" in joined for n in ("q", "k", "v")) or "intermediate_dense" in joined:
        if two_d:  # the output dimension
            return (None, MODEL_AXIS) if last == "kernel" else (MODEL_AXIS, None)
        return (MODEL_AXIS,)  # the bias follows the output dimension
    if "out_proj" in joined or "output_dense" in joined:
        if two_d:  # the input dimension
            return (MODEL_AXIS, None) if last == "kernel" else (None, MODEL_AXIS)
        return ()
    return ()


def _megatron_layer(layer: EncoderLayer, group) -> None:
    """``layer`` in its Megatron form over ``group``: each split parameter
    replaced by this rank's part (``wav2vec2_param_spec``'s dimension). A
    layer whose heads or FFN width the group does not divide stays whole."""
    m, r = dist.get_world_size(group), dist.get_rank(group)
    if layer.num_heads % m or layer.intermediate_dense.out_features % m:
        return
    for name, p in list(layer.named_parameters()):
        spec = wav2vec2_param_spec(name)
        if MODEL_AXIS not in spec:
            continue
        owner_name, _, attr = name.rpartition(".")
        owner = layer.get_submodule(owner_name)
        part = p.detach().chunk(m, dim=spec.index(MODEL_AXIS))[r].clone()
        setattr(owner, attr, nn.Parameter(part, requires_grad=p.requires_grad))
    for lin in (layer.q_proj, layer.k_proj, layer.v_proj, layer.intermediate_dense,
                layer.out_proj, layer.output_dense):
        lin.out_features, lin.in_features = lin.weight.shape
    layer.tp_group = group


def shard_params_tensor_parallel(mesh: DeviceMesh, params: nn.Module) -> nn.Module:
    """Every wav2vec2 ``EncoderLayer`` in the module ``params`` (an encoder,
    or a model or extractor holding one) in its Megatron form over the
    mesh's ``model`` axis, in place; returns the module. Only layers whose
    heads and FFN width divide the axis are split."""
    group = mesh.get_group(MODEL_AXIS)
    for mod in params.modules():
        if isinstance(mod, EncoderLayer) and mod.tp_group is None:
            _megatron_layer(mod, group)
    return params


def shard_state_tensor_parallel(mesh: DeviceMesh, tree: nn.Module) -> nn.Module:
    """Place a training model for DP x TP: every module named
    ``audio_encoder`` goes to its Megatron form, everything else stays
    replicated. The optimizer's moments, made afterwards from the
    parameters, take the same shards (the JAX function places params and
    moments alike)."""
    for name, mod in list(tree.named_modules()):
        if name.rpartition(".")[2] == "audio_encoder":
            shard_params_tensor_parallel(mesh, mod)
    return tree

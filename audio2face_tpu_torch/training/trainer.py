"""Experiment runtime: training loop, checkpointing, early stopping.

Port of ``audio2face_tpu/training/trainer.py`` for every model: FaceFormer
on ``dataset == "vocaset"`` or ``"biwi"`` (the BIWI model: 25 fps frames,
period 25, trained through the differentiable step loop) and the frame
models (Audio2Mesh, VOCA, Song2Face), with the same observable semantics:

- x100 vertex/template unit scaling before the model, /100 on predictions;
- the frame models' feature extractor (MFCC or wav2vec2) runs inside the
  step and its output is detached, as the reference detaches it;
  BatchNorm runs in train mode and updates its running statistics (once
  per microbatch under gradient accumulation), as flax does: with the
  biased batch variance (``models/layers.py TorchBatchNorm``);
- ``torch.optim.Adam(lr, weight_decay=lr/10)``: coupled decay, added to the
  gradient before the moment updates;
- "err" metric = mean over items of the mean squared difference over the
  flattened vertex vector;
- per-epoch train/val err logging to ``metrics.jsonl``, best-checkpoint
  selection and early stopping on val/err;
- bf16 compute when the config requests "16-mixed", with f32 parameters and
  optimizer state;
- every random stream derives from ``(seed, step)`` (and the microbatch
  index under gradient accumulation) and every epoch's shuffle from
  ``(seed, epoch)``, so a resumed run replays an uninterrupted one.

The experiment owns its state (model with its BatchNorm statistics,
optimizer, step count); the data module is duck-typed:
``train_batches(np_rng)`` and ``val_batches()`` yield dicts of numpy arrays
``audio`` (B, S), ``one_hot`` (B, n), ``verts`` (B, T, V*3) or (B, T, V, 3)
(frame models: (B, V*3) or (B, V, 3), one frame an item), ``template_vert``
(B, V, 3) and, for padded FaceFormer batches, ``audio_lengths`` (B,)
(``data/vocaset.py``, ``data/biwi.py``). ``fit`` takes the training batches
through ``runtime.Prefetcher``: the next batches are assembled on a worker
thread and uploaded from pinned memory on a CUDA stream of their own while
the current step runs. Runs on the GPU unless the caller passes
``device="cpu"``. Checkpoints are the
port's own ``torch.save`` files; ``load_torch_checkpoint`` takes a reference
PyTorch/Lightning checkpoint. ``evaluate`` scores the test split with the
metrics of ``evaluation.py``. ``fit`` writes tensorboard scalars when
``torch.utils.tensorboard`` is installed and, with ``profile_epoch``, a
``torch.profiler`` Chrome trace of that epoch's first steps. Not ported:
the JAX trainer's orbax checkpoints (orbax imports JAX).

``mesh=`` (or a ``config.mesh_shape`` other than one device, ``fsdp``, or
``torchrun``'s environment) trains on a ``(data, model)`` mesh
(``parallel/``), one process a device, every rank running the same calls
on the same host batches:

- data parallelism: each batch (each microbatch under gradient
  accumulation) is sharded on ``data`` by ``shard_batch``; the losses
  divide by the whole batch's counts (``losses.py`` ``group=``), so the
  ranks' losses sum to the whole batch's and their gradients are summed;
  BatchNorm takes the whole batch's moments; every random draw is the
  rank's slice of the solo step's (``models/wav2vec2.py``), so a sharded
  step equals the solo step with dropout on. A batch the ranks cannot
  share evenly (its size, or an odd share of a frame model's velocity
  pairs) is computed whole on every rank and its gradient divided;
- tensor parallelism (on by default when the ``model`` axis is larger than
  1): the wav2vec2 encoders (the model's and a wav2vec2 feature
  extractor's) in their Megatron form;
- ``fsdp``: FSDP2 (``parallel/fsdp.py``) over the ``data`` axis, composed
  around the Megatron shards;
- only rank 0 writes ``metrics.jsonl``, tensorboard and checkpoints, and
  checkpoints hold the whole state, gathered (they load into a solo
  trainer and the predictors).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.losses import (
    FaceFormerLoss,
    VocaLoss,
    chunked_faceformer_head_loss,
    masked_faceformer_loss,
    mse_error,
)
from audio2face_tpu_torch.registry import get_extractor, get_loss_fn, get_model
from audio2face_tpu_torch.runtime import Prefetcher
from audio2face_tpu_torch.utils.device import resolve_device


@dataclass
class FitResult:
    best_val_err: float
    best_epoch: int
    epochs_run: int
    history: list[dict] = field(default_factory=list)


def stream_seed(*key: int) -> int:
    """A 63-bit generator seed from an integer key such as (seed, step, i):
    distinct keys give independent streams, the same key the same stream."""
    state = np.random.SeedSequence([int(k) for k in key]).generate_state(1, dtype=np.uint64)
    return int(state[0] >> np.uint64(1))


class Audio2FaceExperiment:
    """Owns model + loss + optimizer + step count."""

    def __init__(
        self,
        config: ExpConfig,
        log_dir: Optional[str] = None,
        tensorboard: bool = True,
        accumulate_grad_batches: Optional[int] = None,
        device="cuda",
        model_kwargs: Optional[dict] = None,
        use_kernels: bool = True,
        mesh=None,
        tensor_parallel: Optional[bool] = None,
        fsdp: Optional[bool] = None,
    ):
        """tensorboard: also write ``fit``'s scalars as tensorboard events
        into ``log_dir`` (``metrics.jsonl`` is always written); without the
        ``tensorboard`` package no events are written. The writer and its
        import are made at ``fit``'s first write.

        accumulate_grad_batches: split each batch into this many
        microbatches, average their gradients, and apply ONE optimizer
        update; the batch size must divide evenly. Defaults to the config's
        key. ``model_kwargs`` go to the model's constructor (a narrow
        ``encoder_config`` in tests). ``use_kernels=False`` runs the plain
        versions of every kernel.

        mesh: a ``parallel.make_mesh`` mesh; made from ``config.mesh_shape``
        when none is given and the config asks for more than one device,
        for ``fsdp``, for ``tensor_parallel=True``, or under ``torchrun``.
        tensor_parallel: Megatron-split the wav2vec2 encoders over the
        mesh's ``model`` axis; default on when that axis is larger than 1.
        fsdp: shard parameters and Adam moments over the ``data`` axis
        (ZeRO-3); defaults to the config's ``fsdp`` key."""
        from audio2face_tpu_torch.parallel import mesh as pm

        if accumulate_grad_batches is None:
            accumulate_grad_batches = config.accumulate_grad_batches
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")
        self.fsdp = bool(config.fsdp if fsdp is None else fsdp)
        if mesh is None and (
            tuple(config.mesh_shape) not in ((-1, 1), (1, 1)) or self.fsdp or tensor_parallel
            or "WORLD_SIZE" in os.environ
        ):
            mesh = pm.make_mesh(tuple(config.mesh_shape))
        self.mesh = mesh
        self.tensor_parallel = mesh is not None and (
            pm.axis_size(mesh, pm.MODEL_AXIS) > 1 if tensor_parallel is None
            else bool(tensor_parallel))
        if config.dataset not in ("vocaset", "biwi"):
            raise ValueError(f"unknown dataset {config.dataset!r}; available: vocaset, biwi")
        dataset_kwargs: dict = {}
        if config.dataset != "vocaset":
            if config.modelname != "faceformer":
                raise ValueError(
                    f"dataset={config.dataset!r} is only supported by the "
                    "faceformer model family"
                )
            # BIWI animates at 25 fps; the upstream FaceFormer uses the frame
            # rate as the PPE/ALiBi period on both datasets
            dataset_kwargs = {"dataset": config.dataset, "period": 25}
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.config = config
        if mesh is None:
            self.device = resolve_device(device, "Audio2FaceExperiment")
        else:
            self.device = pm.mesh_device(mesh, device, "Audio2FaceExperiment")
        # the rank that writes logs and checkpoints
        self.writer = mesh is None or dist.get_rank() == 0
        self.use_kernels = use_kernels
        self.log_dir = log_dir or os.path.join("logs", config.name())
        self.is_faceformer = config.modelname == "faceformer"
        self.tensorboard = tensorboard
        self._tb = None

        model_cls = get_model(config.modelname)
        self.feature_extractor = get_extractor(config.feature_extractor)(
            sample_rate=config.sample_rate, n_feature=config.n_feature, out_dim=config.out_dim,
            win_length=config.win_length, hop_length=config.hop_length, n_fft=1024,
        )
        if self.feature_extractor is not None:
            self.feature_extractor = self.feature_extractor.to(self.device)
        self.model = model_cls(
            n_verts=config.vertex_count, n_onehot=config.one_hot_size,
            dtype=torch.bfloat16 if config.bf16_compute else None,
            **dataset_kwargs, **(model_kwargs or {}),
        )
        self.model.init_parameters(torch.Generator().manual_seed(config.seed))
        self.model.to(self.device)
        if mesh is not None:
            self._shard_state()
        if config.loss is None:
            self.loss_fn = get_loss_fn(config.modelname)
        else:
            loss_map = {"voca": VocaLoss(), "faceformer": FaceFormerLoss()}
            try:
                self.loss_fn = loss_map[config.loss]
            except KeyError:
                raise KeyError(
                    f"Unknown loss {config.loss!r}; available: {sorted(loss_map)}"
                ) from None
        self.lr = config.lr
        self.optimizer = self._new_optimizer()
        self.step = 0

    def _shard_state(self) -> None:
        """Place the model (and a wav2vec2 extractor) on the mesh: rank 0's
        weights on every rank, BatchNorm synchronized over ``data``, then
        tensor parallelism and FSDP as asked (the JAX trainer's
        ``_place_state`` and extractor placement)."""
        from audio2face_tpu_torch.models.layers import TorchBatchNorm
        from audio2face_tpu_torch.parallel import fsdp as pf
        from audio2face_tpu_torch.parallel import mesh as pm

        mesh = self.mesh
        pm.replicate(mesh, self.model)
        for mod in self.model.modules():
            if isinstance(mod, TorchBatchNorm):
                mod.sync_group = mesh.get_group(pm.DATA_AXIS)
        if self.fsdp:
            pf.shard_state_fsdp(mesh, self.model, tensor_parallel=self.tensor_parallel)
        elif self.tensor_parallel:
            pm.shard_state_tensor_parallel(mesh, self.model)
        fe = self.feature_extractor
        if isinstance(fe, torch.nn.Module):
            pm.replicate(mesh, fe)
            if self.tensor_parallel:
                pm.shard_params_tensor_parallel(mesh, fe)
            if self.fsdp:
                pf.shard_state_fsdp(mesh, fe)

    def _new_optimizer(self) -> torch.optim.Adam:
        params = list(self.model.parameters())
        # FSDP's sharded parameters and the replicated ones in two groups:
        # Adam's multi-tensor step takes one kind at a time
        groups = [g for g in (
            [p for p in params if isinstance(p, DTensor)],
            [p for p in params if not isinstance(p, DTensor)]) if g]
        return torch.optim.Adam(
            [{"params": g} for g in groups], lr=self.config.lr,
            weight_decay=self.config.lr / 10.0)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Model, optimizer and step count, on the CPU (a copy). On a mesh
        the whole state, gathered on every rank (every rank must call it),
        laid out as a solo trainer's."""
        if self.mesh is not None:
            return self._gathered_state()

        def cpu(x):
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().clone()
            if isinstance(x, dict):
                return {k: cpu(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(cpu(v) for v in x)
            return x

        return {
            "model": cpu(self.model.state_dict()),
            "optimizer": cpu(self.optimizer.state_dict()),
            "step": self.step,
        }

    def load_state_dict(self, state: dict) -> None:
        """Load a whole state (``state_dict()``'s layout); on a mesh each
        rank keeps its shards of it."""
        if self.mesh is None:
            self.model.load_state_dict(state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
        else:
            self._load_model_state(state["model"])
            self.optimizer.load_state_dict(self._sharded_optimizer_state(state["optimizer"]))
        self.step = int(state["step"])

    # the whole state of a sharded model: each tensor gathered like its
    # parameter (parallel/fsdp.py gather_full), the optimizer's state keyed
    # by the parameter's place in model.parameters(), as a solo trainer's

    def _param_order(self) -> tuple[list, dict]:
        """The names of the optimizer's parameters in its order, and each
        name's place in ``model.parameters()``."""
        name_of = {p: n for n, p in self.model.named_parameters()}
        place = {n: i for i, (n, _) in enumerate(self.model.named_parameters())}
        order = [name_of[p] for g in self.optimizer.param_groups for p in g["params"]]
        return order, place

    def _gathered_state(self) -> dict:
        from audio2face_tpu_torch.parallel.fsdp import gather_full

        mesh, model = self.mesh, self.model
        sd = {n: gather_full(mesh, model, n, v).detach().cpu().clone()
              for n, v in model.state_dict().items()}
        opt = self.optimizer.state_dict()
        order, place = self._param_order()
        state = {}
        for i, st in opt["state"].items():
            name = order[i]
            state[place[name]] = {
                k: (gather_full(mesh, model, name, v).detach().cpu().clone()
                    if isinstance(v, torch.Tensor) and k != "step" else
                    v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
                for k, v in st.items()}
        group = {k: v for k, v in opt["param_groups"][0].items() if k != "params"}
        group["params"] = list(range(len(place)))
        return {"model": sd, "optimizer": {"state": state, "param_groups": [group]},
                "step": self.step}

    def _load_model_state(self, full: dict) -> None:
        from audio2face_tpu_torch.parallel.fsdp import scatter_full

        local = self.model.state_dict()
        self.model.load_state_dict({
            n: scatter_full(self.mesh, self.model, n, full[n], like=v) for n, v in local.items()})

    def _sharded_optimizer_state(self, full: dict) -> dict:
        from audio2face_tpu_torch.parallel.fsdp import scatter_full

        params = dict(self.model.named_parameters())
        order, place = self._param_order()
        state = {}
        for i, name in enumerate(order):
            st = full["state"].get(place[name])
            if st is None:
                continue
            state[i] = {k: (scatter_full(self.mesh, self.model, name, v, like=params[name])
                            if isinstance(v, torch.Tensor) and k != "step" else v)
                        for k, v in st.items()}
        groups, start = [], 0
        for g in self.optimizer.param_groups:
            hyper = {k: v for k, v in full["param_groups"][0].items() if k != "params"}
            groups.append(dict(hyper, params=list(range(start, start + len(g["params"])))))
            start += len(g["params"])
        return {"state": state, "param_groups": groups}

    def load_torch_checkpoint(self, path: str) -> None:
        """Swap in the weights (and BatchNorm statistics) of a reference
        PyTorch/Lightning checkpoint, converted to the port's names, and
        start the Adam state afresh; the step count stays. A FaceFormer
        checkpoint is read for the config's dataset (BIWI carries the cross
        q/k projections)."""
        from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
        from audio2face_tpu_torch.compat.torch_convert import (
            convert_state_dict,
            load_torch_checkpoint,
        )

        sd = load_torch_checkpoint(path)
        if self.is_faceformer:
            state_dict = convert_faceformer(sd, dataset=self.config.dataset)
        else:
            state_dict = convert_state_dict(self.config.modelname, sd)
        if self.mesh is None:
            self.model.load_state_dict(state_dict)
        else:
            self._load_model_state(state_dict)
        self.optimizer = self._new_optimizer()

    # ------------------------------------------------------------------
    # step functions
    # ------------------------------------------------------------------

    def _generator(self, *key: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(stream_seed(*key))

    def _to_device(self, batch: dict) -> dict:
        """Each value as a tensor on the experiment's device; tensors already
        there (the ``Prefetcher``'s uploads) pass through untouched."""
        return {
            k: v.to(self.device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)).to(self.device)
            for k, v in batch.items()
        }

    def _place(self, batch: dict):
        """``(batch on the device, rows, group)``: on a mesh whose ranks can
        share the batch, this rank's rows of it (``shard_batch``), the
        ``(offset, total)`` of those rows and the ``data`` group the losses
        normalize over; else the whole batch, None, None. The ranks share
        a batch that the data axis divides, into shares that keep a frame
        model's velocity pairs (consecutive items) whole; a FaceFormer batch
        only with ``audio_lengths`` (the masked loss)."""
        from audio2face_tpu_torch.parallel import mesh as pm

        if self.mesh is None:
            return self._to_device(batch), None, None
        n = batch["audio"].shape[0]
        rows = pm.data_rows(self.mesh, n)
        if rows is not None:
            share = n // pm.axis_size(self.mesh, pm.DATA_AXIS)
            ok = "audio_lengths" in batch if self.is_faceformer else share % 2 == 0
            rows = rows if ok else None
        if rows is None:
            return self._to_device(batch), None, None
        return (pm.shard_batch(self.mesh, batch), rows,
                self.mesh.get_group(pm.DATA_AXIS))

    def _sum_metrics(self, metrics: dict, group) -> dict:
        """The ranks' metric shares summed: each loss term is the rank's
        share of the whole batch's (normalized by global counts)."""
        if group is None:
            return metrics
        from audio2face_tpu_torch.parallel import comm

        names = list(metrics)
        total = comm.all_reduce(torch.stack([metrics[k].detach().float() for k in names]), group)
        return dict(zip(names, total.unbind()))

    def _sync_gradients(self) -> None:
        """Sum the gradients FSDP does not reduce: the biases of the
        row-parallel products, which only the model group's first rank adds
        (over ``model``), then every parameter FSDP leaves replicated (over
        ``data``); one flat buffer each."""
        from audio2face_tpu_torch.models.wav2vec2 import EncoderLayer
        from audio2face_tpu_torch.parallel import comm
        from audio2face_tpu_torch.parallel import mesh as pm

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        def summed(params, group):
            grads = [local(p.grad) for p in params if p.grad is not None]
            if grads:
                flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
                for g, s in zip(grads, flat.split([g.numel() for g in grads])):
                    g.copy_(s.view_as(g))

        if self.tensor_parallel:
            partial = []
            for m in self.model.modules():
                # LayerDrop skips a layer on every rank alike
                if isinstance(m, EncoderLayer) and m.tp_group is not None \
                        and m.q_proj.weight.grad is not None:
                    for p in (m.out_proj.bias, m.output_dense.bias):
                        if p.grad is None:  # the ranks that add no bias
                            p.grad = torch.zeros_like(p)
                        partial.append(p)
            summed(partial, self.mesh.get_group(pm.MODEL_AXIS))
        summed([p for p in self.model.parameters() if not isinstance(p, DTensor)],
               self.mesh.get_group(pm.DATA_AXIS))

    def _unpack(self, batch: dict):
        """x100 scaling + field split."""
        verts = batch["verts"].float() * 100.0
        template = batch["template_vert"].float() * 100.0
        return batch["audio"].float(), batch["one_hot"].float(), verts, template, batch.get("audio_lengths")

    def _apply(self, batch: dict, train: bool, generator=None, rows=None):
        x, one_hot, verts, template, lengths = self._unpack(batch)
        if not self.is_faceformer:
            # the extractor's output comes detached (the reference detaches it)
            feats = x if self.feature_extractor is None else self.feature_extractor(x)
            return self.model(feats, one_hot, template, train=train), None, verts
        out = self.model(
            x, one_hot, template, lengths, train=train, generator=generator,
            use_kernels=self.use_kernels, batch_rows=rows,
        )
        pred, frame_mask = out if lengths is not None else (out, None)
        return pred, frame_mask, verts

    def _compute_loss(self, pred, verts, frame_mask, group=None):
        """The loss terms; with ``group`` this rank's share of the whole
        batch's (``_place``: only the masked FaceFormer loss and the frame
        models' loss are shared)."""
        if not self.is_faceformer:
            return self.loss_fn(pred, verts, group)
        gt = verts.reshape(pred.shape)
        if frame_mask is not None:
            return masked_faceformer_loss(pred, gt, frame_mask, group)
        return self.loss_fn(pred, gt)

    def _train_loss(self, batch: dict, generator: torch.Generator, rows=None, group=None):
        """(loss dict, err) of one microbatch in train mode; with ``rows``
        and ``group`` (``_place``) this rank's shares of them."""
        n_verts = self.config.vertex_count // 3
        if self.is_faceformer and "audio_lengths" in batch:
            # padded whole-clip training: decode to hidden states and run the
            # vertex head INSIDE the chunked loss; the (B, T, V, 3)
            # prediction never materializes, and its backward recomputes one
            # frame chunk at a time
            x, one_hot, verts_gt, template, lengths = self._unpack(batch)
            hs, fmask = self.model(
                x, one_hot, template, lengths, train=True, generator=generator,
                return_hidden=True, use_kernels=self.use_kernels, batch_rows=rows,
            )
            head = self.model.vertice_map_r
            return chunked_faceformer_head_loss(
                hs, head.weight.T, head.bias, template,
                verts_gt.reshape(hs.shape[0], hs.shape[1], -1, 3), fmask, n_verts=n_verts,
                group=group,
            )
        pred, fmask, verts = self._apply(batch, train=True, generator=generator, rows=rows)
        return (self._compute_loss(pred, verts, fmask, group),
                mse_error(pred, verts, n_verts, fmask, group=group))

    def accumulate_gradients(self, batch: dict) -> dict:
        """Leave the mean gradient of the batch's k microbatches in the
        parameters' ``.grad`` (k = ``accumulate_grad_batches``) and return
        the mean metrics. Microbatch i draws from the stream ``(seed, step,
        i)``; with k = 1 the stream is ``(seed, step)``.

        On a mesh each microbatch is shared by the data axis (``_place``),
        the gradients summed over it, and the metrics are the whole
        batch's."""
        from audio2face_tpu_torch.parallel import mesh as pm

        k = self.accumulate_grad_batches
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        if k == 1:
            micro, keys = [batch], [(self.config.seed, self.step)]
        else:
            n = batch["audio"].shape[0]
            if n % k:
                raise ValueError(f"batch of {n} does not divide into {k} microbatches")
            m = n // k
            micro = [{key: v[i * m : (i + 1) * m] for key, v in batch.items()} for i in range(k)]
            keys = [(self.config.seed, self.step, i) for i in range(k)]
        totals: dict = {}
        for mb, key in zip(micro, keys):
            mb, rows, group = self._place(mb)
            loss, err = self._train_loss(mb, self._generator(*key), rows, group)
            scale = 1.0 / k
            if self.mesh is not None and group is None:
                # every rank computed the whole batch; the gradients are summed
                scale /= pm.axis_size(self.mesh, pm.DATA_AXIS)
            (loss["loss"] * scale).backward()
            for name, value in self._sum_metrics(dict(loss, err=err), group).items():
                totals[name] = totals.get(name, 0.0) + value.detach() / k
        if self.mesh is not None:
            self._sync_gradients()
        return totals

    def train_step(self, batch: dict) -> dict:
        """One optimizer update on ``batch``; returns the metrics (tensors on
        the device: ``loss``, ``rec_loss``, ``vel_loss``, ``err``)."""
        metrics = self.accumulate_gradients(batch)
        self.optimizer.step()
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        self.model.eval()
        batch, rows, group = self._place(batch)
        pred, fmask, verts = self._apply(batch, train=False)
        loss = self._compute_loss(pred, verts, fmask, group)
        return self._sum_metrics(dict(loss, err=mse_error(
            pred, verts, self.config.vertex_count // 3, fmask, group=group)), group)

    @torch.no_grad()
    def predict(self, batch: dict):
        """Predicted vertices in data units (/100) plus the err metric
        against ground truth (on a mesh the whole batch's, on every
        rank)."""
        from audio2face_tpu_torch.parallel import comm

        self.model.eval()
        batch, rows, group = self._place(batch)
        pred, fmask, verts = self._apply(batch, train=False)
        err = mse_error(pred, verts, self.config.vertex_count // 3, fmask, group=group)
        if group is not None:
            pred, err = comm.all_gather(pred, 0, group), comm.all_reduce(err, group)
        return pred / 100.0, err

    def evaluate(
        self,
        datamodule,
        regions=None,
        sentences: Optional[list] = None,
        max_sentences: Optional[int] = None,
    ) -> dict:
        """Domain evaluation over the test split: LVE / FDD / MVE / max-L2
        (``evaluation.py``). Runs :meth:`predict` on each test (subject,
        sentence), computes that sentence's metrics in dataset units on the
        device, and returns their means plus the mean ``err`` and
        ``n_sentences``. The per-sentence numbers stay on the device until
        one read at the end.

        ``regions=None`` derives the geometric stand-in masks from the first
        sentence's template (``evaluation.infer_regions``); pass a
        ``VertexRegions`` built from the licensed FLAME masks for numbers
        comparable with published results. ``sentences`` restricts to an
        explicit [(subject, sentence), ...] list."""
        from audio2face_tpu_torch import evaluation as E

        ds = datamodule.test_dataset
        pairs = sentences or list(dict.fromkeys((r[0], r[1]) for r in ds.datalist))
        if max_sentences is not None:
            pairs = pairs[:max_sentences]
        if not pairs:
            raise ValueError("test split has no sentences to evaluate")

        rows = []
        for human, sentence in pairs:
            batch = datamodule.predict_batch(human, sentence)
            pred, err = self.predict(batch)
            gt = np.asarray(batch["verts"], np.float32)
            template = np.asarray(batch["template_vert"], np.float32)
            frame_mask = None
            if pred.ndim == 4:  # clip mode: (1, T_pad, V, 3) + valid lengths
                n_frames = pred.shape[1]
                frame_mask = (
                    np.arange(n_frames)[None, :] < np.asarray(batch["frame_lengths"])[:, None]
                ).astype(np.float32)
                gt = gt.reshape(pred.shape)
                template = template[:, None]  # (1, 1, V, 3) broadcast over T
            if regions is None:
                tmpl0 = np.asarray(batch["template_vert"]).reshape(-1, pred.shape[-2], 3)[0]
                regions = E.infer_regions(tmpl0)
            metrics = E.animation_metrics(pred, gt, template, regions, frame_mask)
            rows.append(torch.cat([metrics, err.float().reshape(1)]))
        # one device-to-host read; means in float64 over the sentences
        per_sentence = torch.stack(rows).cpu().numpy().astype(np.float64)
        out = dict(zip(E.METRICS, per_sentence[:, :4].mean(axis=0).tolist()))
        out["err"] = float(per_sentence[:, 4].mean())
        out["n_sentences"] = len(pairs)
        return out

    # ------------------------------------------------------------------
    # fit loop
    # ------------------------------------------------------------------

    def fit(
        self,
        datamodule,
        max_epochs: Optional[int] = None,
        log_every: int = 10,
        checkpoint: bool = True,
        profile_epoch: Optional[int] = None,
        resume: bool = False,
        checkpoint_every_steps: Optional[int] = None,
    ) -> tuple[dict, FitResult]:
        """Fit loop. Returns the best epoch's state (``state_dict()`` form, on
        the CPU) and a ``FitResult``; the experiment itself holds the last
        state.

        ``profile_epoch=E`` runs ``torch.profiler`` (the CPU, and CUDA on
        the GPU) over epoch E's first 5 steps, or all of them if the epoch
        is shorter, each step marked ``train``, and writes a Chrome trace to
        ``{log_dir}/trace-epoch=E.json`` (open it in Perfetto or
        ``chrome://tracing``).

        ``resume=True`` continues from the newest checkpoint: optimizer
        state, step and epoch counter included. ``checkpoint_every_steps=N``
        also saves a rolling ``periodic-epoch=E-step=S`` checkpoint every N
        optimizer steps (newest two kept); a run resumed from one finishes
        the interrupted epoch, skipping the batches already trained.

        On a mesh every rank runs the loop on the same batches (each takes
        its share of each); only rank 0 writes the metrics, tensorboard,
        the profiler's trace and the checkpoints, and prints."""
        cfg = self.config
        max_epochs = max_epochs if max_epochs is not None else cfg.max_epochs
        os.makedirs(self.log_dir, exist_ok=True)
        metrics_path = os.path.join(self.log_dir, "metrics.jsonl")

        start_epoch, skip_steps = 0, 0
        if resume and self._checkpoints():
            ckpt_epoch, epoch_step = self.load_checkpoint()
            if epoch_step is None:
                start_epoch = ckpt_epoch + 1  # end-of-epoch save: next epoch
            else:
                # mid-epoch periodic save: finish the interrupted epoch by
                # replaying its (seed, epoch) shuffle and skipping the
                # batches already trained
                start_epoch, skip_steps = ckpt_epoch, epoch_step

        best_val, best_epoch = float("inf"), -1
        best_state = self.state_dict()
        bad_epochs = 0
        history = []

        with open(metrics_path if self.writer else os.devnull, "a") as logf:
            for epoch in range(start_epoch, max_epochs):
                t0 = time.time()
                train_errs, n_steps = [], 0
                # per-epoch shuffle stream derived from (seed, epoch): epoch
                # E's batch order is reconstructible in isolation
                np_rng = np.random.default_rng([cfg.seed, epoch])
                batches = iter(datamodule.train_batches(np_rng))
                epoch_step0 = skip_steps if epoch == start_epoch else 0
                for _ in range(epoch_step0):  # already trained before resume
                    next(batches, None)
                profiler = (self._start_profiler()
                            if epoch == profile_epoch and self.writer else None)
                try:
                    # the next batches are assembled, and uploaded from
                    # pinned memory on a side stream, while this step runs
                    with Prefetcher(batches, device=self.device) as prefetcher:
                        for batch in prefetcher:
                            with torch.profiler.record_function("train"):
                                metrics = self.train_step(batch)
                            n_steps += 1
                            if profiler is not None and n_steps >= 5:
                                self._stop_profiler(profiler, epoch)
                                profiler = None
                            if checkpoint_every_steps and self.step % checkpoint_every_steps == 0:
                                self.save_checkpoint(epoch, periodic=True,
                                                     epoch_step=epoch_step0 + n_steps)
                            if n_steps % log_every == 0:
                                row = {k: float(v) for k, v in metrics.items()}
                                logf.write(json.dumps({"epoch": epoch, "step": self.step, **row}) + "\n")
                                for k, v in row.items():
                                    self._scalar(f"train_step/{k}", v, self.step)
                            train_errs.append(metrics["err"])
                finally:
                    if profiler is not None:  # fewer than 5 steps, or a step failed
                        self._stop_profiler(profiler, epoch)
                # one device-to-host read for the whole epoch's metrics
                train_err = float(torch.stack(train_errs).mean()) if train_errs else float("nan")
                val_errs = [self.eval_step(batch)["err"] for batch in datamodule.val_batches()]
                val_err = float(torch.stack(val_errs).mean()) if val_errs else float("nan")

                row = {
                    "epoch": epoch, "train/err": train_err, "val/err": val_err,
                    "seconds": time.time() - t0, "steps": n_steps,
                }
                history.append(row)
                logf.write(json.dumps(row) + "\n")
                logf.flush()
                # scalar names mirror the reference's logger
                self._scalar("train/err", train_err, epoch)
                self._scalar("val/err", val_err, epoch)
                if self.writer:
                    print(f"Epoch {epoch} train err: {train_err}")
                    print(f"Epoch {epoch} val error: {val_err}")

                if val_err < best_val:
                    best_val, best_epoch, bad_epochs = val_err, epoch, 0
                    best_state = self.state_dict()
                    if checkpoint:
                        self.save_checkpoint(epoch)
                else:
                    bad_epochs += 1
                    if bad_epochs >= cfg.early_stop_patience:
                        break

        if self._tb is not None:
            self._tb.flush()
        return best_state, FitResult(best_val, best_epoch, len(history), history)

    def _scalar(self, tag: str, value: float, step: int) -> None:
        """One tensorboard scalar; the writer (and its import) is made at
        the first call. Without the ``tensorboard`` package nothing is
        written."""
        if not (self.tensorboard and self.writer):
            return
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self.tensorboard = False  # tensorboard logging is optional
                return
            self._tb = SummaryWriter(self.log_dir)
        self._tb.add_scalar(tag, value, step)

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, epoch: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        profiler.export_chrome_trace(os.path.join(self.log_dir, f"trace-epoch={epoch}.json"))

    # ------------------------------------------------------------------
    # checkpointing (torch.save)
    # ------------------------------------------------------------------

    def _ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.log_dir, "checkpoints"))

    def _checkpoints(self) -> list[str]:
        """Names of the complete checkpoints, oldest first by the trailing
        step integer. A ``*.tmp`` left by a save that died before its rename
        is not a checkpoint."""
        if not os.path.isdir(self._ckpt_dir()):
            return []
        names = [c for c in os.listdir(self._ckpt_dir()) if not c.endswith(".tmp")]
        return sorted(names, key=lambda x: int(x.split("=")[-1]))

    def save_checkpoint(
        self, epoch: int, periodic: bool = False, epoch_step: Optional[int] = None
    ) -> str:
        """Save ``[periodic-]epoch=E-step=S``. ``periodic=True`` marks a
        rolling save: only the newest two periodic saves are kept.
        ``epoch_step`` records how many optimizer steps of ``epoch`` were
        already trained (mid-epoch saves set it; end-of-epoch saves do not).
        On a mesh every rank gathers the state and rank 0 writes it; the
        others wait for the file."""
        prefix = "periodic-" if periodic else ""
        path = os.path.join(self._ckpt_dir(), f"{prefix}epoch={epoch}-step={self.step}")
        ckpt = dict(self.state_dict(), epoch=int(epoch))
        if epoch_step is not None:
            ckpt["epoch_step"] = int(epoch_step)
        if self.writer:
            os.makedirs(self._ckpt_dir(), exist_ok=True)
            torch.save(ckpt, path + ".tmp")
            os.replace(path + ".tmp", path)
            if periodic:
                old = [c for c in self._checkpoints() if c.startswith("periodic-")]
                for name in old[:-2]:
                    os.remove(os.path.join(self._ckpt_dir(), name))
        if self.mesh is not None:
            dist.barrier()
        return path

    def load_checkpoint(self, path: Optional[str] = None) -> tuple[int, Optional[int]]:
        """Load the newest checkpoint (sorted by the trailing step integer)
        or an explicit path into this experiment. Returns ``(epoch,
        epoch_step)``: ``epoch_step`` is the number of optimizer steps
        already trained in ``epoch`` for a mid-epoch periodic save, ``None``
        for an end-of-epoch save."""
        if path is None:
            path = os.path.join(self._ckpt_dir(), self._checkpoints()[-1])
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        self.load_state_dict(ckpt)
        return int(ckpt["epoch"]), ckpt.get("epoch_step")

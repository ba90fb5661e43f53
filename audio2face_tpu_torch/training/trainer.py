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
``torch.profiler`` Chrome trace of that epoch's first steps. Not ported
yet: meshes, and the JAX trainer's orbax checkpoints (orbax imports JAX).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

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
        versions of every kernel."""
        if accumulate_grad_batches is None:
            accumulate_grad_batches = config.accumulate_grad_batches
        if accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1")
        if tuple(config.mesh_shape) not in ((-1, 1), (1, 1)) or config.fsdp:
            raise NotImplementedError(
                "the trainer takes one device: meshes and fsdp arrive with the "
                "parallel modules (ROADMAP.md queue 1 item 4)"
            )
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
        self.device = resolve_device(device, "Audio2FaceExperiment")
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

    def _new_optimizer(self) -> torch.optim.Adam:
        return torch.optim.Adam(
            self.model.parameters(), lr=self.config.lr, weight_decay=self.config.lr / 10.0)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Model, optimizer and step count, on the CPU (a copy)."""
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
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

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
        self.model.load_state_dict(state_dict)
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

    def _unpack(self, batch: dict):
        """x100 scaling + field split."""
        verts = batch["verts"].float() * 100.0
        template = batch["template_vert"].float() * 100.0
        return batch["audio"].float(), batch["one_hot"].float(), verts, template, batch.get("audio_lengths")

    def _apply(self, batch: dict, train: bool, generator=None):
        x, one_hot, verts, template, lengths = self._unpack(batch)
        if not self.is_faceformer:
            # the extractor's output comes detached (the reference detaches it)
            feats = x if self.feature_extractor is None else self.feature_extractor(x)
            return self.model(feats, one_hot, template, train=train), None, verts
        out = self.model(
            x, one_hot, template, lengths, train=train, generator=generator,
            use_kernels=self.use_kernels,
        )
        pred, frame_mask = out if lengths is not None else (out, None)
        return pred, frame_mask, verts

    def _compute_loss(self, pred, verts, frame_mask):
        if not self.is_faceformer:
            return self.loss_fn(pred, verts)
        gt = verts.reshape(pred.shape)
        if frame_mask is not None:
            return masked_faceformer_loss(pred, gt, frame_mask)
        return self.loss_fn(pred, gt)

    def _train_loss(self, batch: dict, generator: torch.Generator):
        """(loss dict, err) of one microbatch in train mode."""
        n_verts = self.config.vertex_count // 3
        if self.is_faceformer and "audio_lengths" in batch:
            # padded whole-clip training: decode to hidden states and run the
            # vertex head INSIDE the chunked loss; the (B, T, V, 3)
            # prediction never materializes, and its backward recomputes one
            # frame chunk at a time
            x, one_hot, verts_gt, template, lengths = self._unpack(batch)
            hs, fmask = self.model(
                x, one_hot, template, lengths, train=True, generator=generator,
                return_hidden=True, use_kernels=self.use_kernels,
            )
            head = self.model.vertice_map_r
            return chunked_faceformer_head_loss(
                hs, head.weight.T, head.bias, template,
                verts_gt.reshape(hs.shape[0], hs.shape[1], -1, 3), fmask, n_verts=n_verts,
            )
        pred, fmask, verts = self._apply(batch, train=True, generator=generator)
        return self._compute_loss(pred, verts, fmask), mse_error(pred, verts, n_verts, fmask)

    def accumulate_gradients(self, batch: dict) -> dict:
        """Leave the mean gradient of the batch's k microbatches in the
        parameters' ``.grad`` (k = ``accumulate_grad_batches``) and return
        the mean metrics. Microbatch i draws from the stream ``(seed, step,
        i)``; with k = 1 the stream is ``(seed, step)``."""
        k = self.accumulate_grad_batches
        batch = self._to_device(batch)
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
            loss, err = self._train_loss(mb, self._generator(*key))
            (loss["loss"] / k).backward()
            for name, value in dict(loss, err=err).items():
                totals[name] = totals.get(name, 0.0) + value.detach() / k
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
        pred, fmask, verts = self._apply(self._to_device(batch), train=False)
        loss = self._compute_loss(pred, verts, fmask)
        return dict(loss, err=mse_error(pred, verts, self.config.vertex_count // 3, fmask))

    @torch.no_grad()
    def predict(self, batch: dict):
        """Predicted vertices in data units (/100) plus the err metric
        against ground truth."""
        self.model.eval()
        pred, fmask, verts = self._apply(self._to_device(batch), train=False)
        return pred / 100.0, mse_error(pred, verts, self.config.vertex_count // 3, fmask)

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
        the interrupted epoch, skipping the batches already trained."""
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

        with open(metrics_path, "a") as logf:
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
                profiler = self._start_profiler() if epoch == profile_epoch else None
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
        if not self.tensorboard:
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
        already trained (mid-epoch saves set it; end-of-epoch saves do not)."""
        os.makedirs(self._ckpt_dir(), exist_ok=True)
        prefix = "periodic-" if periodic else ""
        path = os.path.join(self._ckpt_dir(), f"{prefix}epoch={epoch}-step={self.step}")
        ckpt = dict(self.state_dict(), epoch=int(epoch))
        if epoch_step is not None:
            ckpt["epoch_step"] = int(epoch_step)
        torch.save(ckpt, path + ".tmp")
        os.replace(path + ".tmp", path)
        if periodic:
            old = [c for c in self._checkpoints() if c.startswith("periodic-")]
            for name in old[:-2]:
                os.remove(os.path.join(self._ckpt_dir(), name))
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

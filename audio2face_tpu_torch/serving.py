"""Inference/serving API: bucketed, batched prediction.

Port of ``audio2face_tpu/serving.py``: ``FaceFormerPredictor`` and, for the
frame models (Audio2Mesh, VOCA, Song2Face), ``FramePredictor``, over one
request loop (``_BucketedPredictor``):

- clips are sorted by length and grouped up to ``max_batch``; each group is
  padded to an audio bucket (seconds rounded up to a grid) and to a batch
  size on the power-of-two grid; FaceFormer masks by per-item ``lengths``
  inside the model (exact: the fps adapter and group norm are length-aware);
- FaceFormer's vertex head runs per time chunk of at most 512 MB of output,
  so device memory stays bounded whatever the clip length;
- outputs are in data units: checkpoints are trained with the x100 vertex
  convention, so the predictor feeds ``template * 100`` and returns
  ``output / 100`` (``unit_scale``).

Each chunk's valid vertex rows go straight into the clips' results
(``_CopyOut``): on the card by DMA into pinned memory on a copy stream,
overlapping the next chunk's compute; padding rows and frames are never
copied.

While a span recording is open (``utils/spans.py``), each call records
``predict`` and, inside it, ``predict.upload`` (padding and uploads),
``predict.model`` (the model call; FaceFormer's holds ``predict.encode``,
its audio encoder, and ``predict.decode``, its decoder), ``predict.sync``
(FaceFormer's wait for the valid frame counts), ``predict.head``
(FaceFormer's vertex head),
``predict.copy`` (queueing each chunk's row copies and the host's waits for
them) and ``predict.unpack`` (the results' allocation), and counts
``frames_valid``, ``frames_computed``, ``vertex_bytes_copied``,
``vertex_bytes_returned``, ``vertex_bytes_pinned`` and
``host_alloc_misses``; ``FramePredictor`` also counts
``frame_graph_captures`` and ``frame_graph_replays`` (``_FrameGraph``),
and a WavLM encoder ``gated_bias_layers`` (its layers run with the gated
relative-position bias, one a layer each model call).

Both run on the card unless ``device="cpu"`` is asked for. Weights come
from a reference PyTorch/Lightning checkpoint (``from_torch_checkpoint``),
the port trainer's checkpoint (``from_checkpoint``), carried JAX variables,
a port state dict, or a seeded random init. ``dataset="biwi"`` serves
FaceFormer's BIWI mode (25 fps, period 25, 2-way cross softmax). The
decoder's width (64, or 128 as the published BIWI model has it) and the
audio encoder (wav2vec2-base, WavLM Large with its gated
relative-position bias, or the wav2vec2-Conformer with Transformer-XL
attention: ``models/wav2vec2.py config_from_state_dict``) are the weights'
own; a random init is 64 wide over wav2vec2-base. The JAX
trainer's orbax checkpoints are not read: orbax imports JAX.

``mesh=`` (``parallel.make_mesh``) serves on every rank of a mesh, each
rank running the same call: each batch is padded to a multiple of the
``data`` axis and every rank decodes its rows (``shard_map_data``), the
results gathered so that every rank returns them all.
``FaceFormerPredictor(sp_mesh=)`` instead shards each clip's wav2vec2
stack on time (``parallel/sequence.py``) and runs the decoder on the
gathered hidden states on every rank.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

import torch.nn.functional as F

from audio2face_tpu_torch.compat.jax_params import (
    faceformer_state_dict_from_jax,
    frame_model_state_dict_from_jax,
)
from audio2face_tpu_torch.models.faceformer import AUDIO_SR, FaceFormer
from audio2face_tpu_torch.models.wav2vec2 import config_from_state_dict
from audio2face_tpu_torch.ops import dsp
from audio2face_tpu_torch.ops.dsp import fragment_starts, resample
from audio2face_tpu_torch.utils import spans
from audio2face_tpu_torch.utils.device import resolve_device
from audio2face_tpu_torch.utils.shapes import round_up as _round_up


def _fit_max_batch(max_batch: int, n_data: int) -> int:
    """Largest batch cap <= max_batch that splits evenly over the mesh's
    data axis (each rank gets a whole share). Rounds down (the cap is a
    memory ceiling on long clips) and warns; a cap smaller than the data
    axis cannot be honoured at all (every sharded call pads to a multiple
    of the axis), so that raises."""
    if max_batch % n_data == 0:
        return max_batch
    if max_batch < n_data:
        raise ValueError(
            f"max_batch={max_batch} is smaller than the mesh data axis "
            f"({n_data}): every mesh-sharded call is padded to a multiple "
            f"of the axis, so the cap cannot be honored — raise max_batch "
            f"to >= {n_data} or serve on a smaller mesh"
        )
    new = (max_batch // n_data) * n_data
    warnings.warn(
        f"max_batch={max_batch} is not divisible by the "
        f"mesh data axis ({n_data}); rounding down to max_batch={new}",
        stacklevel=3,
    )
    return new


def _batch_grid(max_batch: int, n_data: int = 1) -> list[int]:
    """The batch-shape grid: powers of two, each rounded up to a whole
    multiple of the mesh data axis and capped at ``max_batch`` (itself a
    multiple of the axis after ``_fit_max_batch``), and ``max_batch``.
    Every grid size pads to itself, so ``warmup`` covers every shape a
    request can be padded to."""
    grid = set()
    p = 1
    while p < max_batch:
        grid.add(min(_round_up(p, n_data), max_batch))
        p *= 2
    grid.add(max_batch)
    return sorted(grid)


def _pad_batch(b: int, max_batch: int, n_data: int = 1) -> int:
    """Smallest grid batch size >= the request group's size ``b``."""
    for g in _batch_grid(max_batch, n_data):
        if g >= b:
            return g
    raise ValueError(f"group of {b} clips exceeds max_batch={max_batch}")


def _n_data(mesh) -> int:
    if mesh is None:
        return 1
    from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

    return axis_size(mesh, DATA_AXIS)


def _serving_device(device, mesh, what: str) -> torch.device:
    """The predictor's device: ``device``, or on a mesh this rank's."""
    if mesh is None:
        return resolve_device(device, what)
    from audio2face_tpu_torch.parallel.mesh import mesh_device

    return mesh_device(mesh, device, what)


def load_model(make, variables: Optional[dict], state_dict: Optional[dict], convert,
               seed: int, device: torch.device) -> torch.nn.Module:
    """The model ``make(state_dict)`` builds, in eval mode on ``device``,
    with its weights from ``variables`` (the JAX model's, as numpy arrays,
    through ``convert``), from ``state_dict`` (the port's), or, given
    neither, a random init from ``seed``; ``make`` gets None then."""
    if variables is not None and state_dict is not None:
        raise ValueError("pass variables= or state_dict=, not both")
    if variables is not None:
        state_dict = convert(variables)
    model = make(state_dict)
    if state_dict is None:
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return model.eval().to(device)


def _resampled(audios, sample_rate: int, target: int, device) -> list:
    """The clips at ``target`` Hz (the resampler runs on ``device``)."""
    if sample_rate == target:
        return list(audios)
    return [
        resample(torch.as_tensor(np.asarray(a, np.float32), device=device), sample_rate, target)
        .cpu().numpy()
        for a in audios
    ]


def _host_allocs() -> int:
    """Blocks PyTorch's caching host allocator has made so far
    (``cudaHostAlloc`` calls)."""
    return int(torch.cuda.host_memory_stats().get("num_host_alloc", 0))


class _CopyOut:
    """One call's output path: each chunk's valid vertex rows copied
    straight into the clips' result tensors, one copy a clip row.

    On the card the results are pinned, so each row copy is one DMA, and
    PyTorch's caching host allocator recycles a result's block once the
    caller drops it. A chunk's copies run on a copy stream after the
    chunk's compute (an event) while the host launches the next chunk;
    after queueing them the host waits for the chunk before, so at most two
    chunks are alive on the device. ``finish`` waits for the last. On the
    CPU the same copies run at once into plain tensors."""

    def __init__(self, device: torch.device):
        # a copy stream from PyTorch's pool; None on the CPU
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.copied: list = []  # events of the chunks whose copies may run
        self.allocs = _host_allocs() if self.stream is not None else 0

    def results(self, frames: Sequence[int], n_verts: int) -> list:
        """Empty (frames[j], V, 3) f32 results, pinned on the card."""
        with spans.span("predict.unpack"):
            return [torch.empty((n, n_verts // 3, 3), dtype=torch.float32,
                                pin_memory=self.stream is not None) for n in frames]

    def send(self, out: torch.Tensor, off: int, lo: int, dsts: Sequence[torch.Tensor],
             frames: Sequence[int]) -> None:
        """Copy frames ``lo ..`` of clip ``j`` (``frames[j]`` frames) from row
        ``j`` of ``out``, whose column ``off`` holds frame ``lo``, into
        ``dsts[j]``. The caller may drop ``out`` when this returns."""
        stream = self.stream
        rows = 0
        with spans.span("predict.copy"):
            if stream is not None:
                computed = torch.cuda.Event()
                computed.record(torch.cuda.current_stream(out.device))
                stream.wait_event(computed)
            with torch.cuda.stream(stream):  # a no-op for None
                for j, dst in enumerate(dsts):
                    m = min(frames[j], lo + out.shape[1] - off) - lo
                    if m > 0:
                        dst[lo : lo + m].copy_(out[j, off : off + m], non_blocking=True)
                        rows += m
            if stream is not None:
                out.record_stream(stream)  # its block waits for the copies
                done = torch.cuda.Event()
                done.record(stream)
                self.copied.append(done)
                if len(self.copied) > 1:
                    self.copied.pop(0).synchronize()
        nbytes = rows * out[0, 0].numel() * out.element_size()
        spans.count("vertex_bytes_copied", nbytes)
        spans.count("vertex_bytes_returned", nbytes)
        spans.count("vertex_bytes_pinned", nbytes if stream is not None else 0)

    def finish(self, results: list) -> list:
        """``results`` as numpy arrays, once every copy has landed."""
        if self.copied:
            with spans.span("predict.copy"):
                self.copied[-1].synchronize()  # one stream: the last lands last
            self.copied.clear()
        misses = _host_allocs() - self.allocs if self.stream is not None else 0
        spans.count("host_alloc_misses", misses)
        return [r.numpy() for r in results]


class _BucketedPredictor:
    """The offline request loop of both predictors: the clips sorted by
    length and cut into groups of ``max_batch``, each group padded to its
    audio bucket and to the batch grid (``_pad_group``) and run by the
    predictor's ``_run_group``, every result copied out by one
    ``_CopyOut``. A predictor sets ``device``, ``mesh``, ``sample_rate``,
    ``max_batch``, ``bucket_samples``, ``n_verts``, ``n_onehot`` and
    ``fps``."""

    def __call__(
        self,
        audios: Sequence[np.ndarray],
        one_hot: np.ndarray,
        template: np.ndarray,
        sample_rate: Optional[int] = None,
    ) -> list[np.ndarray]:
        """Decode a batch of clips.

        audios: 1-D float waveforms (any lengths) at ``sample_rate`` (default:
        the predictor's own rate; other rates are resampled); one_hot: (N,
        n_onehot); template: (N, V, 3) or (V, 3) shared. Returns per-clip
        (T_i, V, 3) vertex animations at ``self.fps`` in data units."""
        n = len(audios)
        if one_hot.shape[0] != n:
            raise ValueError(f"one_hot batch {one_hot.shape[0]} != {n} clips")
        if template.ndim == 2:
            template = np.broadcast_to(template[None], (n, *template.shape))
        with spans.span("predict"):
            if sample_rate is not None:
                audios = _resampled(audios, sample_rate, self.sample_rate, self.device)
            copy_out = _CopyOut(self.device)
            results: list[Optional[torch.Tensor]] = [None] * n
            order = sorted(range(n), key=lambda i: len(audios[i]))
            for lo in range(0, n, self.max_batch):
                idx = order[lo : lo + self.max_batch]
                self._run_group([audios[i] for i in idx], idx, one_hot, template, results,
                                copy_out)
            return copy_out.finish(results)

    def _pad_group(self, group: Sequence[np.ndarray], one_hot: np.ndarray,
                   template: np.ndarray) -> tuple:
        """A group's host inputs: the clips zero-padded to their audio bucket
        and every row to the batch grid's size ``b_pad``: audio (b_pad,
        samples) f32, lengths (b_pad,) int64, one_hot (b_pad, n) and
        template (b_pad, V, 3) f32 from the group's rows."""
        b = len(group)
        samples = _round_up(max(max(len(a) for a in group), self.bucket_samples),
                            self.bucket_samples)
        b_pad = _pad_batch(b, self.max_batch, _n_data(self.mesh))
        audio = np.zeros((b_pad, samples), np.float32)
        # dummy rows (batch-grid and mesh padding) get a short valid length:
        # 800 samples decode 3 FaceFormer frames each (BIWI: 1), discarded
        lengths = np.full((b_pad,), min(800, samples), np.int64)
        for j, a in enumerate(group):
            audio[j, : len(a)] = a
            lengths[j] = len(a)
        oh = np.zeros((b_pad, one_hot.shape[1]), np.float32)
        tmpl = np.zeros((b_pad,) + template.shape[1:], np.float32)
        oh[:b] = one_hot
        tmpl[:b] = template
        return audio, lengths, oh, tmpl

    def warmup(self, max_seconds: float = 60.0, *, batches: Optional[Sequence[int]] = None) -> int:
        """Run every (batch, bucket) shape a deployment will hit once on zero
        audio: builds the kernels and warms the library kernels' caches
        before live traffic. ``batches=None`` covers the full batch grid.
        Returns the number of warm calls made."""
        if batches is None:
            batches = _batch_grid(self.max_batch, _n_data(self.mesh))
        bucket = self.bucket_samples
        n_buckets = max(1, -(-int(max_seconds * self.sample_rate) // bucket))
        template = np.zeros((self.n_verts // 3, 3), np.float32)
        for b in batches:
            for k in range(1, n_buckets + 1):
                audios = [np.zeros(k * bucket, np.float32)] * b
                self(audios, np.zeros((b, self.n_onehot), np.float32), template)
        return len(batches) * n_buckets


class FaceFormerPredictor(_BucketedPredictor):
    """Batched speech -> vertex-animation inference for FaceFormer."""

    # device-memory budget for one (B, chunk, V, 3) f32 vertex-head output
    _VERTEX_CHUNK_BYTES = 512 * 1024 * 1024

    def __init__(
        self,
        n_verts: int = 15069,
        n_onehot: int = 12,
        variables: Optional[dict] = None,
        *,
        state_dict: Optional[dict] = None,
        bf16: bool = True,
        max_batch: int = 8,
        bucket_seconds: float = 5.0,
        seed: int = 0,
        unit_scale: float = 100.0,
        dataset: str = "vocaset",
        device="cuda",
        use_kernels: bool = True,
        mesh=None,
        sp_mesh=None,
    ):
        """``variables``: the JAX FaceFormer's ``{"params": ...}`` as numpy
        arrays; ``state_dict``: the port's own; neither: random init from
        ``seed``; the decoder is as wide as the weights'
        ``audio_feature_map`` outputs, 64 for a random init.
        ``use_kernels=False`` runs the plain PyTorch versions of
        every kernel (a reference run on the card). ``mesh``: data-parallel
        clip batches over the mesh's ``data`` axis (``max_batch`` rounded
        down to a multiple of it); ``sp_mesh``: each clip's encoder stack
        time-sharded over its ``data`` axis; the two exclude each other.
        On a mesh the first rank's weights serve on every rank."""
        if mesh is not None and sp_mesh is not None:
            raise ValueError(
                "mesh= (data-parallel clip batches) and sp_mesh= "
                "(time-sharded encoder) are mutually exclusive"
            )
        self.mesh, self.sp_mesh = mesh, sp_mesh
        self.device = _serving_device(device, mesh or sp_mesh, "FaceFormerPredictor")
        self.dataset = dataset
        # animation clock of the returned (T, V, 3) tracks: VOCASET animates
        # at 60 fps, BIWI at 25
        self.fps = 25 if dataset == "biwi" else 60
        self.sample_rate = AUDIO_SR
        self.n_onehot = n_onehot
        self.n_verts = n_verts
        self.max_batch = max_batch if mesh is None else _fit_max_batch(max_batch, _n_data(mesh))
        self.unit_scale = float(unit_scale)
        self.bucket_samples = int(bucket_seconds * AUDIO_SR)
        self.use_kernels = use_kernels

        def make(state_dict):
            if state_dict is not None:
                # BIWI weights served as vocaset would run frames at the wrong
                # clock and replace the trained 2-way softmax with the diagonal
                # cross attention, so the mismatch is an error either way
                has_cross = "cross_q.weight" in state_dict
                if has_cross != (dataset == "biwi"):
                    want = "biwi" if has_cross else "vocaset"
                    raise ValueError(
                        f"the weights are a dataset={want!r} FaceFormer (cross_q/cross_k "
                        f"{'present' if has_cross else 'absent'}) but the predictor was "
                        f"built with dataset={dataset!r}: pass dataset={want!r}"
                    )
            return FaceFormer(
                n_verts=n_verts, n_onehot=n_onehot,
                dtype=torch.bfloat16 if bf16 else None,
                # BIWI animates at 25 fps; the upstream FaceFormer uses the frame
                # rate as the PPE/ALiBi period (matches the trainer's model)
                **({"dataset": "biwi", "period": 25} if dataset == "biwi" else {}),
                **({} if state_dict is None
                   else {"feature_dim": state_dict["audio_feature_map.weight"].shape[0],
                         "encoder_config": config_from_state_dict(state_dict, "audio_encoder.")}),
            )

        self.model = load_model(make, variables, state_dict,
                                lambda v: faceformer_state_dict_from_jax(v["params"]), seed,
                                self.device)
        enc = self.model.audio_encoder.config
        if (mesh is not None or sp_mesh is not None) and (enc.wavlm or enc.conformer):
            raise ValueError(
                "mesh= and sp_mesh= serve the wav2vec2-base encoder; these weights hold a "
                f"{'WavLM' if enc.wavlm else 'Conformer'} encoder (relative positions): serve "
                "them on one device")
        if mesh is not None or sp_mesh is not None:
            from audio2face_tpu_torch.parallel.mesh import replicate

            replicate(mesh or sp_mesh, self.model)
        self._hidden_fn = self._hidden
        if mesh is not None:
            from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, shard_map_data

            # each rank decodes its rows (kernels included); the hidden
            # states and masks are gathered (the vertex head runs on all)
            d = (DATA_AXIS,)
            self._hidden_fn = shard_map_data(mesh, self._hidden, in_specs=(d, d, d),
                                             out_specs=(d, d))

    @classmethod
    def from_torch_checkpoint(cls, path: str, **kwargs) -> "FaceFormerPredictor":
        """Load a reference PyTorch/Lightning checkpoint. Pass
        ``dataset="biwi"`` for BIWI-trained weights: the converter then also
        carries the live cross-attention q/k projections."""
        from audio2face_tpu_torch.compat.faceformer_convert import convert_faceformer
        from audio2face_tpu_torch.compat.torch_convert import load_torch_checkpoint

        state_dict = convert_faceformer(
            load_torch_checkpoint(path), dataset=kwargs.get("dataset", "vocaset"))
        return cls(state_dict=state_dict, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, **kwargs) -> "FaceFormerPredictor":
        """Load a checkpoint written by the port's trainer
        (``Audio2FaceExperiment.save_checkpoint``). The dataset family is
        detected from the weights: BIWI checkpoints carry the live
        ``cross_q``/``cross_k`` projections, vocaset's have none."""
        state_dict = torch.load(path, map_location="cpu", weights_only=True)["model"]
        kwargs.setdefault("dataset", "biwi" if "cross_q.weight" in state_dict else "vocaset")
        return cls(state_dict=state_dict, **kwargs)

    @torch.inference_mode()
    def _hidden(self, audio, one_hot, lengths):
        encoder_hidden = None
        if self.sp_mesh is not None:
            # sequence parallelism: the wav2vec2 stack time-sharded over the
            # mesh, gathered, and the decoder (its kernel included) run on
            # the whole hidden states on every rank
            from audio2face_tpu_torch.models.faceformer import frame_count, normalize_waveform
            from audio2face_tpu_torch.parallel.sequence import sequence_parallel_encode

            encoder = self.model.audio_encoder
            encoder_hidden = sequence_parallel_encode(
                encoder, normalize_waveform(audio, lengths), self.sp_mesh,
                output_len=frame_count(audio.shape[1], self.fps), lengths=lengths,
                # BIWI keeps the 50 fps latents (their valid counts come from
                # the conv stack); vocaset's interpolation takes frame counts
                output_lengths=None if self.dataset == "biwi" else frame_count(lengths, self.fps),
                config=encoder.config, dtype=self.model.dtype or torch.float32,
                use_kernels=self.use_kernels, gather_output=True, dataset=self.dataset,
            )
        return self.model(
            audio, one_hot, None, lengths, return_hidden=True, use_kernels=self.use_kernels,
            encoder_hidden=encoder_hidden,
        )

    @torch.inference_mode()
    def _vertex_chunk(self, hs: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
        """FaceFormer.vertex_head on a time slice, with the x100-in /
        /100-out unit convention."""
        scale = self.unit_scale
        return self.model.vertex_head(hs, template * scale) / scale

    def _emit_vertices(self, hs, tmpl, idx, n_valid, results, copy_out):
        """Apply the vertex head per time chunk and send each chunk's valid
        rows into its clips' results; the tail window is realigned, not
        shortened, and its frames before ``lo`` are not copied again."""
        b_pad, t, _ = hs.shape
        frames = [int(n) for n in n_valid[: len(idx)]]
        dsts = copy_out.results(frames, self.n_verts)
        for j, i in enumerate(idx):
            results[i] = dsts[j]
        t_need = int(n_valid.max()) if len(n_valid) else 0
        width = min(t, max(1, self._VERTEX_CHUNK_BYTES // (b_pad * self.n_verts * 4)))
        for lo in range(0, t_need, width):
            start = min(lo, t - width)
            with spans.span("predict.head"):
                out = self._vertex_chunk(hs[:, start : start + width], tmpl)
            copy_out.send(out, lo - start, lo, dsts, frames)
            del out  # its block is reused once its copies are done

    def _run_group(self, group, idx, one_hot, template, results, copy_out) -> None:
        """One group of clips (rows ``idx`` of the request): the model call
        to hidden states, the valid frame counts, and the vertex head into
        the clips' results."""
        with spans.span("predict.upload"):
            audio, lengths, oh, tmpl = self._pad_group(group, one_hot[idx], template[idx])
            inputs = [torch.as_tensor(x, device=self.device) for x in (audio, oh, lengths)]
        with spans.span("predict.model"):
            hs, mask = self._hidden_fn(*inputs)
        del inputs  # freed before the vertex head runs
        with spans.span("predict.sync"):
            # the host waits here for the model's device work
            n_valid = mask.sum(dim=1).cpu().numpy().astype(int)
        spans.count("frames_valid", int(n_valid[: len(group)].sum()))
        spans.count("frames_computed", len(audio) * hs.shape[1])
        with spans.span("predict.upload"):
            tmpl_d = torch.as_tensor(tmpl, device=self.device)
        self._emit_vertices(hs, tmpl_d, idx, n_valid, results, copy_out)

    def realtime_factor(self, seconds: float = 60.0, batch: Optional[int] = None) -> float:
        """Measured decode throughput in multiples of real time (one warm
        call, then one timed call; the result is on the host when it ends)."""
        batch = batch or self.max_batch
        rng = np.random.default_rng(0)
        audios = [rng.normal(size=int(seconds * AUDIO_SR)).astype(np.float32) * 0.1] * batch
        one_hot = np.eye(self.n_onehot, dtype=np.float32)[rng.integers(0, self.n_onehot, batch)]
        template = rng.normal(size=(self.n_verts // 3, 3)).astype(np.float32)
        self(audios, one_hot, template)
        tic = time.perf_counter()
        self(audios, one_hot, template)
        wall = time.perf_counter() - tic
        return batch * seconds / wall


# the frame models' clock and per-frame window (data/vocaset.py: 60 fps,
# 0.52 s windows centred on each frame)
FPS = 60
FRAGMENT_SECONDS = 0.52


class _FrameGraph:
    """A frame model's eval forward at one features shape, captured as a
    CUDA graph: a call copies the features, the one-hot rows and the
    template rows into the graph's static inputs and replays the graph,
    which writes the model's (rows, V, 3) f32 vertices into its static
    output.

    The capture follows an eager forward at the same shape, so cuDNN and
    cuBLAS have chosen their algorithms. Kernel wrappers count the launches
    they record into the capture (``frame_epilogue.launches``,
    ``conv_epilogues_fused``) and nothing at a replay; a replay counts
    itself in ``frame_graph_replays``. The graph reads the model's weights
    and the device constants it was handed (``dsp.held_constants``, kept
    here) by address."""

    def __init__(self, model: torch.nn.Module, feats: torch.Tensor, one_hot: torch.Tensor,
                 template: torch.Tensor):
        self.inputs = (feats.clone(), one_hot.clone(), template.clone())
        self.graph = torch.cuda.CUDAGraph()
        with dsp.held_constants() as self.constants, torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.out = model(*self.inputs, train=False)
        spans.count("frame_graph_captures", 1)

    def __call__(self, feats: torch.Tensor, one_hot: torch.Tensor,
                 template: torch.Tensor) -> torch.Tensor:
        """The model's vertices of these rows: the static output, which the
        next call overwrites."""
        for static, x in zip(self.inputs, (feats, one_hot, template)):
            static.copy_(x)
        self.graph.replay()
        spans.count("frame_graph_replays", 1)
        return self.out


class FramePredictor(_BucketedPredictor):
    """Batched speech -> per-frame vertex inference for the frame models
    (audio2mesh, voca, song2face: every registry model except faceformer).

    - each clip is uploaded once; the 0.52 s per-frame windows (the
      dataset's fragmenter, shift 0) are gathered on the device, one chunk
      of ``frame_batch`` frames per clip at a time, with overflow-safe
      window starts and frames past a clip's end clamped into its pad;
    - MFCC or wav2vec2 features are extracted on the device inside each
      chunk's forward;
    - shapes follow the FaceFormer predictor: audio buckets on a
      ``bucket_seconds`` grid, batches padded to the power-of-two grid;
    - units: checkpoints train against x100 vertices, so templates feed
      ``* 100`` and outputs return ``/ 100`` (``unit_scale``);
    - each chunk is copied to the host as it is done;
    - on the card, off a mesh, ``warmup`` captures the model's forward at
      each row count it runs as a CUDA graph (``_FrameGraph``), and every
      later offline chunk of that row count replays it: the features and
      the unit division stay eager around the replay, and the chunk's
      constants are on the device, so the host never waits inside a chunk.
      A predictor that was not warmed (the live pool's), a mesh and every
      other row count run eagerly.

    Weights: ``variables`` (the JAX model's ``{"params", "batch_stats"}``
    as numpy arrays), ``state_dict`` (the port's), or a random init from
    ``seed``. The model computes in bf16 when the config asks for
    "16-mixed", with BatchNorm in eval mode. ``mesh``: each rank runs its
    share of the clips of each chunk (``max_batch`` rounded down to a
    multiple of the ``data`` axis) and the chunks are gathered."""

    def __init__(
        self,
        config,
        variables: Optional[dict] = None,
        *,
        state_dict: Optional[dict] = None,
        max_batch: int = 8,
        frame_batch: int = 128,
        bucket_seconds: float = 5.0,
        seed: int = 0,
        unit_scale: float = 100.0,
        mesh=None,
        device="cuda",
    ):
        from audio2face_tpu_torch.registry import get_extractor, get_model

        if config.modelname == "faceformer":
            raise ValueError("use FaceFormerPredictor for faceformer")
        self.mesh = mesh
        self.device = _serving_device(device, mesh, "FramePredictor")
        self.config = config
        self.fps = FPS
        self.sample_rate = config.sample_rate
        self.n_verts = config.vertex_count
        self.n_onehot = config.one_hot_size
        self.max_batch = max_batch if mesh is None else _fit_max_batch(max_batch, _n_data(mesh))
        self.frame_batch = frame_batch
        self.unit_scale = float(unit_scale)
        self.bucket_samples = int(bucket_seconds * config.sample_rate)
        self.n_pad = int(config.sample_rate * FRAGMENT_SECONDS / 2)
        self.window = 2 * self.n_pad

        dtype = torch.bfloat16 if config.bf16_compute else None
        self.model = load_model(
            lambda _: get_model(config.modelname)(
                n_verts=config.vertex_count, n_onehot=config.one_hot_size, dtype=dtype),
            variables, state_dict,
            lambda v: frame_model_state_dict_from_jax(config.modelname, v), seed, self.device)
        self.extractor = get_extractor(config.feature_extractor)(
            sample_rate=config.sample_rate, n_feature=config.n_feature, out_dim=config.out_dim,
            win_length=config.win_length, hop_length=config.hop_length, n_fft=1024,
        ).to(self.device)
        self._graphs: dict = {}  # {features' shape: _FrameGraph}
        self._capture = False  # set by warmup: a new shape's chunk captures
        self._chunk_fn = self.forward_chunk
        if mesh is not None:
            from audio2face_tpu_torch.parallel.mesh import DATA_AXIS, replicate, shard_map_data

            replicate(mesh, self.model)
            if isinstance(self.extractor, torch.nn.Module):
                replicate(mesh, self.extractor)
            # the clips' rows (a clip's frame rows are contiguous) on each
            # rank; the frame offset whole
            d = (DATA_AXIS,)
            self._chunk_fn = shard_map_data(mesh, self.forward_chunk, in_specs=(d, d, d, ()),
                                            out_specs=d)

    @classmethod
    def from_torch_checkpoint(cls, path: str, config, **kwargs) -> "FramePredictor":
        """Load a reference PyTorch/Lightning checkpoint for this model."""
        from audio2face_tpu_torch.compat.torch_convert import (
            convert_state_dict,
            load_torch_checkpoint,
        )

        state_dict = convert_state_dict(config.modelname, load_torch_checkpoint(path))
        return cls(config, state_dict=state_dict, **kwargs)

    @classmethod
    def from_checkpoint(cls, path: str, config, **kwargs) -> "FramePredictor":
        """Load a checkpoint written by the port's trainer
        (``Audio2FaceExperiment.save_checkpoint``): weights and BatchNorm
        running statistics."""
        state_dict = torch.load(path, map_location="cpu", weights_only=True)["model"]
        return cls(config, state_dict=state_dict, **kwargs)

    @torch.inference_mode()
    def forward_chunk(self, padded: torch.Tensor, one_hot: torch.Tensor,
                      template: torch.Tensor, frame0: int) -> torch.Tensor:
        """Vertices of frames ``frame0 .. frame0 + frame_batch - 1`` of every
        clip, (B, frame_batch, V, 3) f32 in data units, on the device.

        ``padded``: (B, n_pad + samples + window) clips with ``n_pad`` zeros
        before and a window of zeros after; ``one_hot``, ``template``: the
        clips' ``style_rows``. Off a mesh, the model runs as a replay where
        ``warmup`` captured a graph (``frame_vertices``)."""
        b = padded.shape[0]
        fb = self.frame_batch
        f = frame0 + torch.arange(fb, device=padded.device)
        starts = fragment_starts(f, self.fps, self.sample_rate)
        idx = starts[:, None] + torch.arange(self.window, device=padded.device)[None, :]
        frags = padded[:, idx.clamp(max=padded.shape[1] - 1)].reshape(b * fb, self.window)
        return self.frame_vertices(frags, one_hot, template)

    @torch.inference_mode()
    def frame_vertices(self, frags: torch.Tensor, one_hot: torch.Tensor,
                       template: torch.Tensor) -> torch.Tensor:
        """The frame step: (B * frame_batch, window) audio fragments, each
        clip's ``frame_batch`` rows together, to (B, frame_batch, V, 3) f32
        vertices in data units (features, the model in eval, the unit
        division). ``one_hot``, ``template``: the clips' ``style_rows``.

        The model replays the graph that ``warmup`` captured at the
        features' shape, if any; inside ``warmup`` on the card, off a mesh,
        a shape with none runs eagerly and then captures one. The unit
        division makes each answer a new tensor, so a replay never
        overwrites one that is still being copied out."""
        feats = self.extractor(frags)
        graph = self._graphs.get(feats.shape)
        if graph is not None:
            out = graph(feats, one_hot, template)
        else:
            out = self.model(feats, one_hot, template, train=False)
            if self._capture and feats.is_cuda:
                self._graphs[feats.shape] = _FrameGraph(self.model, feats, one_hot, template)
        return out.reshape(-1, self.frame_batch, self.n_verts // 3, 3) / self.unit_scale

    def warmup(self, max_seconds: float = 60.0, *, batches: Optional[Sequence[int]] = None) -> int:
        """``_BucketedPredictor.warmup``; on the card, off a mesh, the first
        chunk of each row count also captures its ``_FrameGraph``. Only
        warmup captures, so no request pays for a capture."""
        self._capture = self.mesh is None
        try:
            return super().warmup(max_seconds, batches=batches)
        finally:
            self._capture = False

    def style_rows(self, one_hot, template) -> tuple:
        """(B, n) one-hots and (B, V, 3) templates, on the host or the device,
        as the frame step's (B * frame_batch, ...) rows on the device, the
        templates scaled by ``unit_scale``."""
        dev, fb = self.device, self.frame_batch
        oh = torch.as_tensor(one_hot, device=dev).repeat_interleave(fb, dim=0)
        tmpl = (torch.as_tensor(template, device=dev) * self.unit_scale).repeat_interleave(fb, dim=0)
        return oh, tmpl

    def prepare(self, group: Sequence[np.ndarray], one_hot: np.ndarray,
                template: np.ndarray) -> tuple:
        """One group's device inputs: the clips padded to their audio bucket
        and the batch grid (``_pad_group``), uploaded once, and their
        ``style_rows``: ``forward_chunk``'s arguments but the frame."""
        audio, _, oh, tmpl = self._pad_group(group, one_hot, template)
        padded = F.pad(torch.as_tensor(audio, device=self.device), (self.n_pad, self.window))
        return (padded, *self.style_rows(oh, tmpl))

    def _run_group(self, group, idx, one_hot, template, results, copy_out) -> None:
        """One group of clips (rows ``idx`` of the request): its results,
        its device inputs, then each chunk of ``frame_batch`` frames through
        ``_chunk_fn`` and its valid rows into the results."""
        n_frames = [len(a) * self.fps // self.sample_rate for a in group]
        dsts = copy_out.results(n_frames, self.n_verts)
        for j, i in enumerate(idx):
            results[i] = dsts[j]
        with spans.span("predict.upload"):
            inputs = self.prepare(group, one_hot[idx], template[idx])
        spans.count("frames_valid", sum(n_frames))
        for f0 in range(0, max(n_frames), self.frame_batch):
            with spans.span("predict.model"):
                out = self._chunk_fn(*inputs, f0)
            spans.count("frames_computed", out.shape[0] * out.shape[1])
            copy_out.send(out, 0, f0, dsts, n_frames)
            del out  # its block is reused once its copies are done

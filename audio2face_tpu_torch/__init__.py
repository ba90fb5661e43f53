"""audio2face_tpu_torch: the PyTorch/CUDA port of audio2face_tpu.

FaceFormer (wav2vec2-base encoder, autoregressive d=64 decoder, vertex head)
and the frame models (Audio2Mesh, VOCA, Song2Face, on MFCC or wav2vec2
features) on an NVIDIA H100. Serving:
``audio2face_tpu_torch.serving.FaceFormerPredictor`` and ``FramePredictor``;
training: ``audio2face_tpu_torch.training.trainer.Audio2FaceExperiment``
on ``data/vocaset.py`` and ``data/biwi.py`` batches, uploaded by
``runtime.Prefetcher``; evaluation (LVE, FDD, MVE, max-L2):
``evaluation`` and the trainer's ``evaluate``; live serving: ``streaming``,
``multistream``, ``frame_stream``, and the ``serving_queue``,
``http_server`` and ``live_server`` front ends; reference PyTorch
checkpoints load through ``compat/``, and ``compat/torch_export.py`` writes
the port's weights back under the reference's names. Command lines
(``python -m audio2face_tpu_torch.cli.<name>``): ``train``, ``evaluate``,
``export``, ``serve``, ``infer``, ``render_offline`` and ``render_frames``.
Parallelism on ``torch.distributed`` (``parallel/``): data, Megatron tensor,
FSDP (ZeRO-3), sequence and pipeline parallelism, one process a device,
through ``make_mesh`` and the ``mesh=`` arguments of the trainer and every
predictor (``sp_mesh=`` for a time-sharded encoder); ``dryrun_multichip``
exercises them all. Hand-written CUDA kernels carry the hot paths: flash attention forward with
in-kernel dropout and its two backward kernels (``ops/attention.py``), the
wav2vec2 conv feature encoder (``ops/conv_encoder.py``), the whole decode
loop (``ops/decode_kernel.py``) and the tile rasterizer
(``ops/rasterizer.py``). They build from ``csrc/`` at first launch;
importing the package builds nothing. On CPU tensors every kernel wrapper
runs its plain PyTorch version.
"""

__version__ = "0.3.0"  # kept in sync with pyproject.toml

from audio2face_tpu_torch.config import ExpConfig
from audio2face_tpu_torch.registry import get_extractor, get_loss_fn, get_model

__all__ = ["ExpConfig", "get_model", "get_extractor", "get_loss_fn", "__version__"]


def __getattr__(name):
    # lazy: streaming and serving pull in the full model stack
    if name == "StreamingFaceFormerPredictor":
        from audio2face_tpu_torch.streaming import StreamingFaceFormerPredictor

        return StreamingFaceFormerPredictor
    if name in ("MultiStreamFaceFormerPredictor", "StreamingServer"):
        from audio2face_tpu_torch import multistream

        return getattr(multistream, name)
    if name in ("FaceFormerPredictor", "FramePredictor"):
        from audio2face_tpu_torch import serving

        return getattr(serving, name)
    if name == "FrameStreamPool":
        from audio2face_tpu_torch.frame_stream import FrameStreamPool

        return FrameStreamPool
    if name == "BatchingServer":
        from audio2face_tpu_torch.serving_queue import BatchingServer

        return BatchingServer
    if name == "ServingDaemon":
        from audio2face_tpu_torch.http_server import ServingDaemon

        return ServingDaemon
    if name in ("LiveStreamingDaemon", "LiveClient"):
        from audio2face_tpu_torch import live_server

        return getattr(live_server, name)
    if name in ("VertexRegions", "evaluate_animation", "infer_regions"):
        from audio2face_tpu_torch import evaluation

        return getattr(evaluation, name)
    if name == "BiwiDataModule":
        from audio2face_tpu_torch.data.biwi import BiwiDataModule

        return BiwiDataModule
    if name == "make_mesh":
        from audio2face_tpu_torch.parallel import make_mesh

        return make_mesh
    if name == "dryrun_multichip":
        from audio2face_tpu_torch.parallel.dryrun import dryrun_multichip

        return dryrun_multichip
    raise AttributeError(name)

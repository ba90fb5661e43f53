"""audio2face_tpu_torch: the PyTorch/CUDA port of audio2face_tpu.

FaceFormer (wav2vec2-base encoder, autoregressive d=64 decoder, vertex head)
and the frame models (Audio2Mesh, VOCA, Song2Face, on MFCC or wav2vec2
features) on an NVIDIA H100. Serving:
``audio2face_tpu_torch.serving.FaceFormerPredictor`` and ``FramePredictor``;
training: ``audio2face_tpu_torch.training.trainer.Audio2FaceExperiment``
on ``data/vocaset.py`` and ``data/biwi.py`` batches, uploaded by
``runtime.Prefetcher``; live serving: ``streaming``, ``multistream``,
``frame_stream``, and the ``serving_queue``, ``http_server`` and
``live_server`` front ends; reference PyTorch checkpoints load through
``compat/``. Hand-written CUDA
kernels carry the hot paths: flash attention forward with in-kernel dropout
and its two backward kernels (``ops/attention.py``), the wav2vec2 conv
feature encoder (``ops/conv_encoder.py``), the whole decode loop
(``ops/decode_kernel.py``) and the tile rasterizer (``ops/rasterizer.py``).
They build from ``csrc/`` at first launch; importing the package builds
nothing. On CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

"""Model / feature-extractor / loss registries.

Port of ``audio2face_tpu/registry.py``: the four models and both feature
extractors. Imports are lazy so that importing the package does not pull
every model.
"""

from __future__ import annotations

from typing import Callable, Optional

from audio2face_tpu_torch.losses import FaceFormerLoss, VocaLoss


def get_model(modelname: str):
    """The model class for ``modelname``; all models share the constructor
    ``Model(n_verts, n_onehot, dtype)``."""
    if modelname == "faceformer":
        from audio2face_tpu_torch.models.faceformer import FaceFormer

        return FaceFormer
    if modelname == "audio2mesh":
        from audio2face_tpu_torch.models.audio2mesh import Audio2Mesh

        return Audio2Mesh
    if modelname == "voca":
        from audio2face_tpu_torch.models.voca import Voca

        return Voca
    if modelname == "song2face":
        from audio2face_tpu_torch.models.song2face import Song2Face

        return Song2Face
    raise KeyError(
        f"Unknown model {modelname!r}; available: voca, audio2mesh, song2face, faceformer"
    )


def get_extractor(extractor: Optional[str]) -> Callable:
    """The feature-extractor factory. ``None`` -> a factory returning
    ``None``, so that raw audio flows straight to the model."""
    if extractor is None:
        return lambda *args, **kwargs: None
    if extractor == "mfcc":
        from audio2face_tpu_torch.models.extractor import MFCCExtractor

        return MFCCExtractor
    if extractor == "wav2vec":
        from audio2face_tpu_torch.models.extractor import Wav2VecExtractor

        return Wav2VecExtractor
    raise KeyError(f"Unknown extractor {extractor!r}; available: mfcc, wav2vec, None")


def get_loss_fn(modelname: str):
    """Loss selection by model family."""
    if modelname == "faceformer":
        return FaceFormerLoss()
    return VocaLoss()

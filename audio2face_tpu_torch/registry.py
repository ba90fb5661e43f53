"""Model / feature-extractor / loss registries.

Port of ``audio2face_tpu/registry.py``. Only FaceFormer is ported so far:
the frame models and the standalone feature extractors raise
``NotImplementedError`` until they are ported (``ROADMAP.md`` queue 1 item 7).
Imports are lazy so that importing the package does not pull every model.
"""

from __future__ import annotations

from typing import Callable, Optional

from audio2face_tpu_torch.losses import FaceFormerLoss, VocaLoss

_NOT_PORTED = "is not ported yet (ROADMAP.md queue 1 item 7: frame models and extractors)"


def get_model(modelname: str):
    """The model class for ``modelname``; all models share the constructor
    ``Model(n_verts, n_onehot)``."""
    if modelname == "faceformer":
        from audio2face_tpu_torch.models.faceformer import FaceFormer

        return FaceFormer
    if modelname in ("voca", "audio2mesh", "song2face"):
        raise NotImplementedError(f"model {modelname!r} {_NOT_PORTED}")
    raise KeyError(
        f"Unknown model {modelname!r}; available: voca, audio2mesh, song2face, faceformer"
    )


def get_extractor(extractor: Optional[str]) -> Callable:
    """The feature-extractor factory. ``None`` -> a factory returning
    ``None``, so that raw audio flows straight to the model."""
    if extractor is None:
        return lambda *args, **kwargs: None
    if extractor in ("mfcc", "wav2vec"):
        raise NotImplementedError(f"extractor {extractor!r} {_NOT_PORTED}")
    raise KeyError(f"Unknown extractor {extractor!r}; available: mfcc, wav2vec, None")


def get_loss_fn(modelname: str):
    """Loss selection by model family."""
    if modelname == "faceformer":
        return FaceFormerLoss()
    return VocaLoss()

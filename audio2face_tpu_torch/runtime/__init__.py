"""Host runtime: the native data loader and the device prefetcher."""

from audio2face_tpu_torch.runtime.hostloader import (
    Prefetcher,
    build_native,
    fragment_batch_i16,
    fragment_batch_i16_reference,
    gather_rows_f32,
    gather_rows_f32_reference,
)

__all__ = [
    "Prefetcher",
    "build_native",
    "fragment_batch_i16",
    "fragment_batch_i16_reference",
    "gather_rows_f32",
    "gather_rows_f32_reference",
]

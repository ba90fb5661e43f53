"""Device selection for the port's entry points."""

import torch


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``. Entry points default to the GPU and
    never fall back: asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the GPU by default, but CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    return device

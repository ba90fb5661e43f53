"""Seeded weights, made on the device in one draw.

Every tensor of a configuration is ``offset + scale * z`` (or, for
variances, ``exp(scale * z)``) with z standard normal, all z of one seed
drawn by one ``torch.randn`` from a generator on the device, in a fixed
order of names. Nothing is zero, so every path the weights feed, the
decoder's feedback included, shows in the outputs. The same seed gives the
same tensors on the same device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

# (name, shape) -> ("normal", scale, offset) or ("lognormal", scale, 0.0)
Rule = Callable[[str, tuple], tuple]


def seed_of(seed: int) -> int:
    """A generator seed for any whole number (negative or past 64 bits)."""
    return seed % (2**63)


def lecun(shape: tuple, gain: float = 1.0) -> float:
    """The LeCun-normal scale of a kernel: gain / sqrt(fan_in)."""
    return gain / math.sqrt(math.prod(shape[1:]))


@torch.no_grad()
def make(shapes: dict, rule: Rule, seed: int, device) -> dict:
    """``shapes`` {name: shape} -> {name: f32 tensor on ``device``}."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed))
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {}
    for name, part in zip(names, torch.split(z, sizes)):
        kind, scale, offset = rule(name, tuple(shapes[name]))
        t = part.reshape(shapes[name]) * scale
        out[name] = t.exp_() if kind == "lognormal" else t.add_(offset)
    return out

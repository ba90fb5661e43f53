"""What the traffic drivers share: seeded generators, the seeded audio,
and the seeded sample of answers kept for the check.

Everything a run sends is drawn from its ``--seed``: sizes, audio, styles
and templates. Each purpose draws from a generator of its own
(``rng_of``), so the same seed gives the same traffic whatever else a run
draws.
"""

from __future__ import annotations

import math

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, purpose)."""
    return np.random.default_rng([seed % (2**63), stream])


def audio_bank(seed: int, seconds: float, sample_rate: int) -> np.ndarray:
    """Seeded speech-like audio to slice clips from: a voiced source (a
    gliding pitch with harmonics) and noise, under a syllable-rate envelope
    with pauses; peak near 0.5."""
    rng = rng_of(seed, 1)
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    # pitch wanders between 90 and 250 Hz
    knots = rng.uniform(90.0, 250.0, size=int(seconds * 2) + 2)
    f0 = np.interp(t, np.linspace(0.0, seconds, len(knots)), knots)
    phase = 2.0 * math.pi * np.cumsum(f0) / sample_rate
    voiced = sum(np.sin(k * phase) / k for k in range(1, 9))
    noise = rng.standard_normal(n)
    # syllables at ~4 Hz, with a pause now and then
    syl = np.abs(np.sin(2.0 * math.pi * 4.0 * t + rng.uniform(0, math.pi)))
    gate = np.interp(t, np.linspace(0.0, seconds, int(seconds) + 2),
                     (rng.uniform(size=int(seconds) + 2) > 0.15).astype(float))
    mix = rng.uniform(0.2, 0.8, size=int(seconds) + 2)
    mix = np.interp(t, np.linspace(0.0, seconds, len(mix)), mix)
    x = (mix * voiced / 2.0 + (1.0 - mix) * 0.3 * noise) * syl * gate + 0.003 * noise
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


class Reservoir:
    """A seeded uniform sample of ``k`` items from a stream of unknown
    length."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n = k, rng_of(seed, 7), 0
        self.items: list = []

    def offer(self, make) -> None:
        """Consider one more item; ``make()`` builds it only if it is kept."""
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.items[j] = make()

    def sample(self) -> list:
        return list(self.items)

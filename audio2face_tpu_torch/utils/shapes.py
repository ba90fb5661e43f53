"""Shared shape arithmetic."""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (non-negative ints)."""
    return ((x + m - 1) // m) * m

"""Shared fixtures of the benchmark's own tests.

These run on the CPU at small sizes (``python -m pytest benchmark/tests``);
a test that needs the card asks for the ``cuda`` fixture, which skips it
elsewhere.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def config(name: str, **changes) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(changes)
    return cfg


def config_module(name: str):
    from benchmark.run import load_module

    return load_module(BENCH / "configs" / f"{name}.py", f"test_config_{name}")


def traffic(name: str, **changes) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    tr.update(changes)
    return tr


# small cells: the published widths, few vertices, short clips
SMALL_VERTS = 90


def small_cell(config_name: str, traffic_name: str, driver: str, seed: int = 2**31 + 5,
               limits=None, **traffic_changes):
    import importlib

    from benchmark.run import Cell

    cfg = config(config_name, vertice_dim=SMALL_VERTS)
    return Cell(name=f"small.{traffic_name}", cfg=cfg, cfgmod=config_module(config_name),
                traffic=traffic(traffic_name, **traffic_changes),
                driver=importlib.import_module(f"benchmark.drivers.{driver}"), seed=seed,
                device="cpu", limits=limits or {"vertex_err": 0.1})

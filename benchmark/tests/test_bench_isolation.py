"""The harness imports neither JAX nor the JAX package, the references
import nothing of the program, and a cell, traffic mix or metric added as
files is found by name with no other file edited."""

from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

from benchmark import run
from benchmark.tests.conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "audio2face_tpu"}


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        # whole top-level names: audio2face_tpu_torch is the port, allowed
        assert not imported_top_names(path) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        names = imported_top_names(path)
        assert "audio2face_tpu_torch" not in names, path
        assert names <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "audio2face_tpu_torch_like", object())
    assert "audio2face_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.forbidden_modules()


def test_files_added_by_name_are_found(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((bench / "traffic" / "offline_mixed.json").read_text())
    (bench / "traffic" / "offline_long.json").write_text(json.dumps(
        {**mix, "length_median_s": 60.0, "length_sigma": 0.0, "clips_per_request": 8}))
    (bench / "workloads" / "faceformer_vocaset.offline_long.json").write_text(json.dumps(
        {"config": "faceformer_vocaset", "traffic": "offline_long", "chips": 1,
         "why": "8 x 60 s", "limits": {"vertex_err": 0.1}}))
    (bench / "metrics" / "request.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.records))\n")
    cell = run.load_cell("faceformer_vocaset.offline_long", 5, "cpu", bench=bench)
    assert cell.traffic["length_median_s"] == 60.0 and cell.driver.__name__.endswith("offline")
    bench_json = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench_json["per_layer"].append({"name": "request.count", "unit": "requests", "better": "higher",
                                    "source": "program_counter", "layer": "request output path",
                                    "moves": "mesh_frames_per_s"})
    bench_json["end_to_end"][0]["workloads"].append(cell.name)
    wanted = [m["name"] for m in run.cell_metrics(bench_json, cell.name, trace=True)]
    assert wanted == ["request.count"]
    reader = run.load_module(bench / "metrics" / "request.count.py", "m")

    class Ctx:
        class window:
            records = [{}, {}]

    assert reader.read(Ctx) == 2.0


def test_benchmark_json_names_files_that_exist():
    bench_json = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in bench_json["configs"]:
        assert (BENCH.parent / c["file"]).is_file()
        assert (BENCH / "configs" / f"{c['name']}.py").is_file()
    for w in bench_json["workloads"]:
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench_json["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]

"""Build the port's CUDA sources at first launch and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). All sources compile in parallel, one ``nvcc`` process each, into
``build/torch_kernels/`` at the repository root; a library's file name
carries a digest of its sources and flags, so an edited source rebuilds.
Importing this module builds nothing. A missing ``nvcc`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "conv_encoder", "decode_loop", "rasterizer")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-lineinfo",
    "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels cannot be built"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source not yet built (in parallel) and load them all.

    Returns each library's path. The nvcc log of each source, including
    ``-Xptxas -v``'s register and shared-memory report, is left beside it
    as ``<name>.log``."""
    with _lock:
        paths = {name: _library_path(name) for name in SOURCES}
        todo = [n for n in SOURCES if n not in _libs and not paths[n].exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            jobs = []
            try:
                for name in todo:
                    tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
                    log = open(BUILD_DIR / f"{name}.log", "w")
                    proc = subprocess.Popen(
                        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                        stdout=log, stderr=subprocess.STDOUT,
                    )
                    jobs.append((name, proc, tmp, log))
            finally:
                rcs = {name: proc.wait() for name, proc, _, log in jobs}
                for *_, log in jobs:
                    log.close()
            failed = [n for n, rc in rcs.items() if rc != 0]
            if failed:
                logs = "\n".join(
                    (BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed
                )
                raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
            for name, _, tmp, _ in jobs:
                os.replace(tmp, paths[name])
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(paths[name]))
        return paths


def function(lib: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``lib``, building on first use.

    Every entry point returns its ``cudaError_t`` as an int."""
    key = (lib, symbol)
    if key not in _fns:
        build_all()
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")

"""Where the native row gather's time goes on this host.

Times ``runtime.gather_rows_f32`` (128 rows of 5,023 x 3 float32 from a
2,000-row source, the Audio2Mesh frame batch) at 1, 2, 4 and 8 threads
beside numpy's fancy index, each with a freshly allocated output (as the
wrapper and numpy allocate it) and with an output whose pages were touched
before (the native call through ctypes directly). The difference between
the two is the cost of first-touch page faults on the fresh output; a call
on 8 one-float rows at 8 threads is the cost of starting and joining the
threads. The fragmenter (128 x 11,440 samples) is timed the same way.

    python3 tools/torch_hostloader_threads.py

Prints one JSON object. Host times only: no card is used.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audio2face_tpu_torch.runtime import (  # noqa: E402
    fragment_batch_i16,
    fragment_batch_i16_reference,
    gather_rows_f32,
    gather_rows_f32_reference,
)
from audio2face_tpu_torch.runtime import hostloader  # noqa: E402

THREADS = (1, 2, 4, 8)


def median_ms(fn, reps: int = 50, rounds: int = 5) -> float:
    fn()
    out = []
    for _ in range(rounds):
        tic = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append(1e3 * (time.perf_counter() - tic) / reps)
    return float(np.median(out))


def main() -> None:
    lib = hostloader._native()
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(2000, 5023, 3)).astype(np.float32)
    idx = rng.integers(0, 2000, 128).astype(np.int64)
    touched = np.ones((128, 5023, 3), np.float32)

    def native_into(out, n_threads, src=verts, ids=idx, row_elems=5023 * 3):
        lib.a2f_gather_rows_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(ids)), ctypes.c_int64(row_elems),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int(n_threads))

    tiny_src = np.zeros((8, 1), np.float32)
    tiny_idx = np.arange(8, dtype=np.int64)
    tiny_out = np.zeros((8, 1), np.float32)

    gather = {
        "numpy_fresh_out_ms": median_ms(lambda: gather_rows_f32_reference(verts, idx)),
        "numpy_take_touched_out_ms": median_ms(lambda: np.take(verts, idx, axis=0, out=touched)),
        "native_fresh_out_ms": {n: median_ms(lambda n=n: gather_rows_f32(verts, idx, n_threads=n))
                                for n in THREADS},
        "native_touched_out_ms": {n: median_ms(lambda n=n: native_into(touched, n)) for n in THREADS},
        "thread_start_join_ms": {n: median_ms(lambda n=n: native_into(
            tiny_out, n, tiny_src, tiny_idx, 1)) for n in THREADS},
    }
    del verts, touched

    sr, window = 22000, 11440
    clip = rng.integers(-32768, 32768, 60 * sr).astype(np.int16)
    starts = rng.integers(-5720, 60 * sr, 128).astype(np.int64)
    fragment = {
        "numpy_ms": median_ms(lambda: fragment_batch_i16_reference(clip, starts, window), reps=10),
        "native_fresh_out_ms": {n: median_ms(lambda n=n: fragment_batch_i16(clip, starts, window, n_threads=n))
                                for n in THREADS},
    }
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "no card"
    print(json.dumps({
        "host_cpus": os.cpu_count(), "usable_cpus": len(os.sched_getaffinity(0)),
        "default_threads": hostloader._default_threads(),
        "gather_128x5023x3": gather, "fragment_128x11440": fragment, "card": smi,
    }))


if __name__ == "__main__":
    main()

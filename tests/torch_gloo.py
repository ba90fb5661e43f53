"""Spawned gloo ranks for the port's multi-rank tests on the CPU.

``run_ranks(n, fn, args, tmp_path)`` starts ``n`` processes (the spawn
method: each imports torch afresh), joins them into one gloo group through
a rendezvous file under ``tmp_path`` (no fixed port), runs ``fn(rank,
*args)`` on each with one torch thread, and returns the ranks' results in
rank order. ``fn`` must be importable without JAX (the rank-side cases live
in ``torch_parallel_cases.py``). A rank that raises fails the call with its
traceback; a rank still running at the deadline is killed and fails it
too, so a hang cannot stall the suite.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import time
import traceback


def _rank_entry(rank: int, n: int, rendezvous: str, out: str, fn, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=120))
    try:
        result = fn(rank, *args)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn, args: tuple, tmp_path, timeout: float = 240.0) -> list:
    ctx = multiprocessing.get_context("spawn")
    rendezvous = os.path.join(str(tmp_path), "rendezvous")
    outs = [os.path.join(str(tmp_path), f"rank{r}.pkl") for r in range(n)]
    procs = [ctx.Process(target=_rank_entry, args=(r, n, rendezvous, outs[r], fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [open(o + ".err").read() for o in outs if os.path.exists(o + ".err")]
    if errors:
        raise RuntimeError("a rank failed:\n" + errors[0])
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with {[procs[r].exitcode for r in bad]}")
    results = []
    for o in outs:
        with open(o, "rb") as f:
            results.append(pickle.load(f))
    return results

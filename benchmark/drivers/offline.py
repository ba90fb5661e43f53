"""Offline requests in a closed loop: one client, like a batch animation
pipeline, sends a request of clips, waits for every clip's vertices, and
sends the next while the window lasts.

Traffic parameters (``traffic/<mix>.json``): ``clips_per_request``; clip
lengths log-normal (``length_median_s``, ``length_sigma``, clipped to
``length_min_s`` .. ``length_max_s``); a catalog of ``catalog_requests``
requests holds that many times ``clips_per_request`` midpoint quantiles of
the distribution, dealt into requests once by ``catalog_seed``, so the
requests differ in their lengths and buckets while every seed does the
same work; ``check_requests``, the seeded sample of answered requests whose
every clip the reference recomputes. The run's seed orders the catalog
(afresh each time it is used up) and the clips of each request, and draws
the audio, sliced from a seeded bank at the configuration's sample rate,
the styles (uniform) and one template a request.

End-to-end metric ``mesh_frames_per_s``: the valid mesh frames returned
over the time from the first send to the last return.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

from benchmark.drivers import common

N_TEMPLATES = 4


@dataclass
class Window:
    metrics: dict
    attempted: int
    failed: int
    records: list
    sample: list


class Requests:
    """The seeded inputs of one run: the audio bank, the templates and the
    request stream over the mix's catalog."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.fps, self.sr = cfg["fps"], cfg["sample_rate"]
        self.n_styles = cfg["n_styles"]
        self.seed = seed
        self.catalog = catalog(traffic)
        self.bank = common.audio_bank(seed, traffic["length_max_s"] + 10.0, self.sr)
        rng = common.rng_of(seed, 2)
        self.templates = (0.05 * rng.standard_normal((N_TEMPLATES, cfg["vertice_dim"] // 3, 3))
                          ).astype(np.float32)

    def get(self, r: int) -> dict:
        """Request ``r``: each clip as (bank offset, length), the styles
        and the template index."""
        size = len(self.catalog)
        order = common.rng_of(self.seed, 500 + r // size).permutation(size)
        rng = common.rng_of(self.seed, 1000 + r)
        lengths = (rng.permutation(self.catalog[order[r % size]]) * self.sr).astype(np.int64)
        offsets = [int(rng.integers(0, len(self.bank) - n + 1)) for n in lengths]
        return {"lengths": lengths, "offsets": offsets,
                "styles": rng.integers(0, self.n_styles, len(lengths)),
                "template": int(rng.integers(0, N_TEMPLATES))}

    def audio(self, offset: int, length: int) -> np.ndarray:
        return self.bank[offset : offset + length]

    def inputs(self, spec: dict):
        audios = [self.audio(o, n) for o, n in zip(spec["offsets"], spec["lengths"])]
        one_hot = np.eye(self.n_styles, dtype=np.float32)[spec["styles"]]
        return audios, one_hot, self.templates[spec["template"]]

    def frames(self, n: int) -> int:
        return int(n) * self.fps // self.sr


def catalog(traffic: dict) -> np.ndarray:
    """(requests, clips) lengths in seconds: the midpoint quantiles of the
    clipped log-normal, dealt into requests by the mix's fixed seed."""
    n_req, n_clips = traffic["catalog_requests"], traffic["clips_per_request"]
    n = n_req * n_clips
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    secs = np.clip(traffic["length_median_s"] * np.exp(traffic["length_sigma"] * z),
                   traffic["length_min_s"], traffic["length_max_s"])
    deal = np.random.default_rng(traffic["catalog_seed"]).permutation(n)
    return secs[deal].reshape(n_req, n_clips)


def group_sizes(n_clips: int, max_batch: int) -> list:
    """The sizes of the groups a request of ``n_clips`` is cut into."""
    return sorted({min(max_batch, n_clips - lo) for lo in range(0, n_clips, max_batch)})


def setup(cell) -> dict:
    reqs = Requests(cell.cfg, cell.traffic, cell.seed)
    w = cell.cfgmod.weights(cell.cfg, cell.seed, cell.device)
    pred = cell.cfgmod.predictor(cell.cfg, w, cell.device)
    del w
    cell.cfgmod.install_spans(pred, cell.span)
    # the window's shapes: its groups' sizes, each at every audio bucket
    # up to the longest clip
    pred.warmup(cell.traffic["length_max_s"],
                batches=group_sizes(cell.traffic["clips_per_request"], pred.max_batch))
    cell.sync()
    return {"pred": pred, "reqs": reqs}


def check_answers(out, spec: dict, reqs: Requests, n_verts: int) -> int:
    """Answers whose count or shapes are wrong, in the callers' order."""
    if not isinstance(out, list) or len(out) != len(spec["lengths"]):
        return len(spec["lengths"])
    bad = 0
    for o, n in zip(out, spec["lengths"]):
        if o.shape != (reqs.frames(n), n_verts // 3, 3) or not np.isfinite(o).all():
            bad += 1
    return bad


def check_sample(traffic: dict, seed: int) -> common.Reservoir:
    """The seeded sample of answered requests the check recomputes."""
    return common.Reservoir(traffic["check_requests"], seed)


def offer_request(sample: common.Reservoir, spec: dict, out) -> None:
    """Offer an answered request, every clip of it, to the check's sample
    (``out``: the answers, or None)."""
    sample.offer(lambda: [
        {"offset": spec["offsets"][k], "length": int(spec["lengths"][k]),
         "style": int(spec["styles"][k]), "template": spec["template"],
         "out": None if out is None else out[k]}
        for k in range(len(spec["lengths"]))])


def clips_of(sample: common.Reservoir) -> list:
    return [clip for request in sample.sample() for clip in request]


def window(cell, state: dict, seconds: float) -> Window:
    pred, reqs = state["pred"], state["reqs"]
    request = cell.span("request", pred)
    sample = check_sample(cell.traffic, cell.seed)
    records, failed, frames = [], 0, 0
    start = time.perf_counter()
    first = last = None
    r = 0
    while time.perf_counter() - start < seconds:
        spec = reqs.get(r)
        inputs = reqs.inputs(spec)
        t0 = time.perf_counter()
        first = t0 if first is None else first
        try:
            out = request(*inputs)
        except Exception as exc:  # a failed request is counted, the loop goes on
            out = exc
        last = time.perf_counter()
        bad = check_answers(out, spec, reqs, cell.cfg["vertice_dim"])
        failed += int(bad > 0)
        ok_frames = 0 if bad else sum(reqs.frames(n) for n in spec["lengths"])
        frames += ok_frames
        records.append({"send": t0 - start, "wall": last - t0, "lengths": list(map(int, spec["lengths"])),
                        "frames": ok_frames})
        if not bad:
            offer_request(sample, spec, out)
        r += 1
    return Window(metrics={"mesh_frames_per_s": frames / (last - first)},
                  attempted=r, failed=failed, records=records, sample=clips_of(sample))


def teardown(state: dict) -> None:
    state.pop("pred", None)


def reference_inputs(reqs: Requests, sample: list, n_styles: int):
    audios = [reqs.audio(s["offset"], s["length"]) for s in sample]
    one_hot = np.eye(n_styles, dtype=np.float32)[[s["style"] for s in sample]]
    return audios, one_hot, [reqs.templates[s["template"]] for s in sample]


def check(cell, state: dict, win: Window) -> dict:
    """The reference over the sampled requests' clips against what the
    window returned for them."""
    return compare_clips(cell, state["reqs"], win.sample)


def compare_clips(cell, reqs: Requests, sample: list) -> dict:
    """``vertex_err``: over the sampled clips, the largest per-vertex L2
    gap between the program's and the plain f32 reference's vertices, over
    the RMS of the reference's per-vertex motion (vertices less template)
    of that clip."""
    import torch

    if not sample:
        return {"vertex_err": float("inf")}
    sample = sorted(sample, key=lambda s: s["length"])  # blocks of like lengths
    w = cell.cfgmod.weights(cell.cfg, cell.seed, cell.device)
    audios, one_hot, templates = reference_inputs(reqs, sample, cell.cfg["n_styles"])
    worst = 0.0
    for lo in range(0, len(sample), 8):
        hi = lo + 8
        want = cell.cfgmod.reference(cell.cfg, w, audios[lo:hi], one_hot[lo:hi],
                                     templates[lo:hi], cell.device)
        for s, ref, tmpl in zip(sample[lo:hi], want, templates[lo:hi]):
            got = torch.as_tensor(s["out"], device=ref.device)
            tm = torch.as_tensor(tmpl, device=ref.device)
            motion = (ref - tm).norm(dim=-1).square().mean().sqrt()
            gap = (got - ref).norm(dim=-1).max()
            worst = max(worst, float(gap / motion))
        del want
    return {"vertex_err": worst}

"""Synthetic demo assets: a renderable head mesh, a vertex animation and a
speech-like clip.

Port of the asset generators of ``audio2face_tpu/data/synthetic.py``
(``generate_synthetic_face_obj``, ``generate_demo_animation``,
``generate_demo_assets`` and the ``synthesize_speech_like`` they need): FLAME
and the reference's sample clip are licensed and cannot ship, so the
renderer, the CLIs and the smoke test run on these stand-ins. Pure
numpy/scipy. The synthetic dataset generators are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

FPS = 60  # VOCASET's animation clock


def synthesize_speech_like(
    seconds: float = 5.8,
    sample_rate: int = 22000,
    *,
    seed: int = 0,
    f0: float = 120.0,
    syllables_per_second: float = 3.5,
) -> np.ndarray:
    """Formant-synthesized speech-like audio (float32 in [-1, 1]).

    The reference ships a real 5.8 s speech clip (``assets/sample_audio.wav``)
    that licensing bars this repo from redistributing; a pure tone exercises
    none of the spectro-temporal structure the models key on. This classic
    source-filter synthesizer is unencumbered and produces babble with real
    speech statistics: a glottal pulse train (declining pitch contour,
    per-period jitter, -12 dB/oct tilt) filtered through three time-varying
    formant resonators that glide between vowel targets syllable to
    syllable, with band-filtered noise bursts as onset consonants and
    syllabic amplitude envelopes. Not intelligible — but MFCC/wav2vec2
    front-ends see formant transitions, voicing alternation and plosive
    bursts, like speech.
    """
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    n = int(seconds * sample_rate)
    sr = float(sample_rate)

    # ---- syllable schedule ------------------------------------------------
    # vowel formant targets (F1, F2, F3) in Hz: /a e i o u/
    vowels = np.array(
        [
            [730.0, 1090.0, 2440.0],
            [530.0, 1840.0, 2480.0],
            [270.0, 2290.0, 3010.0],
            [570.0, 840.0, 2410.0],
            [300.0, 870.0, 2240.0],
        ]
    )
    syl_len = int(sr / syllables_per_second)
    n_syl = max(1, int(np.ceil(n / syl_len)))
    targets = vowels[rng.integers(0, len(vowels), n_syl + 1)]

    # 10 ms control frames: formants glide between syllable targets
    hop = max(1, int(0.01 * sr))
    n_ctl = n // hop + 2
    t_ctl = np.arange(n_ctl) * hop / syl_len  # position in syllable units
    i_syl = np.minimum(t_ctl.astype(int), n_syl - 1)
    frac = np.clip((t_ctl - i_syl - 0.55) / 0.45, 0.0, 1.0)  # glide late
    formants = (1 - frac[:, None]) * targets[i_syl] + frac[:, None] * targets[i_syl + 1]
    bandwidths = np.array([90.0, 110.0, 170.0])

    # ---- glottal source ----------------------------------------------------
    # pitch declines over the utterance and wobbles per syllable, with jitter
    t = np.arange(n) / sr
    contour = f0 * (1.15 - 0.25 * t / seconds) * (
        1.0 + 0.04 * np.sin(2 * np.pi * syllables_per_second * 0.5 * t)
    )
    contour = contour * (1.0 + 0.015 * rng.normal(size=n).cumsum() / np.sqrt(np.arange(1, n + 1)))
    phase = np.cumsum(contour / sr)
    pulses = np.diff(np.floor(phase), prepend=0.0).astype(np.float32)  # 1 per period
    # -12 dB/oct spectral tilt (two one-pole lowpasses)
    a_tilt = np.exp(-2 * np.pi * 900.0 / sr)
    source = lfilter([1 - a_tilt], [1, -a_tilt], pulses)
    source = lfilter([1 - a_tilt], [1, -a_tilt], source)
    source += 0.003 * rng.normal(size=n)  # breath noise

    # ---- time-varying formant cascade (per-frame biquads, carried state) ---
    voiced = np.zeros(n, np.float32)
    zi = [np.zeros(2) for _ in range(3)]
    for ci in range(0, n, hop):
        f = formants[ci // hop]
        seg = source[ci : ci + hop]
        for k in range(3):
            r = np.exp(-np.pi * bandwidths[k] / sr)
            th = 2 * np.pi * min(f[k], 0.45 * sr) / sr
            b = [float((1 - r) * np.sqrt(1 - 2 * r * np.cos(2 * th) + r * r))]
            a = [1.0, float(-2 * r * np.cos(th)), float(r * r)]
            seg, zi[k] = lfilter(b, a, seg, zi=zi[k])
        voiced[ci : ci + hop] = seg

    # ---- syllabic envelope + consonant noise bursts ------------------------
    pos = (np.arange(n) % syl_len) / syl_len
    env = np.clip(np.sin(np.pi * np.clip((pos - 0.08) / 0.9, 0.0, 1.0)) ** 0.7, 0.0, 1.0)
    # occasional unvoiced syllable endings (devoicing)
    syl_gain = 0.75 + 0.25 * rng.random(n_syl)
    env = env * syl_gain[np.minimum(np.arange(n) // syl_len, n_syl - 1)]
    out = voiced * env

    burst_len = int(0.05 * sr)
    a_hp = np.exp(-2 * np.pi * 2500.0 / sr)
    for s in range(n_syl):
        start = s * syl_len
        if start + burst_len >= n or rng.random() < 0.35:
            continue  # vowel-initial syllable
        noise = rng.normal(size=burst_len)
        frica = noise - lfilter([1 - a_hp], [1, -a_hp], noise)  # high-pass
        ramp = np.linspace(1.0, 0.0, burst_len) ** 2
        out[start : start + burst_len] += 0.25 * frica * ramp

    peak = np.max(np.abs(out)) or 1.0
    return (0.5 * out / peak).astype(np.float32)


def generate_synthetic_face_obj(path: str, n_verts: int = 5023) -> str:
    """Write a renderable OBJ with EXACTLY ``n_verts`` vertices.

    FLAME is licensed, so the repo cannot ship ``FLAME_sample.obj``
    (reference assets, main.py:9); this head-sized ellipsoid stands in so
    every entry script runs green on a fresh clone. A lat/long sphere grid
    plus two poles covers most of the count; the remainder are appended as
    unreferenced vertices at the south pole (valid OBJ — faces only index
    the grid)."""
    if n_verts < 5:
        raise ValueError(f"need at least 5 vertices for a closed mesh, got {n_verts}")
    rows = max(int(np.sqrt(max(n_verts - 2, 1))), 2)
    cols = max((n_verts - 2) // rows, 3)
    # the max(cols, 3) floor can push the grid past n_verts for tiny counts;
    # shrink rows until every face index exists (faces reference grid+poles)
    while rows > 1 and rows * cols + 2 > n_verts:
        rows -= 1
    assert rows * cols + 2 <= n_verts, (rows, cols, n_verts)
    n_grid = rows * cols
    verts = []
    # head-ish scale in the renderer's camera frame (FLAME is ~0.2 m tall)
    rx, ry, rz = 0.085, 0.115, 0.095
    for i in range(rows):
        theta = np.pi * (i + 1) / (rows + 1)
        for j in range(cols):
            phi = 2 * np.pi * j / cols
            verts.append(
                (
                    rx * np.sin(theta) * np.cos(phi),
                    ry * np.cos(theta),
                    rz * np.sin(theta) * np.sin(phi),
                )
            )
    verts.append((0.0, ry, 0.0))  # north pole
    verts.append((0.0, -ry, 0.0))  # south pole
    while len(verts) < n_verts:
        verts.append((0.0, -ry, 0.0))
    verts = np.asarray(verts[:n_verts], np.float32)

    faces = []
    north, south = n_grid, n_grid + 1
    for j in range(cols):
        faces.append((north, j, (j + 1) % cols))
        base = (rows - 1) * cols
        faces.append((south, base + (j + 1) % cols, base + j))
    for i in range(rows - 1):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            c = (i + 1) * cols + j
            d = (i + 1) * cols + (j + 1) % cols
            faces.append((a, b, c))
            faces.append((b, d, c))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("# synthetic head template (FLAME stand-in)\n")
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")
    return path


def generate_demo_animation(
    template_path: str,
    out_path: str,
    *,
    seconds: float = 2.0,
    fps: int = FPS,
) -> str:
    """Write a gentle jaw-like vertex animation derived from ``template_path``
    (so frame vertex counts always match the mesh being rendered)."""
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    mesh = FaceMesh.load(template_path)
    n_frames = int(seconds * fps)
    t = np.arange(n_frames) / fps
    open_amt = 0.004 * (0.5 - 0.5 * np.cos(2 * np.pi * 2.3 * t))
    base = mesh.verts.astype(np.float32)
    lower = base[:, 1] < 0.0  # lower half nods like a jaw
    anim = np.repeat(base[None], n_frames, axis=0)
    anim[:, lower, 1] -= open_amt[:, None]
    np.save(out_path, anim)
    return out_path


def generate_demo_assets(
    assets_dir: str = "assets",
    *,
    n_verts: int = 5023,
    seconds: float = 2.0,
    fps: int = FPS,
    seed: int = 0,
) -> dict:
    """Materialize the out-of-box demo inputs the reference ships but this
    repo cannot (FLAME license): a synthetic template OBJ, a matching vertex
    animation ``verts_sample.npy`` (gentle jaw-like motion), and a
    formant-synthesized speech-like ``sample_audio.wav`` at 22 kHz
    (:func:`synthesize_speech_like` — same format as the reference's
    licensed clip). Idempotent — existing files are kept."""
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    os.makedirs(assets_dir, exist_ok=True)
    paths = {
        "template": os.path.join(assets_dir, "FLAME_sample.obj"),
        "verts": os.path.join(assets_dir, "verts_sample.npy"),
        "audio": os.path.join(assets_dir, "sample_audio.wav"),
    }
    if not os.path.exists(paths["template"]):
        generate_synthetic_face_obj(paths["template"], n_verts)
    if not os.path.exists(paths["verts"]):
        generate_demo_animation(
            paths["template"], paths["verts"], seconds=seconds, fps=fps
        )
    if not os.path.exists(paths["audio"]):
        import scipy.io.wavfile as wavfile

        sr = 22000
        wav = synthesize_speech_like(seconds, sr, seed=seed)
        wavfile.write(paths["audio"], sr, (wav * 32767).astype(np.int16))
    return paths

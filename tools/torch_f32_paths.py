#!/usr/bin/env python3
"""Wall time of the two paths that run the f32 attention kernels, on one GPU.

1. The wav2vec2 frame request: Audio2Mesh on wav2vec2 features
   (``config.yaml`` with ``feature_extractor: wav2vec``, bf16 model, the
   extractor in f32), 2 clips x 10 s through ``FramePredictor``
   (``max_batch`` 8, ``frame_batch`` 128), as ``chip_smoke.py`` 9c serves
   it: 60 launches of the f32 forward at (256, 12, 25, 64). Three requests
   after a warm one.
2. The f32 gradient check's step: the full-width FaceFormer in f32
   (``percision: "32"``), batch 2 x 2 s, ``accumulate_gradients`` through the
   kernels (the f32 forward and backward at T = 100), as ``chip_smoke.py``
   phase 7 takes it. Three steps after a warm one.

Each wall ends in ``torch.cuda.synchronize()``; the launch counts come from
the wrappers' ``launches``. Prints one JSON line ``{"f32_paths": {...}}``.

``python3 tools/torch_f32_paths.py`` from the root of a checkout; the
package is the current directory's, so the same file times another
checkout when run from its root (parent and change in one call).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.getcwd())  # the checkout whose package is timed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_f32_paths: CUDA is not available", file=sys.stderr)
        return 1
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.data.synthetic import synthesize_speech_like
    from audio2face_tpu_torch.ops import attention as attn_ops
    from audio2face_tpu_torch.serving import FaceFormerPredictor, FramePredictor
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out = {"card": smi, "package": attn_ops.__file__}

    # 1. the wav2vec2 frame request
    cfg = ExpConfig.from_yaml("config.yaml").model_copy(update={"feature_extractor": "wav2vec"})
    sr, n_v = cfg.sample_rate, cfg.vertex_count
    clips = [synthesize_speech_like(10.0, sr, seed=10 + i) for i in range(2)]
    rng = np.random.default_rng(7)
    template = (rng.normal(size=(n_v // 3, 3)) * 0.1).astype(np.float32)
    one_hot = np.eye(12, dtype=np.float32)[[3, 5]]
    w2v = FramePredictor(cfg, max_batch=8, frame_batch=128, seed=2)
    w2v(clips, one_hot, template)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        attn_ops.flash_attention.launches = 0
        tic = time.perf_counter()
        res = w2v(clips, one_hot, template)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - tic)
    frames = sum(y.shape[0] for y in res)
    out["wav2vec_frame_request"] = {"clips": 2, "seconds_each": 10, "frames": frames, "wall_s": walls,
                                    "mesh_frames_per_s": [frames / w for w in walls],
                                    "k1_launches": attn_ops.flash_attention.launches}
    del w2v, res
    torch.cuda.empty_cache()

    # 2. the f32 gradient step of the full-width FaceFormer
    n_verts = 15069
    cfg32 = ExpConfig(batch_size=2, modelname="faceformer", one_hot_size=12, feature_extractor=None,
                      sample_rate=16000, vertex_count=n_verts, split_frame=False, n_feature=32,
                      out_dim=52, win_length=440, percision="32", lr=1e-3, seed=0)
    pred = FaceFormerPredictor(n_verts=n_verts, bf16=True, max_batch=8, bucket_seconds=5.0, seed=0)
    rng = np.random.default_rng(3)
    tmpl = (rng.normal(size=(2, n_verts // 3, 3)) * 0.1).astype(np.float32)
    small = {
        "audio": (rng.normal(size=(2, 32000)) * 0.1).astype(np.float32),
        "one_hot": np.eye(12, dtype=np.float32)[[3, 7]],
        "verts": (rng.normal(size=(2, 120, n_verts)) * 0.01).astype(np.float32) + tmpl.reshape(2, 1, -1),
        "template_vert": tmpl,
        "audio_lengths": np.asarray([32000, 21000], np.int32),
    }
    e32 = Audio2FaceExperiment(cfg32, log_dir="build/f32_paths_logs")
    e32.model.load_state_dict(pred.model.state_dict())
    del pred
    walls = []
    with torch.enable_grad():
        e32.accumulate_gradients(small)  # warm-up
        torch.cuda.synchronize()
        for _ in range(3):
            attn_ops.flash_attention.launches = attn_ops.flash_attention_bwd.launches = 0
            e32.model.zero_grad(set_to_none=True)
            tic = time.perf_counter()
            e32.accumulate_gradients(small)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tic)
    out["f32_gradient_step"] = {"batch": 2, "seconds_each": 2, "wall_s": walls,
                                "k1_launches": attn_ops.flash_attention.launches,
                                "k4_launches": attn_ops.flash_attention_bwd.launches}
    print(json.dumps({"f32_paths": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Checkpoint export: the port's trainer checkpoint -> PyTorch/Lightning ``.ckpt``.

Port of ``audio2face_tpu/cli/export.py``. Models trained by the port load
back into the reference's PyTorch modules (src/model/audio2face.py /
voca.py / song2face.py / faceformer.py), key names included::

    python -m audio2face_tpu_torch.cli.export --config configs/voca.yaml --out voca.ckpt
    python -m audio2face_tpu_torch.cli.export --config configs/faceformer.yaml \
        --checkpoint logs/.../checkpoints/epoch=7-step=123 --out ff.ckpt

The input is a checkpoint of the port's trainer (``{"model", "optimizer",
"step", "epoch"}``, ``Audio2FaceExperiment.save_checkpoint``), by default
the newest under ``logs/<config name>/checkpoints``. The output is a
Lightning-style dict (``{"state_dict": {"model.<key>": tensor}, "epoch",
"global_step"}``), so ``torch.load(...)["state_dict"]`` and
``compat.torch_convert.load_torch_checkpoint`` both read it.
Feature-extractor buffers (the MFCC filterbanks) are constants the
reference's constructor rebuilds and are not stored. The export renames
tensors on the host and runs no model, so it takes no device.
"""

import argparse
import os

import numpy as np


def _newest_checkpoint(log_dir: str) -> str:
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"no checkpoints/ under {log_dir}; pass --checkpoint")
    names = [c for c in os.listdir(ckpt_dir) if not c.endswith(".tmp")]
    if not names:
        raise SystemExit(f"{ckpt_dir} is empty; pass --checkpoint")
    names.sort(key=lambda x: int(x.split("=")[-1]))
    return os.path.join(ckpt_dir, names[-1])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="export a checkpoint of the port's trainer as a "
        "reference-loadable PyTorch/Lightning .ckpt"
    )
    parser.add_argument("--config", required=True, help="experiment YAML "
                        "(determines the model family and the default log dir)")
    parser.add_argument("--checkpoint", default=None,
                        help="trainer checkpoint file (default: newest under "
                             "logs/<config name>/checkpoints)")
    parser.add_argument("--out", required=True, help="output .ckpt path")
    args = parser.parse_args(argv)

    import torch

    from audio2face_tpu_torch.compat.torch_export import export_state_dict
    from audio2face_tpu_torch.config import ExpConfig

    config = ExpConfig.from_yaml(args.config).apply_faceformer_overrides()
    path = args.checkpoint or _newest_checkpoint(os.path.join("logs", config.name()))
    restored = torch.load(path, map_location="cpu", weights_only=True)
    sd = export_state_dict(config.modelname, restored["model"])

    ckpt = {
        "state_dict": {f"model.{k}": torch.as_tensor(v) for k, v in sd.items()},
        "epoch": int(restored.get("epoch", 0)),
        "global_step": int(restored["step"]),
    }
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    torch.save(ckpt, args.out)
    n_params = sum(int(np.asarray(v).size) for v in sd.values())
    print(
        f"exported {config.modelname} step {ckpt['global_step']} "
        f"({len(sd)} tensors, {n_params:,} scalars) from {path} -> {args.out}"
    )


if __name__ == "__main__":
    main()

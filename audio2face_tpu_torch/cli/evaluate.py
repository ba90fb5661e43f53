"""Evaluation entry point: domain metrics (LVE / FDD / MVE / max-L2) from
the command line.

Port of ``audio2face_tpu/cli/evaluate.py``. Two modes:

1. **Checkpoint sweep**: evaluate a checkpoint of the port's trainer over
   the test split::

       python -m audio2face_tpu_torch.cli.evaluate --config configs/faceformer.yaml \
           --dataset-path /data/vocaset \
           [--checkpoint logs/.../checkpoints/epoch=7-step=123] [--max-sentences 8]

   Builds the experiment and data module as ``cli.train`` does, restores
   the newest (or given) checkpoint, and runs
   ``Audio2FaceExperiment.evaluate`` over the test sentences.

2. **Animation diff**: compare two saved vertex animations directly::

       python -m audio2face_tpu_torch.cli.evaluate --pred out/pred_verts.npy \
           --gt gt_verts.npy --template assets/FLAME_sample.obj

Both modes print one machine-readable JSON line last, after any
human-readable output. Region masks default to the documented geometric
stand-in (``evaluation.infer_regions``; FLAME's official segmentation is
licensed); pass ``--lip-mask/--upper-mask`` index ``.npy`` files for
numbers comparable with published results. The metrics run on the GPU
unless ``--device cpu`` is given.
"""

import argparse
import json
import os

import numpy as np


def _load_regions(args):
    from audio2face_tpu_torch.evaluation import VertexRegions

    if (args.lip_mask is None) != (args.upper_mask is None):
        raise SystemExit("--lip-mask and --upper-mask must be given together")
    if args.lip_mask is None:
        return None
    return VertexRegions(lip=np.load(args.lip_mask), upper=np.load(args.upper_mask))


def _animation_diff(args) -> dict:
    import torch

    from audio2face_tpu_torch.evaluation import evaluate_animation
    from audio2face_tpu_torch.utils.device import resolve_device
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    device = resolve_device(args.device, "cli.evaluate")
    pred = np.asarray(np.load(args.pred), np.float32)
    gt = np.asarray(np.load(args.gt), np.float32)
    pred = pred.reshape(-1, pred.shape[-2], pred.shape[-1])
    gt = gt.reshape(-1, gt.shape[-2], gt.shape[-1])
    if pred.shape[-2:] != gt.shape[-2:]:
        raise SystemExit(f"vertex shapes differ: pred {pred.shape} vs gt {gt.shape}")
    n = min(pred.shape[0], gt.shape[0])
    if pred.shape[0] != gt.shape[0]:
        print(f"frame counts differ (pred {pred.shape[0]}, gt {gt.shape[0]}); "
              f"comparing the first {n}")
    pred, gt = pred[:n], gt[:n]
    if args.template:
        template = FaceMesh.load(args.template).verts.astype(np.float32)
    else:
        # FDD needs a neutral pose; without a template the ground truth's
        # first frame is the closest stand-in (documented, not silent)
        print("no --template given; using gt frame 0 as the FDD neutral pose")
        template = gt[0]
    if template.shape != pred.shape[-2:]:
        raise SystemExit(f"template has {template.shape} verts, animation {pred.shape[-2:]}")
    metrics = evaluate_animation(
        torch.as_tensor(pred, device=device), torch.as_tensor(gt, device=device), template,
        regions=_load_regions(args))
    metrics["n_frames"] = n
    return metrics


def _checkpoint_sweep(args) -> dict:
    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    config = ExpConfig.from_yaml(args.config).apply_faceformer_overrides()
    dataset_path = args.dataset_path or os.path.join(os.getcwd(), "..")

    if config.dataset == "biwi":
        from audio2face_tpu_torch.data.biwi import BiwiDataModule

        datamodule = BiwiDataModule(dataset_path, batch_size=config.batch_size)
    else:
        from audio2face_tpu_torch.data.vocaset import VocaDataModule

        datamodule = VocaDataModule(
            dataset_path, batch_size=config.batch_size, num_workers=0,
            split_frame=config.split_frame,
        )
    datamodule.setup()

    experiment = Audio2FaceExperiment(config, log_dir=args.log_dir, device=args.device)
    experiment.load_checkpoint(args.checkpoint)
    return experiment.evaluate(
        datamodule, regions=_load_regions(args), max_sentences=args.max_sentences)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="LVE / FDD / MVE / max-L2 evaluation "
        "(checkpoint test-split sweep, or a direct .npy animation diff)"
    )
    parser.add_argument("--config", default=None, help="experiment YAML (sweep mode)")
    parser.add_argument("--dataset-path", default=None,
                        help="dataset artifact dir (default: parent of cwd)")
    parser.add_argument("--checkpoint", default=None,
                        help="trainer checkpoint file (default: newest under the "
                             "config's log dir)")
    parser.add_argument("--log-dir", default=None,
                        help="log dir holding checkpoints/ (default: "
                             "logs/<config name>)")
    parser.add_argument("--max-sentences", type=int, default=None,
                        help="evaluate at most N test sentences")
    parser.add_argument("--pred", default=None, help="predicted verts .npy (diff mode)")
    parser.add_argument("--gt", default=None, help="ground-truth verts .npy (diff mode)")
    parser.add_argument("--template", default=None,
                        help="neutral template .obj/.ply (FDD reference pose)")
    parser.add_argument("--lip-mask", default=None,
                        help=".npy int vertex indices for the lip region (LVE)")
    parser.add_argument("--upper-mask", default=None,
                        help=".npy int vertex indices for the upper face (FDD)")
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    diff_mode = args.pred is not None or args.gt is not None
    if diff_mode and (args.pred is None or args.gt is None):
        raise SystemExit("--pred and --gt must be given together")
    if diff_mode == (args.config is not None):
        raise SystemExit(
            "choose one mode: --config <yaml> (checkpoint sweep) "
            "or --pred/--gt (animation diff)"
        )

    metrics = _animation_diff(args) if diff_mode else _checkpoint_sweep(args)
    for k, v in metrics.items():
        print(f"{k}: {v:.6g}" if isinstance(v, float) else f"{k}: {v}")
    print(json.dumps({"metrics": metrics}))


if __name__ == "__main__":
    main()

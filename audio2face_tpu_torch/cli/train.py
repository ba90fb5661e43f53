"""Training entry point, with the surface of the reference's train.py.

Port of ``audio2face_tpu/cli/train.py``::

    python -m audio2face_tpu_torch.cli.train --config configs/faceformer.yaml \
        [--dataset-path PATH] [--max-epochs N] [--batch-size B] [--skip-render]

Loads the YAML ExpConfig, applies the faceformer special-casing
(split_frame=False, batch_size=1, no standalone extractor), fits with
val-err checkpointing and early stopping, reloads the newest checkpoint,
predicts one test sentence (printing its ``predict_rec_loss`` and its
LVE / FDD / MVE / max-L2), saves ``pred_verts.npy`` and, unless
``--skip-render``, renders it to video with the wav beside it. Without
VOCASET or BIWI artifacts at ``--dataset-path`` it trains on the
format-identical synthetic stand-in, generated in the working directory.
Runs on the GPU unless ``--device cpu`` is given.

Under ``torchrun --nproc-per-node N -m audio2face_tpu_torch.cli.train ...``
every process trains its share on the config's ``mesh_shape`` (default
``(-1, 1)``: data parallelism over the N ranks; ``fsdp: true`` adds
ZeRO-3), one GPU a rank; rank 0 alone generates missing data, writes the
logs, checkpoints and prediction, prints and renders.
"""

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="config.yaml")
    parser.add_argument(
        "--dataset-path", type=str, default=None,
        help="VOCASET artifact dir (default: parent of cwd, as the reference)",
    )
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--predict-subject", type=str, default="FaceTalk_170908_03277_TA")
    parser.add_argument("--predict-sentence", type=str, default="sentence02")
    parser.add_argument(
        "--template", type=str, default="assets/FLAME_sample.obj",
        help="mesh used to render the prediction video",
    )
    parser.add_argument("--skip-render", action="store_true")
    parser.add_argument(
        "--accumulate-grad-batches", type=int, default=None,
        help="split each batch into k microbatches, average their gradients, "
        "apply ONE optimizer update (Lightning's accumulate_grad_batches "
        "semantics; default: the config's accumulate_grad_batches key, else 1)",
    )
    parser.add_argument(
        "--batch-size", type=int, default=None,
        help="override the config's batch size AFTER the reference faceformer "
        "override (which pins it to 1); padded whole-clip batching is this "
        "framework's extension",
    )
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    from audio2face_tpu_torch.config import ExpConfig
    from audio2face_tpu_torch.evaluation import evaluate_animation
    from audio2face_tpu_torch.training.trainer import Audio2FaceExperiment

    dataset_path = args.dataset_path or os.path.join(os.getcwd(), "..")
    config = ExpConfig.from_yaml(args.config).apply_faceformer_overrides()
    if args.batch_size:
        config = config.model_copy(update={"batch_size": args.batch_size})
    # the experiment first: under torchrun it joins the process group, and
    # only its writer (rank 0) makes files
    experiment = Audio2FaceExperiment(
        config, accumulate_grad_batches=args.accumulate_grad_batches, device=args.device)
    if not experiment.writer:
        args.skip_render = True

    def say(*a):
        if experiment.writer:
            print(*a)

    if experiment.writer:
        _write_inputs(args, config, dataset_path)
    if experiment.mesh is not None:
        import torch.distributed as dist

        dist.barrier()  # the data exist for every rank
    datamodule = _datamodule(config, dataset_path)
    datamodule.setup()

    _, result = experiment.fit(datamodule, max_epochs=args.max_epochs)
    say(f"Best val/err {result.best_val_err} at epoch {result.best_epoch}")

    # reload the newest checkpoint (the reference sorts by the trailing step)
    experiment.load_checkpoint()

    pred_subject, pred_sentence = args.predict_subject, args.predict_sentence
    test_list = getattr(datamodule.test_dataset, "datalist", None)
    if test_list and not any(row[0] == pred_subject for row in test_list):
        # the CLI defaults name a VOCASET subject; on BIWI (or a custom
        # corpus) fall back to the first test pair
        pred_subject, pred_sentence = test_list[0][0], test_list[0][1]
        say(f"predict subject not in test split; using {pred_subject}/{pred_sentence}")
    batch = datamodule.predict_batch(pred_subject, pred_sentence)
    pred, err = experiment.predict(batch)
    n_verts = config.vertex_count // 3
    pred = pred.reshape(-1, n_verts, 3)
    if experiment.is_faceformer:
        # trim the bucket padding to the clip's valid frames
        pred = pred[: int(batch["frame_lengths"][0])]
    say(f"predict_rec_loss: {float(err)}")

    # domain metrics on the predicted sentence (evaluation.py)
    gt = np.asarray(batch["verts"], np.float32).reshape(-1, n_verts, 3)[: pred.shape[0]]
    template_vert = np.asarray(batch["template_vert"], np.float32).reshape(-1, n_verts, 3)[0]
    metrics = evaluate_animation(pred, gt, template_vert)
    say("predict metrics: " + " ".join(f"{k}={v:.6g}" for k, v in metrics.items()))

    pred = pred.cpu().numpy()
    log_dir = experiment.log_dir
    if experiment.writer:
        np.save(os.path.join(log_dir, "pred_verts.npy"), pred)
    if not args.skip_render and os.path.exists(args.template):
        from audio2face_tpu_torch.utils.facemesh import FaceMesh
        from audio2face_tpu_torch.utils.renderer import Renderer, images_to_video, save_audio

        renderer = Renderer(FaceMesh.load(args.template), device=args.device)
        images = renderer.render(pred)
        save_audio(batch["audio"].reshape(-1), log_dir)
        images_to_video(images, log_dir, fps=25 if config.dataset == "biwi" else 60)


def _write_inputs(args, config, dataset_path: str) -> None:
    """The synthetic template and corpus, where they are missing."""
    if not args.skip_render and not os.path.exists(args.template):
        from audio2face_tpu_torch.data.synthetic import generate_synthetic_face_obj

        print(f"{args.template} missing; writing a synthetic stand-in template")
        generate_synthetic_face_obj(args.template, n_verts=config.vertex_count // 3)

    # fresh-clone path: both corpora are licensed, so when no artifacts
    # exist we train on the format-identical synthetic stand-in
    if config.dataset == "biwi":
        from audio2face_tpu_torch.data.biwi import generate_synthetic_biwi

        if not os.path.exists(os.path.join(dataset_path, "templates.pkl")):
            dataset_path = os.path.join(os.getcwd(), "synthetic_biwi")
            if not os.path.exists(os.path.join(dataset_path, "templates.pkl")):
                print(f"no BIWI artifacts found; generating synthetic data in {dataset_path}")
                generate_synthetic_biwi(dataset_path, n_verts=config.vertex_count // 3)
    elif not os.path.exists(os.path.join(dataset_path, "data_verts.npy")):
        from audio2face_tpu_torch.data.synthetic import generate_synthetic_vocaset

        dataset_path = os.path.join(os.getcwd(), "synthetic_vocaset")
        if not os.path.exists(os.path.join(dataset_path, "data_verts.npy")):
            print(f"no VOCASET artifacts found; generating synthetic data in {dataset_path}")
            generate_synthetic_vocaset(dataset_path, n_verts=config.vertex_count // 3)


def _datamodule(config, dataset_path: str):
    """The corpus at ``dataset_path``, else the synthetic stand-in in the
    working directory."""
    from audio2face_tpu_torch.data.vocaset import VocaDataModule

    if config.dataset == "biwi":
        from audio2face_tpu_torch.data.biwi import BiwiDataModule

        if not os.path.exists(os.path.join(dataset_path, "templates.pkl")):
            dataset_path = os.path.join(os.getcwd(), "synthetic_biwi")
        return BiwiDataModule(dataset_path, batch_size=config.batch_size)
    if not os.path.exists(os.path.join(dataset_path, "data_verts.npy")):
        dataset_path = os.path.join(os.getcwd(), "synthetic_vocaset")
    return VocaDataModule(
        dataset_path, batch_size=config.batch_size, num_workers=8,
        split_frame=config.split_frame,
    )


if __name__ == "__main__":
    main()

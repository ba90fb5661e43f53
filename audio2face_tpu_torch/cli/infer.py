"""Inference entry point: wav file(s) -> vertex animation (+ optional video).

Port of ``audio2face_tpu/cli/infer.py`` for FaceFormer (vocaset or
``--dataset biwi``). Decodes any number of clips of any length in padded
batches on one GPU.

Example:
    python -m audio2face_tpu_torch.cli.infer --audio clip.wav --subject 3 \
        --template assets/FLAME_sample.obj --output out/ --video

Without a checkpoint the weights are random (smoke mode). Checkpoint
loading, the streaming decoder and the frame models are not ported yet: their
options raise and name the ROADMAP.md item that brings them.
"""

import argparse
import os

import numpy as np

_NOT_PORTED = {
    "checkpoint": "loading the trainer's checkpoints into the predictor: ROADMAP.md queue 1 item 4",
    "torch_checkpoint": "loading reference PyTorch checkpoints: ROADMAP.md queue 1 item 4",
    "streaming": "the streaming front ends: ROADMAP.md queue 1 item 10",
    "config": "the frame models (audio2mesh/voca/song2face): ROADMAP.md queue 1 item 7",
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--audio", nargs="+", required=True, help="input wav file(s)")
    parser.add_argument("--subject", type=int, nargs="+", default=None,
                        help="style one-hot index per clip (default 0)")
    parser.add_argument("--template", required=True, help="FLAME template .obj/.ply")
    parser.add_argument("--checkpoint", default=None, help="trainer checkpoint (not ported yet)")
    parser.add_argument("--torch-checkpoint", default=None, help="reference .ckpt/.pt (not ported yet)")
    parser.add_argument("--output", default="output")
    parser.add_argument("--video", action="store_true", help="render mp4 per clip")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--f32", action="store_true")
    parser.add_argument("--streaming", action="store_true", help="not ported yet")
    parser.add_argument("--config", default=None,
                        help="experiment YAML for a frame model (not ported yet)")
    parser.add_argument("--dataset", choices=["vocaset", "biwi"], default="vocaset",
                        help="faceformer dataset family ('biwi': frames run at 25 fps)")
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    for name, what in _NOT_PORTED.items():
        if getattr(args, name):
            raise NotImplementedError(f"--{name.replace('_', '-')} is not ported yet ({what})")

    from audio2face_tpu_torch.serving import FaceFormerPredictor
    from audio2face_tpu_torch.utils.audio_io import read_wav
    from audio2face_tpu_torch.utils.facemesh import FaceMesh

    mesh = FaceMesh.load(args.template)
    print("WARNING: no checkpoint given: using random weights (smoke mode)")
    predictor = FaceFormerPredictor(
        n_verts=mesh.n_verts * 3, max_batch=args.batch, bf16=not args.f32,
        dataset=args.dataset, device=args.device,
    )

    audios, rates = [], set()
    for path in args.audio:
        wav, sr = read_wav(path)
        audios.append(wav)
        rates.add(sr)
    if len(rates) != 1:
        raise ValueError(f"all clips must share one sample rate, got {rates}")

    subjects = args.subject or [0] * len(audios)
    one_hot = np.eye(predictor.n_onehot, dtype=np.float32)[subjects]
    template = np.asarray(mesh.verts, np.float32)
    results = predictor(audios, one_hot, template, sample_rate=rates.pop())

    os.makedirs(args.output, exist_ok=True)
    for path, verts in zip(args.audio, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        out_npy = os.path.join(args.output, f"{stem}_verts.npy")
        np.save(out_npy, verts)
        print(f"{path}: {verts.shape[0]} frames -> {out_npy}")
        if args.video:
            from audio2face_tpu_torch.utils.renderer import Renderer, images_to_video

            renderer = Renderer(mesh, device=args.device)
            images = renderer.render(verts)
            images_to_video(images, os.path.join(args.output, stem), fps=predictor.fps)


if __name__ == "__main__":
    main()

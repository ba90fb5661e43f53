"""Standalone render script: every frame of a vertex animation to
``{output}/render_%d.png``, then an MP4 (ffmpeg if present, else cv2).

Port of ``audio2face_tpu/cli/render_frames.py``.

    python -m audio2face_tpu_torch.cli.render_frames --verts anim.npy --output out/
"""

import argparse
import os
import shutil
import subprocess

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--template", default="assets/FLAME_sample.obj")
    parser.add_argument("--verts", required=True, help=".npy vertex animation (T, V, 3)")
    parser.add_argument("--output", default="output")
    parser.add_argument("--framerate", type=int, default=60)
    parser.add_argument("--video-rate", type=int, default=30)
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    from audio2face_tpu_torch.utils.facemesh import FaceMesh
    from audio2face_tpu_torch.utils.renderer import Renderer

    os.makedirs(args.output, exist_ok=True)
    verts = np.load(args.verts)
    renderer = Renderer(FaceMesh.load(args.template), device=args.device)
    images = renderer.render(verts)

    import cv2

    for i, img in enumerate(images):
        cv2.imwrite(os.path.join(args.output, f"render_{i}.png"), img)

    video_path = os.path.join(args.output, "render.mp4")
    if shutil.which("ffmpeg"):
        subprocess.run(
            [
                "ffmpeg", "-y", "-framerate", str(args.framerate),
                "-i", os.path.join(args.output, "render_%d.png"),
                "-r", str(args.video_rate), "-c:v", "libx264", "-pix_fmt", "yuv420p",
                video_path,
            ],
            check=True,
        )
    else:
        h, w, _ = images[0].shape
        vw = cv2.VideoWriter(
            video_path, cv2.VideoWriter_fourcc(*"mp4v"), args.video_rate, (w, h), True
        )
        for img in images:
            vw.write(img)
        vw.release()
    print(f"Wrote {video_path}")


if __name__ == "__main__":
    main()

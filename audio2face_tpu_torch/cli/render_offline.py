"""Offline render entry point: load the template and a saved vertex
animation, render, write ``{output}/tmp.mp4``.

Port of ``audio2face_tpu/cli/render_offline.py``. Runs on a fresh clone:
when the default assets are absent (FLAME is licensed and cannot ship), a
synthetic template and animation are generated into ``assets/`` first.

    python -m audio2face_tpu_torch.cli.render_offline --output out/
"""

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--template", default="assets/FLAME_sample.obj")
    parser.add_argument("--verts", default="assets/verts_sample.npy")
    parser.add_argument("--output", default="output")
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = parser.parse_args(argv)

    from audio2face_tpu_torch.utils.facemesh import FaceMesh
    from audio2face_tpu_torch.utils.renderer import Renderer, images_to_video

    if os.path.exists(args.template) and not os.path.exists(args.verts):
        # derive the demo animation from THE GIVEN template so frame vertex
        # counts always match the mesh being rendered
        from audio2face_tpu_torch.data.synthetic import generate_demo_animation

        print(f"no vertex animation at {args.verts}; deriving one from {args.template}")
        os.makedirs(os.path.dirname(os.path.abspath(args.verts)), exist_ok=True)
        generate_demo_animation(args.template, args.verts)
    elif not os.path.exists(args.template):
        from audio2face_tpu_torch.data.synthetic import generate_demo_assets

        assets_dir = os.path.dirname(args.template) or "assets"
        print(f"default assets missing; generating a synthetic demo into {assets_dir}/")
        paths = generate_demo_assets(assets_dir)
        args.template = paths["template"]
        args.verts = args.verts if os.path.exists(args.verts) else paths["verts"]

    renderer = Renderer(FaceMesh.load(args.template), device=args.device)
    rendered_images = renderer.render(np.load(args.verts))
    images_to_video(rendered_images, args.output, fps=args.fps)


if __name__ == "__main__":
    main()

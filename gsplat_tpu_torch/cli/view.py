"""Live viewer CLI: serve a gaussian PLY for interactive orbit / selection /
per-label editing in the browser (the card renders, the browser displays).

    python -m gsplat_tpu_torch.cli.view --ply_file scene.ply --port 8000 \\
        [--camera_file cameras.json] [--session edits.json] [--device cpu]

The counterpart of ``gsplat_tpu.cli.view`` with the same flags, plus
``--device`` (default ``cuda``: the render runs on the card). The PLY is
read by the native codec; frames are served as PNG. ``--port 0`` binds a
free port, which the ``viewer at http://HOST:PORT/`` line names.
"""

from __future__ import annotations

import argparse

from gsplat_tpu_torch.interact.viewer import ViewerServer
from gsplat_tpu_torch.io import ply
from gsplat_tpu_torch.io.cameras import load_cameras
from gsplat_tpu_torch.scene import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ply_file", required=True)
    ap.add_argument("--camera_file", default=None,
                    help="cameras.json enabling 0-9/+/- dataset-camera "
                         "navigation (gaussians_selection.js:1159-1171)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--session", default=None,
                    help="JSON file persisting edits across runs")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scene = ply.scene_from_ply(args.ply_file, device=device)
    print(f"loaded {scene.num_gaussians} gaussians", flush=True)
    cameras = load_cameras(args.camera_file) if args.camera_file else None
    server = ViewerServer(scene, width=args.width, height=args.height,
                          session_path=args.session, cameras=cameras,
                          device=device)
    print("prewarming (builds the render's kernels at first use, renders "
          "one frame) ...", flush=True)
    server.prewarm()
    server.serve(args.host, args.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line entry points of the PyTorch port.

Counterpart of ``pathtracer_gaussiansplatting_tpu/cli.py``, with the same
subcommands, arguments, defaults, printed lines and files:

  render            one converged frame from a scene config -> PNG
  capture-dataset   the dataset capture: images, transforms, point cloud
  panorama          a 360-degree toroidal sweep
  fit               optimize a Gaussian scene against a rendered target
                    (the dense renderer)
  view-pointcloud   rasterize a captured point cloud
  interact          the headless interactive session, scripted
  bench             the benchmark harness (bench.py): one JSON line

One option is the port's own: ``--device``. By default (None) everything
runs on the CUDA card, and without one the command raises; ``--device
cpu`` runs it on the CPU (each kernel's plain PyTorch version).

Usage:
  python -m pathtracer_gaussiansplatting_tpu_torch.cli render --scene main_scene.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from pathtracer_gaussiansplatting_tpu_torch import bench  # noqa: E402
from pathtracer_gaussiansplatting_tpu_torch.core.camera import (  # noqa: E402
    Camera, generate_rays, look_at, toroidal_c2w,
)
from pathtracer_gaussiansplatting_tpu_torch.core.device import (  # noqa: E402
    resolve_device,
)
from pathtracer_gaussiansplatting_tpu_torch.core.types import (  # noqa: E402
    RenderSettings,
)
from pathtracer_gaussiansplatting_tpu_torch.data.capture import (  # noqa: E402
    capture_panorama, capture_scene_data, make_accumulating_renderer,
    make_tiled_pose_renderer, render_pose, resolve_backend,
)
from pathtracer_gaussiansplatting_tpu_torch.data.images import (  # noqa: E402
    save_png,
)
from pathtracer_gaussiansplatting_tpu_torch.data.ply import (  # noqa: E402
    load_point_cloud_ply, save_3dgs_ply,
)
from pathtracer_gaussiansplatting_tpu_torch.models.scene import (  # noqa: E402
    load_scene_from_config, random_cloud,
)
from pathtracer_gaussiansplatting_tpu_torch.parallel.train import (  # noqa: E402
    fit_scene,
)
from pathtracer_gaussiansplatting_tpu_torch.render.points import (  # noqa: E402
    render_point_cloud,
)
from pathtracer_gaussiansplatting_tpu_torch.render.reference import (  # noqa: E402
    render_radiance_dense,
)
from pathtracer_gaussiansplatting_tpu_torch.render.session import (  # noqa: E402
    InteractiveSession,
)
from pathtracer_gaussiansplatting_tpu_torch.sampling.strategies import (  # noqa: E402
    generate_samples,
)
from pathtracer_gaussiansplatting_tpu_torch.utils.config import (  # noqa: E402
    load_scene_config,
)


def _load(args):
    device = resolve_device(args.device)
    cfg = load_scene_config(args.scene)
    base = os.path.dirname(os.path.abspath(args.scene))
    scene, punctual = load_scene_from_config(cfg, base, device=device)
    settings = RenderSettings(
        max_depth=args.max_depth or cfg.max_depth,
        ambient=tuple(cfg.ambient_light),
        max_contribs=args.max_contribs,
    )
    return cfg, scene, punctual, settings


def _host(img) -> np.ndarray:
    return img.detach().cpu().numpy() if hasattr(img, "detach") \
        else np.asarray(img)


def cmd_render(args):
    cfg, scene, punctual, settings = _load(args)
    backend = resolve_backend(args.backend or cfg.backend,
                              scene.num_gaussians)
    c2w = toroidal_c2w(args.alpha, args.beta, cfg.torus.major_radius,
                       cfg.torus.height, device=scene.means.device)
    if backend.startswith("tiled"):
        bounce = backend.split("+", 1)[1] if "+" in backend else "auto"
        pose_render = make_tiled_pose_renderer(
            scene, settings, punctual, args.spp, bounce_backend=bounce)
        img = pose_render(c2w, args.width or cfg.width,
                          args.height or cfg.height, cfg.fov_y_deg)
    else:
        render_fn = make_accumulating_renderer(scene, settings, punctual,
                                               spp=args.spp,
                                               backend=backend)
        img = render_pose(render_fn, c2w, args.width or cfg.width,
                          args.height or cfg.height, cfg.fov_y_deg,
                          chunk=args.chunk)
    img = _host(img)
    save_png(args.output, np.clip(img, 0.0, 1.0))
    print(f"wrote {args.output} ({img.shape[1]}x{img.shape[0]}, "
          f"{args.spp} spp)")


def cmd_capture(args):
    cfg, scene, punctual, settings = _load(args)
    cap = cfg.capture
    out = capture_scene_data(
        scene, args.output, settings, torus=cfg.torus, punctual=punctual,
        accumulation_steps=args.spp or cap.accumulation_steps,
        total_positions=args.positions or cap.total_positions,
        min_beta=cap.min_beta, max_beta=cap.max_beta,
        image_divisor=cap.image_divisor,
        width=args.width or cfg.width, height=args.height or cfg.height,
        fov_y_deg=cfg.fov_y_deg,
        capture_images=cap.capture_images,
        capture_pointcloud=cap.capture_pointcloud,
        sampling_method=cfg.sampling_method,
        num_rays=args.num_rays, chunk=args.chunk,
        backend=args.backend or cfg.backend)
    print(json.dumps(dict(points=out["num_points"],
                          train=len(out["train_frames"]),
                          test=len(out["test_frames"]))))


def cmd_panorama(args):
    cfg, scene, punctual, settings = _load(args)
    capture_panorama(scene, args.output, settings, torus=cfg.torus,
                     punctual=punctual, beta=args.beta, steps=args.steps,
                     accumulation_steps=args.spp,
                     width=args.width or cfg.width,
                     height=args.height or cfg.height,
                     fov_y_deg=cfg.fov_y_deg, chunk=args.chunk,
                     backend=args.backend or cfg.backend)


def cmd_fit(args):
    cfg, scene, punctual, settings = _load(args)
    device = scene.means.device
    cam = Camera(c2w=look_at((0, 0.5, 4.0), (0, 0, 0), device=device),
                 fov_y_deg=cfg.fov_y_deg,
                 width=args.width or 64, height=args.height or 64)
    rays = generate_rays(cam)
    target = render_radiance_dense(scene, rays, settings)
    init = random_cloud(args.init_gaussians, seed=7,
                        spread=float(scene.means.abs().max()),
                        device=device)
    fitted, losses = fit_scene(init, rays, target, settings,
                               steps=args.steps, lr=args.lr)
    print(f"loss {losses[0]:.5f} -> {losses[-1]:.5f} over {args.steps} steps")
    if args.output:
        save_3dgs_ply(args.output, fitted)
        print(f"wrote {args.output}")


def cmd_view_pointcloud(args):
    """Point-cloud view of a captured points3d.ply."""
    device = resolve_device(args.device)
    cfg = load_scene_config(args.scene)
    pc = load_point_cloud_ply(args.ply)
    n = len(pc["positions"])
    cam = Camera(c2w=toroidal_c2w(args.alpha, args.beta,
                                  cfg.torus.major_radius, cfg.torus.height,
                                  device=device),
                 fov_y_deg=cfg.fov_y_deg,
                 width=args.width or cfg.width,
                 height=args.height or cfg.height)
    uv = None
    if args.mode == "torus":
        # The capture's (u, v) stream again (the sampling's fixed seed),
        # to place each point on the sensor surface.
        uv = np.asarray(generate_samples(args.sampling, n, seed=13))
    img = render_point_cloud(pc["positions"], pc["colors"],
                             pc.get("flags", np.ones(n)), cam,
                             mode=args.mode, uv=uv, torus=cfg.torus,
                             point_size=args.point_size)
    save_png(args.output, np.clip(_host(img), 0.0, 1.0))
    print(f"wrote {args.output}")


def cmd_interact(args):
    """Headless interactive session, scripted.

    Reads commands from the --commands file (default stdin), one a line:
      w/a/s/d/c/r/p/z/x/m/n/u/j/1..7   hotkeys (see render/session.py)
      look DX DY                        cursor deltas
      step [N]                          accumulate N samples (default 1)
      save PATH.png                     write the current image
      quit
    """
    _, scene, punctual, settings = _load(args)
    sess = InteractiveSession(scene, settings, width=args.width or 320,
                              height=args.height or 240, punctual=punctual)
    with (open(args.commands) if args.commands
          else contextlib.nullcontext(sys.stdin)) as stream:
        img = _run_session(sess, stream)
    if args.output and img is not None:
        save_png(args.output, img)


def _run_session(sess: InteractiveSession, stream):
    """Apply the command lines of ``stream`` to ``sess``; returns the last
    image (None before the first step)."""
    img = None
    for line in stream:
        parts = line.split()
        if not parts:
            continue
        cmd = parts[0].lower()
        if cmd == "quit":
            break
        elif cmd == "look":
            sess.look(float(parts[1]), float(parts[2]))
        elif cmd == "step":
            for _ in range(int(parts[1]) if len(parts) > 1 else 1):
                img = sess.step()
            print(f"frame {sess.frame} mode={sess.render_mode} "
                  f"cam={sess.camera_mode}")
        elif cmd == "save":
            if img is None:
                img = sess.step()
            save_png(parts[1], img)
            print(f"saved {parts[1]}")
        else:
            sess.key(cmd)
    return img


def cmd_bench(args):
    bench.main(device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pathtracer_gaussiansplatting_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument(
            "--device", default=None,
            help="torch device (default: the CUDA card; raises without "
                 "one); 'cpu' runs on the CPU")

    def common(sp, output_default):
        sp.add_argument("--scene", required=True, help="scene config JSON")
        sp.add_argument("--output", default=output_default)
        sp.add_argument("--spp", type=int, default=32)
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--max-depth", type=int, default=0)
        sp.add_argument("--max-contribs", type=int, default=64)
        sp.add_argument("--chunk", type=int, default=65536)
        sp.add_argument(
            "--backend", default=None,
            choices=("auto", "dense", "grid", "tiled+grid", "tiled+dense"),
            help="traversal backend (default: scene config value, then "
                 "'auto' = tiled+grid above the dense-scene threshold)")
        device_arg(sp)

    sp = sub.add_parser("render", help="render one frame")
    common(sp, "render.png")
    sp.add_argument("--alpha", type=float, default=0.0)
    sp.add_argument("--beta", type=float, default=15.0)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("capture-dataset", help="full dataset capture")
    common(sp, "dataset")
    sp.add_argument("--positions", type=int, default=0)
    sp.add_argument("--num-rays", type=int, default=None)
    sp.set_defaults(fn=cmd_capture)

    sp = sub.add_parser("panorama", help="360-degree sweep")
    common(sp, "dataset")
    sp.add_argument("--beta", type=float, default=0.0)
    sp.add_argument("--steps", type=int, default=360)
    sp.set_defaults(fn=cmd_panorama)

    sp = sub.add_parser("fit", help="fit a scene to rendered targets")
    common(sp, "fitted.ply")
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--lr", type=float, default=5e-3)
    sp.add_argument("--init-gaussians", type=int, default=500)
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("view-pointcloud",
                        help="rasterize a captured point cloud")
    sp.add_argument("--scene", required=True)
    sp.add_argument("--ply", required=True, help="points3d.ply from capture")
    sp.add_argument("--output", default="pointcloud.png")
    sp.add_argument("--mode", choices=("world", "torus"), default="world")
    sp.add_argument("--sampling", default="halton",
                    help="uv stream to reproject with in torus mode")
    sp.add_argument("--alpha", type=float, default=0.0)
    sp.add_argument("--beta", type=float, default=15.0)
    sp.add_argument("--width", type=int, default=0)
    sp.add_argument("--height", type=int, default=0)
    sp.add_argument("--point-size", type=int, default=2)
    device_arg(sp)
    sp.set_defaults(fn=cmd_view_pointcloud)

    sp = sub.add_parser(
        "interact", help="headless interactive session (scripted hotkeys)")
    common(sp, "")
    sp.add_argument("--commands", default=None,
                    help="command file (default: stdin)")
    sp.set_defaults(fn=cmd_interact)

    sp = sub.add_parser("bench", help="benchmark harness")
    device_arg(sp)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

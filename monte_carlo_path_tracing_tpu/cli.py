"""Command-line driver: the reference's `main()` (main.cpp:497-600) as a
real CLI. Every compile-time constant of the reference (scene path,
estimator choice, spp, resolution, RR, tone map, camera pushback) is a flag.

Usage examples:
    python -m monte_carlo_path_tracing_tpu.cli render scenes/cornell/cornell.obj \
        --spp 64 --estimator mis --out out.png
    python -m monte_carlo_path_tracing_tpu.cli render scenes/veach-mis/veach-mis.obj \
        --spp 10 --estimator mis --distance-scale 2 --out test.bmp \
        --checkpoint ckpt.npz --checkpoint-every 4
    python -m monte_carlo_path_tracing_tpu.cli inverse scenes/cornell/cornell.obj \
        --steps 200 --perturb 0.2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="path to <scene>.obj (xml/mtl beside it)")
    p.add_argument("--xml", default=None, help="override scene xml path")
    p.add_argument("--width", type=int, default=None, help="override xml width")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=10)
    p.add_argument(
        "--estimator", default="mis",
        choices=["brdf", "split", "mis", "shoot"],
    )
    p.add_argument(
        "--light-sampler", default="spherical_triangle",
        choices=["uniform_area", "spherical_triangle"],
    )
    p.add_argument("--rr", type=float, default=0.6, help="RR survival prob")
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-radiance", type=float, default=380.0)
    p.add_argument("--gamma", type=float, default=0.25)
    p.add_argument("--jitter", action="store_true", help="sub-pixel AA jitter")
    p.add_argument("--ray-chunk", type=int, default=1 << 16)
    p.add_argument(
        "--distance-scale", type=float, default=1.0,
        help="push the eye to Nx the lookat distance (reference '2x distance')",
    )
    p.add_argument("--fov-bug-compat", action="store_true")
    p.add_argument("--measure-bug-compat", action="store_true")
    p.add_argument("--branch-pdf-compat", action="store_true")
    p.add_argument("--ref-mis-weights", action="store_true")
    p.add_argument(
        "--ref-mis-full", action="store_true",
        help="full reference MIS parity: ref weights + occluded-blocker "
             "recursion via the regen work queue (implies --ref-mis-weights "
             "and --regen)",
    )
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--impl", default=None, choices=[None, "pallas", "matmul"],
                   help="intersection implementation (default auto)")
    p.add_argument("--accel", default="auto",
                   choices=["auto", "all_pairs", "grid"],
                   help="acceleration structure (auto = all_pairs; grid = "
                        "reference's uniform grid + 3D-DDA, C10/C12)")
    p.add_argument("--primary-cache", default=None, action="store_true",
                   help="cache per-pixel primary hits + depth-0 Arvo "
                        "prepare across spp (default auto: on when "
                        "eligible — no jitter, mis/brdf/split, no blocker)")
    p.add_argument("--no-primary-cache", dest="primary_cache",
                   action="store_false")
    p.add_argument("--ray-sort", action="store_true",
                   help="regen lane coherence sort (pure permutation; "
                        "opt-in)")


def _load_scene(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from monte_carlo_path_tracing_tpu.render.camera import push_back_camera
    from monte_carlo_path_tracing_tpu.scene import load_scene

    scene = load_scene(args.scene, args.xml, fov_bug_compat=args.fov_bug_compat)
    cam = scene.camera
    if args.width or args.height:
        cam = dataclasses.replace(
            cam,
            width=args.width or cam.width,
            height=args.height or cam.height,
        )
    if args.distance_scale != 1.0:
        cam = push_back_camera(cam, args.distance_scale)
    return dataclasses.replace(scene, camera=cam)


def _make_cfg(args, cam):
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    return RenderConfig(
        width=cam.width, height=cam.height, spp=args.spp,
        estimator=args.estimator, light_sampler=args.light_sampler,
        rr_prob=args.rr, max_depth=args.max_depth,
        max_radiance=args.max_radiance, gamma=args.gamma, seed=args.seed,
        pixel_jitter=args.jitter, ray_chunk=args.ray_chunk,
        fov_bug_compat=args.fov_bug_compat,
        measure_bug_compat=args.measure_bug_compat,
        branch_pdf_compat=args.branch_pdf_compat,
        ref_mis_weights=args.ref_mis_weights or getattr(args, "ref_mis_full", False),
        mis_blocker_compat=getattr(args, "ref_mis_full", False),
        use_pallas=None if args.impl is None else (args.impl == "pallas"),
        accel=args.accel,
        ray_sort=getattr(args, "ray_sort", False),
        primary_cache=getattr(args, "primary_cache", None),
    )


def cmd_render(args) -> int:
    from monte_carlo_path_tracing_tpu.render import film
    from monte_carlo_path_tracing_tpu.render.renderer import render_image
    from monte_carlo_path_tracing_tpu.utils import checkpoint as ckpt_mod

    scene = _load_scene(args)
    cfg = _make_cfg(args, scene.camera)

    start_spp, fb = 0, None
    if args.checkpoint and args.resume:
        try:
            ck = ckpt_mod.load(args.checkpoint)
            ckpt_mod.check_compatible(ck, cfg)
            start_spp, fb = ck.spp_done, ck.framebuffer_sum
            print(f"resuming from {args.checkpoint} at spp={start_spp}")
        except FileNotFoundError:
            pass

    if getattr(args, "ref_mis_full", False):
        args.regen = True   # the blocker queue lives in the regen renderer
    if args.regen:
        from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen

        on_launch = None
        if args.preview:
            # Progressive preview: the accumulating image after every device
            # launch (the reference's per-scanline framebuffer flush,
            # main.cpp:587, without a display server).
            def on_launch(img, spp_done):
                film.write_image(args.preview, img, cfg.max_radiance, cfg.gamma)
                print(f"preview @ spp {spp_done} -> {args.preview}",
                      file=sys.stderr, flush=True)

        kw = {}
        if args.preview_every:
            kw["max_samples_per_launch"] = (
                scene.camera.height * scene.camera.width * args.preview_every
            )
        r = render_image_regen(scene, cfg, lanes=args.lanes,
                               on_launch=on_launch, **kw)
        image, seconds = r.image, r.seconds
    # render_image handles chunking; with --checkpoint-every the render runs
    # in spp segments so the framebuffer sum is available to save atomically.
    elif args.checkpoint and args.checkpoint_every:
        h, w = scene.camera.height, scene.camera.width
        fb_sum = np.zeros((h, w, 3), np.float32) if fb is None else fb.copy()
        s = start_spp
        seconds = 0.0
        while s < cfg.spp:
            step = min(args.checkpoint_every, cfg.spp - s)
            seg_cfg = cfg.replace(spp=s + step)
            r = render_image(scene, seg_cfg, start_spp=s, framebuffer=fb_sum)
            fb_sum = r.image * (s + step)
            seconds += r.seconds
            s += step
            ckpt_mod.save(
                args.checkpoint,
                ckpt_mod.RenderCheckpoint(
                    framebuffer_sum=fb_sum, spp_done=s, seed=cfg.seed,
                    config=ckpt_mod.config_dict(cfg),
                ),
            )
            print(f"spp {s}/{cfg.spp} (checkpointed)", file=sys.stderr, flush=True)
        image = fb_sum / cfg.spp
    else:
        r = render_image(
            scene, cfg, start_spp=start_spp, framebuffer=fb,
            progress=lambda s, t: print(f"spp {s}/{t}", file=sys.stderr, flush=True),
        )
        image, seconds = r.image, r.seconds

    if args.out:
        film.write_image(args.out, image, cfg.max_radiance, cfg.gamma)
        print(f"wrote {args.out}")
    print(json.dumps({
        "seconds": round(seconds, 3),
        "spp": cfg.spp,
        "mean_radiance": float(np.mean(image)),
    }))
    return 0


def cmd_inverse(args) -> int:
    import jax.numpy as jnp

    from monte_carlo_path_tracing_tpu.diff.inverse import recover_materials

    scene = _load_scene(args)
    cfg = _make_cfg(args, scene.camera)
    fams = tuple(args.optimize.split(","))
    m = scene.materials
    # Perturb every optimized family (configs[3]: joint kd/ks/ns/radiance
    # recovery); untouched families keep their true values.
    init = dataclasses.replace(
        m,
        kd=jnp.clip(m.kd + args.perturb, 0.02, 0.95) if "kd" in fams else m.kd,
        ks=jnp.clip(m.ks - args.perturb * (m.ks > 0), 0.0, 0.95)
        if "ks" in fams else m.ks,
        ns=m.ns * 0.4 if "ns" in fams else m.ns,
        emission=m.emission * 0.5 if "emission" in fams else m.emission,
    )
    res = recover_materials(
        scene, init, cfg, steps=args.steps, lr=args.lr,
        rays_per_step=args.rays_per_step, seed=args.seed,
        optimize=fams,
        progress=lambda i, l: (
            print(f"step {i} loss {l:.6f}", file=sys.stderr, flush=True)
            if i % 10 == 0 else None
        ),
    )
    mae = lambda a, b: float(jnp.mean(jnp.abs(a - b)))
    out = {
        "final_loss": res.losses[-1], "steps": res.steps,
        "kd_mae": mae(res.materials.kd, m.kd),
        "ks_mae": mae(res.materials.ks, m.ks),
        "ns_rel_mae": float(jnp.mean(
            jnp.abs(jnp.log(res.materials.ns / m.ns))
        )),
        "emission_rel_mae": float(jnp.mean(jnp.where(
            m.emission.sum(-1) > 0,
            jnp.abs(res.materials.emission.sum(-1) - m.emission.sum(-1))
            / jnp.maximum(m.emission.sum(-1), 1e-9),
            0.0,
        ))),
    }
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    from monte_carlo_path_tracing_tpu.parallel.mesh import init_distributed_if_needed
    from monte_carlo_path_tracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    # Multi-host bring-up before any jax call touches the backend
    # (parallel/mesh.py; no-op unless launched under a multi-process
    # coordinator).
    init_distributed_if_needed()

    ap = argparse.ArgumentParser(prog="monte_carlo_path_tracing_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a cg23 scene")
    _add_render_args(pr)
    pr.add_argument("--out", default=None, help=".png/.bmp/.npy output")
    pr.add_argument("--checkpoint", default=None)
    pr.add_argument("--checkpoint-every", type=int, default=0)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument(
        "--regen", action="store_true",
        help="path-regeneration renderer (fastest forward path; no "
             "checkpointing)",
    )
    pr.add_argument("--lanes", type=int, default=1 << 16,
                    help="wavefront lanes for --regen")
    pr.add_argument("--preview", default=None, metavar="PATH",
                    help="with --regen: write the accumulating image here "
                         "after every launch (progressive display)")
    pr.add_argument("--preview-every", type=int, default=0, metavar="SPP",
                    help="with --preview: cap launches to SPP samples/pixel "
                         "so previews refresh at least that often")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("inverse", help="inverse-rendering recovery demo")
    _add_render_args(pi)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=0.1)
    pi.add_argument("--perturb", type=float, default=0.2)
    pi.add_argument("--rays-per-step", type=int, default=1024)
    pi.add_argument(
        "--optimize", default="kd,ks,ns,emission",
        help="comma list of material families to recover (configs[3] "
             "default: all four)",
    )
    pi.set_defaults(fn=cmd_inverse)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

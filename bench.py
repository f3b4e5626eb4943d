#!/usr/bin/env python
"""Headline benchmark: Veach MIS 1024x1024, MIS + Arvo spherical sampling.

Prints ONE JSON line: {"metric": "Mrays/s/chip", "value": ..., "unit":
"Mrays/s", "vs_baseline": ...}.

Definitions
-----------
- rays   = LOGICAL wavefront trace operations whose lane was live
           (extend + shadow), counted inside the integrator — the
           estimator's equal-work ray count. The primary-hit cache
           (integrator/regen.py, round 4) serves per-pixel-identical
           primary hits from one physical trace per pixel; those still
           count once per SAMPLE here (the workload is unchanged — same
           estimator, same sample count), and the physically-traced count
           is reported as rays_physical in the extra line.
- paths  = primary samples = pixels * spp.
- value  = rays / wall_seconds / 1e6 on ONE chip (the benchmark device).
- vs_baseline = our paths/s divided by the reference's 136 paths/s — the
  reference C++ renderer's derived MIS throughput at this scene/estimator
  (BASELINE.md: 9.216e6 paths / 67,500 s). Equal-work comparison: both
  sides count one full RR-terminated MIS path per primary sample.

Env knobs: BENCH_SPP (default 8), BENCH_RES (default 1024), BENCH_CHUNK
(default 2^14 lanes), BENCH_ESTIMATOR, BENCH_SCENE, BENCH_REPS (default 3),
BENCH_PRIMARY_CACHE, BENCH_JITTER.

Needs a GPU: on any other platform it exits non-zero before measuring.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REF_PATHS_PER_S = 136.0  # BASELINE.md, reference MIS 1x distance


def main() -> None:
    from monte_carlo_path_tracing_tpu.parallel.mesh import init_distributed_if_needed
    from monte_carlo_path_tracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    init_distributed_if_needed()  # multi-host no-op unless under a launcher

    import jax
    import jax.numpy as jnp

    from monte_carlo_path_tracing_tpu.utils.device import nvidia_smi, require_gpu

    dev = require_gpu()

    from monte_carlo_path_tracing_tpu.core import rng
    from monte_carlo_path_tracing_tpu.scene import load_scene
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    spp = int(os.environ.get("BENCH_SPP", "8"))
    res = int(os.environ.get("BENCH_RES", "1024"))
    chunk = int(os.environ.get("BENCH_CHUNK", str(1 << 14)))
    estimator = os.environ.get("BENCH_ESTIMATOR", "mis")
    scene_path = os.environ.get(
        "BENCH_SCENE",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "scenes", "veach-mis", "veach-mis.obj"),
    )

    scene = load_scene(scene_path)
    scene = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, width=res, height=res)
    )
    # BENCH_JITTER=1: sub-pixel AA jitter on — the primary-hit cache is
    # ineligible by definition (per-pixel primary dedup is exactly what
    # jitter forfeits), so this row runs the plain regen loop.
    jitter = os.environ.get("BENCH_JITTER", "0") == "1"
    cfg = RenderConfig(
        width=res, height=res, spp=spp, estimator=estimator,
        light_sampler="spherical_triangle", max_depth=16, ray_chunk=chunk,
        pixel_jitter=jitter, seed=0,
    )

    n_pix = res * res
    key = rng.base_key(cfg.seed)

    # Path-regeneration renderer (integrator/regen.py): full lane occupancy.
    from monte_carlo_path_tracing_tpu.integrator.regen import render_regen

    lanes = chunk
    n_dev = len(jax.devices())
    total_samples = n_pix * spp

    reps = int(os.environ.get("BENCH_REPS", "3"))
    rep_secs = []
    if n_dev > 1:
        # Several cards: pixels sharded over all of them, one regen loop
        # each (parallel/sharded.py). Metric stays per-chip.
        from monte_carlo_path_tracing_tpu.parallel import make_mesh
        from monte_carlo_path_tracing_tpu.parallel.sharded import (
            make_regen_sharded,
        )

        mesh = make_mesh((n_dev,), ("tiles",))
        cap = spp if os.environ.get("BENCH_PRIMARY_CACHE", "1") != "0" else None
        fn = make_regen_sharded(scene, cfg, mesh, lanes, spp_cap=cap,
                                with_physical=True)
        jax.block_until_ready(fn(scene, key, jnp.int32(1)))   # compile
        for _ in range(reps):
            t0 = time.perf_counter()
            fb, nrays, nphys = jax.block_until_ready(
                fn(scene, key, jnp.int32(spp)))
            rep_secs.append(time.perf_counter() - t0)
        checksum = float(np.asarray(fb).sum())
        total_rays = int(nrays)
        rays_physical = int(nphys) or total_rays
    else:
        # Primary-hit cache (round 4, integrator/regen.py): one primary
        # trace + one Arvo prepare per PIXEL per launch; the regen loop
        # handles depth >= 1 only. Same estimate/streams as the plain loop
        # (tests/test_primary_cache.py); BENCH_PRIMARY_CACHE=0 reverts.
        from monte_carlo_path_tracing_tpu.integrator.regen import (
            primary_cache_eligible,
        )

        use_cache = (os.environ.get("BENCH_PRIMARY_CACHE", "1") != "0"
                     and primary_cache_eligible(cfg))
        if not use_cache and "BENCH_CHUNK" not in os.environ:
            lanes = 1 << 15          # the uncached loop runs more lanes
        if use_cache:
            from monte_carlo_path_tracing_tpu.integrator.regen import (
                render_regen_cached,
            )

            def run(scene, key, rounds):
                # `rounds` stays traced so the 0-round warmup and the timed
                # run share one compiled program.
                return render_regen_cached(
                    scene, cfg, key, n_pix, spp, rounds, lanes=lanes
                )

            warm_arg = jnp.int32(0)
            timed_arg = jnp.int32(spp)
        else:
            def run(scene, key, total):
                return render_regen(scene, cfg, key, n_pix, total, lanes=lanes)

            warm_arg = jnp.int32(lanes)
            timed_arg = jnp.int32(total_samples)

        run_jit = jax.jit(run)
        jax.block_until_ready(run_jit(scene, key, warm_arg))  # compile
        for _ in range(reps):
            t0 = time.perf_counter()
            fb, nrays, iters, stats = jax.block_until_ready(
                run_jit(scene, key, timed_arg))
            rep_secs.append(time.perf_counter() - t0)
        checksum = float(np.asarray(fb).sum())
        total_rays = int(nrays)
        rays_physical = int(stats.rays_physical) or total_rays
    dt = min(rep_secs)

    if not np.isfinite(checksum) or checksum <= 0.0:
        print(f"FATAL: framebuffer checksum {checksum} is not a positive "
              "finite number — the render did not execute", file=sys.stderr)
        sys.exit(1)

    paths = total_samples
    mrays = total_rays / dt / 1e6 / n_dev  # per-chip
    paths_per_s = paths / dt

    result = {
        "metric": "Mrays/s/chip",
        "value": round(mrays, 4),
        "unit": "Mrays/s",
        "vs_baseline": round(paths_per_s / REF_PATHS_PER_S, 1),
    }
    extra = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": n_dev,
        "nvidia_smi": nvidia_smi(),   # card name, power limit
        "res": res, "spp": spp, "estimator": estimator, "jitter": jitter,
        # headline = best of BENCH_REPS full renders, each timed to
        # block_until_ready; the median and every rep alongside.
        "seconds": dt,
        "seconds_median": float(np.median(rep_secs)),
        "rep_seconds": rep_secs,
        "paths_per_s": round(paths_per_s, 1),
        # rays = LOGICAL estimator ray count (primary counted per sample);
        # rays_physical counts the primary once per pixel when the
        # primary-hit cache served it (integrator/regen.py round 4).
        "rays_per_path": round(total_rays / paths, 3),
        "total_rays": total_rays,
        "rays_physical": int(rays_physical),
        # physical-work throughput alongside the equal-work headline
        "mrays_physical": round(rays_physical / dt / 1e6 / n_dev, 4),
        "fb_checksum": checksum,
    }
    print(json.dumps(result))
    print("# " + json.dumps(extra), file=sys.stderr)


if __name__ == "__main__":
    main()

"""Render driver: spp-chunked, pixel-tiled, progressive, checkpointable.

The reference's driver is a doubly-nested pixel loop with a 10-sample inner
loop (main.cpp:557-588) and no recovery (a killed run loses everything,
SURVEY.md §5). Here the image is a flat pixel array processed in ray chunks
through one jitted sample pass; samples accumulate into an f32 framebuffer
that can be checkpointed (with the RNG state implicit in (seed, next spp))
and resumed — which also provides progressive rendering for free.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from monte_carlo_path_tracing_tpu.core import rng
from monte_carlo_path_tracing_tpu.integrator import render_rays
from monte_carlo_path_tracing_tpu.render.camera import generate_rays
from monte_carlo_path_tracing_tpu.scene.types import Scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig


@dataclasses.dataclass
class RenderResult:
    image: np.ndarray          # [H, W, 3] f32 mean radiance
    spp_done: int
    seconds: float
    rays_traced: int           # primary rays only (paths); see bench for defs


def _sample_pass(scene: Scene, cfg: RenderConfig, key, pixel_idx, sample_id,
                 accel=None):
    """Radiance of one sample for each pixel in the chunk — jitted once.

    Stream discipline (core/rng.py): each lane's key is
    fold(fold(base, sample_id), pixel_id), so the draws a pixel consumes are
    a function of (seed, pixel, sample) only — the image is invariant to
    `ray_chunk` (tests/test_render.py::test_chunk_invariance) and identical
    to the regeneration renderer's streams."""
    lane = rng.lane_keys(rng.sample_key(key, sample_id), pixel_idx)
    jitter = rng.bounce_key(lane, 0, rng.P_PIXEL_JITTER) if cfg.pixel_jitter else None
    ro, rd = generate_rays(scene.camera, pixel_idx, jitter_key=jitter)
    return render_rays(scene, cfg, lane, ro, rd, accel=accel)


def render_image_regen(
    scene: Scene,
    cfg: RenderConfig,
    lanes: int = 1 << 16,
    max_samples_per_launch: int = 16 << 20,
    on_launch: Optional[Callable[[np.ndarray, int], None]] = None,
) -> RenderResult:
    """Path-regeneration renderer (integrator/regen.py): full-occupancy
    wavefront, the fast path for forward renders and the benchmark.

    Long renders are split into multiple device launches of at most
    `max_samples_per_launch` paths: a single multi-minute while_loop
    execution can trip device-side execution watchdogs, and per-launch splitting also gives progressive accumulation for free.
    Streams are keyed by global (spp index, pixel id) — `spp0` rides into
    each launch — so the image is invariant to the launch split.

    ``on_launch(mean_image_hwc, spp_done)`` fires after every launch with
    the accumulated mean image so far — the progressive-display hook (the
    reference flushes its framebuffer per scanline, main.cpp:587; the CLI's
    --preview writes a PNG here).
    """
    from monte_carlo_path_tracing_tpu.integrator.regen import (
        primary_cache_eligible, render_regen, render_regen_cached,
    )

    cfg.validate()
    cam = scene.camera
    n_pix = cam.height * cam.width
    total = n_pix * cfg.spp
    key = rng.base_key(cfg.seed)

    # Whole-spp launches so the round-robin sample->pixel mapping stays
    # balanced within every launch.
    spp_per_launch = max(1, min(cfg.spp, max_samples_per_launch // n_pix))

    use_cache = (
        cfg.primary_cache if cfg.primary_cache is not None
        else primary_cache_eligible(cfg)
    )
    if use_cache:
        # Primary-hit cache: one primary trace + Arvo prepare per PIXEL per
        # launch, depth-0 shading dense, regen loop over the continuation
        # seeds only (same streams/estimate; integrator/regen.py).
        fn = jax.jit(
            lambda sc, k, rounds, s0: render_regen_cached(
                sc, cfg, k, n_pix, spp_per_launch, rounds, lanes=lanes,
                spp0=s0,
            )
        )
        warm_args = (jnp.int32(0), jnp.int32(0))        # 0 spp rounds
        launch_arg = lambda step, done: (jnp.int32(step), jnp.int32(done))
    else:
        fn = jax.jit(
            lambda sc, k, tot, s0: render_regen(
                sc, cfg, k, n_pix, tot, lanes=lanes, spp0=s0
            )
        )
        warm_args = (jnp.int32(min(lanes, total)), jnp.int32(0))
        launch_arg = lambda step, done: (jnp.int32(n_pix * step), jnp.int32(done))
    # warmup excluded from `seconds` (the traced sample count means the
    # tiny run compiles the same program as the real one)
    jax.block_until_ready(fn(scene, key, *warm_args))

    t0 = time.perf_counter()
    fb_acc = np.zeros((n_pix, 3), np.float32)
    rays = 0.0
    spilled = 0
    done = 0
    while done < cfg.spp:
        step = min(spp_per_launch, cfg.spp - done)
        fb, nrays, _, stats = fn(scene, key, *launch_arg(step, done))
        spilled += int(stats.spilled)
        fb_acc += np.asarray(fb)
        rays += float(nrays)
        done += step
        if on_launch is not None:
            on_launch(
                (fb_acc / done).reshape(cam.height, cam.width, 3), done
            )
    seconds = time.perf_counter() - t0
    if spilled:
        # Blocker-chain queue overflowed (mis_blocker_compat): `spilled`
        # chains were dropped — those lanes fall back to the restructured
        # (no-blocker) estimator. Surfaced, not silent.
        print(f"[regen] WARNING: {spilled} blocker chains spilled", flush=True)
    image = (fb_acc / cfg.spp).reshape(cam.height, cam.width, 3)
    return RenderResult(
        image=image, spp_done=cfg.spp, seconds=seconds, rays_traced=int(rays)
    )


def render_image(
    scene: Scene,
    cfg: RenderConfig,
    start_spp: int = 0,
    framebuffer: Optional[np.ndarray] = None,
    progress: Optional[Callable[[int, int], None]] = None,
) -> RenderResult:
    """Accumulate cfg.spp samples per pixel (resuming from start_spp if a
    framebuffer of summed radiance is given)."""
    cfg.validate()
    cam = scene.camera
    h, w = cam.height, cam.width
    n_pix = h * w
    key = rng.base_key(cfg.seed)

    fb = (
        np.zeros((n_pix, 3), np.float32)
        if framebuffer is None
        else framebuffer.reshape(n_pix, 3).astype(np.float32).copy()
    )

    chunk = min(cfg.ray_chunk, n_pix)
    pad = (-n_pix) % chunk
    idx_all = np.arange(n_pix + pad, dtype=np.int32)
    idx_all[n_pix:] = 0  # padded pixels recompute pixel 0; discarded below

    if cfg.accel == "grid":
        # Host-side CSR build happens once, eagerly, outside the jit; the
        # grid rides into the trace as a closed-over constant pytree.
        from monte_carlo_path_tracing_tpu.ops import grid as grid_mod

        grid = grid_mod.build_grid(scene, n0=cfg.grid_n0)
        pass_fn = jax.jit(
            lambda sc, cfg_, key, idx, s: _sample_pass(
                sc, cfg_, key, idx, s, accel=grid
            ),
            static_argnums=(1,),
        )
    else:
        pass_fn = jax.jit(_sample_pass, static_argnums=(1,))

    t0 = time.perf_counter()
    for s in range(start_spp, cfg.spp):
        for c0 in range(0, n_pix + pad, chunk):
            idx = jnp.asarray(idx_all[c0 : c0 + chunk])
            rad = np.asarray(pass_fn(scene, cfg, key, idx, s))
            lo, hi = c0, min(c0 + chunk, n_pix)
            fb[lo:hi] += rad[: hi - lo]
        if progress is not None:
            progress(s + 1, cfg.spp)
    seconds = time.perf_counter() - t0

    image = (fb / max(cfg.spp, 1)).reshape(h, w, 3)
    return RenderResult(
        image=image,
        spp_done=cfg.spp,
        seconds=seconds,
        rays_traced=(cfg.spp - start_spp) * n_pix,
    )

#!/usr/bin/env python
"""GPU smoke test: the path tracer's main path on the card, end to end.

    python chip_smoke.py              # one GPU, phases 1-5
    python chip_smoke.py --four-gpus  # four GPUs, phase 6 only

Phases, all in this one process (the CPU references run in-process too):
  1. device: platform, kind, count, card name and power limit, versions,
     compile-cache directory. Fails unless JAX's first device is a GPU.
  2. kernel parity: the Triton intersect kernels vs intersect_matmul at real
     widths (veach 16,384 and 65,536 rays, bathroom 16,384 rays), plus
     intersect_oracle on a 4,096-ray subset; memory analysis of the
     compiled regen step.
  3. kernel vs XLA times at the same shapes.
  4. end to end: veach 1024^2 x 8 spp (MIS + Arvo, depth 16) through
     ``cli.main(["render", ..., "--regen"])`` with the kernels and with the
     matmul path; 128x72 x 1 spp on the GPU vs the CPU; cornell 16^2 vs the
     committed golden; bathroom 640x360 x 16 spp.
  5. gradient: pixel gradients on the GPU vs the CPU, then three inverse
     steps through ``cli.main(["inverse", ...])``.
  6. (--four-gpus) the sharded regen renderer at 1024^2 x 8 spp over four
     cards vs the one-card image; one train step on a (2, 2) mesh vs the
     single-device gradient.

Any failed check raises and the exit code is non-zero; no phase is caught.
The last line of stdout is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "chiprun_out")

VEACH = os.path.join(REPO, "scenes", "veach-mis", "veach-mis.obj")
BATHROOM = os.path.join(REPO, "scenes", "bathroom", "bathroom.obj")
CORNELL = os.path.join(REPO, "scenes", "cornell", "cornell.obj")
GOLDEN = os.path.join(REPO, "tests", "golden", "cornell16_mis.npy")

SIZES = {
    "parity": [("veach", 16384), ("veach", 65536), ("bathroom", 16384)],
    "oracle_rays": 4096,
    "veach_res": 1024, "veach_spp": 8,
    "bathroom_res": (640, 360), "bathroom_spp": 16,
    "small_res": (128, 72),
    "grad_res": (32, 18),
    "inverse_res": 64, "inverse_steps": 3,
}

# Agreement floors of the kernels vs intersect_matmul. Both sides are f32
# with no TF32 (Precision.HIGHEST in XLA, FMAs in the kernel); they differ
# only in summation order and in the kernel's folded accept margin, so
# only rays within rounding of an edge, of the t_eps floor or of a tie
# between two triangles can flip.
VALID_FLOOR = 0.9999     # rays grazing an edge or the t_eps floor
TRI_ID_FLOOR = 0.999     # near-ties: shared edges, coplanar pairs
# Same triangle: t = (n.ro - n.v0) / det from the same exact-f32 algebra.
# Its rounding error is relative to the terms of the sum, not to t: for a
# ray that starts near a triangle's plane (a bounce leaving a surface) the
# numerator cancels. So |dt| is bounded by T_RTOL times sum_k |g_k W_k| / |det|.
T_RTOL = 1e-5
OCCLUDED_FLOOR = 0.9999  # as VALID_FLOOR, on the shadow segment's end too
# The oracle is another formula (Cramer's rule on s = ro - v0), so its
# rounding differs more; on 4,096 rays 99.99 % would be a zero-mismatch bar.
ORACLE_FLOOR = 0.999


def _print(*a):
    print(*a, flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    _print(f"  ok: {what}")


def _phase(name):
    def deco(fn):
        def run(*a, **k):
            _print(f"== {name}")
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _print(f"== {name}: done in {time.perf_counter() - t0:.1f} s")
            return out
        return run
    return deco


def _scene(path, width=None, height=None):
    from monte_carlo_path_tracing_tpu.scene import load_scene

    sc = load_scene(path)
    if width:
        cam = dataclasses.replace(sc.camera, width=width, height=height)
        sc = dataclasses.replace(sc, camera=cam)
    return sc


def _rel(a, b) -> float:
    import numpy as np

    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-30))


def _cli(argv) -> dict:
    """cli.main in-process; returns its JSON summary line."""
    from monte_carlo_path_tracing_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    _print("  cli " + " ".join(argv[:2]) + " -> " + text.strip().splitlines()[-1])
    _check(rc == 0, f"cli {argv[0]} exit code {rc} == 0")
    return json.loads(text.strip().splitlines()[-1])


def probe_rays(scene, accel, n, seed):
    """n rays shaped like a regen wavefront: half camera rays at random
    pixels of a 1024^2 frame, half bounce rays leaving their primary hit in
    a uniform random direction (excluding the hit triangle)."""
    import jax.numpy as jnp
    import numpy as np

    from monte_carlo_path_tracing_tpu.ops import intersect_ref as ir
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays

    rng = np.random.default_rng(seed)
    cam = dataclasses.replace(scene.camera, width=1024, height=1024)
    pix = jnp.asarray(rng.integers(0, 1024 * 1024, n), jnp.int32)
    ro, rd = generate_rays(cam, pix)
    h = ir.intersect_matmul(ro, rd, accel.W, accel.tri_ids)
    d = rng.normal(size=(n, 3))
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True), jnp.float32)
    sec = np.asarray(h.valid) & (np.arange(n) % 2 == 1)
    ro = jnp.where(sec[:, None], ro + h.t[:, None] * rd, ro)
    rd = jnp.where(sec[:, None], d, rd)
    ex = jnp.where(sec, h.tri_id, ir.NO_HIT).astype(jnp.int32)
    return ro, rd, ex


@_phase("1 device")
def phase_device(cache_dir):
    import jax
    import jaxlib

    from monte_carlo_path_tracing_tpu.utils.device import nvidia_smi, require_gpu

    dev = require_gpu()
    _print(f"platform {dev.platform} kind {dev.device_kind} "
           f"count {len(jax.devices())}")
    _print(nvidia_smi())
    _print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    _print(f"compile cache {cache_dir}")
    return dev


def _cases():
    from monte_carlo_path_tracing_tpu.ops import intersect as ops

    scenes = {"veach": _scene(VEACH), "bathroom": _scene(BATHROOM)}
    for name, n in SIZES["parity"]:
        sc = scenes[name]
        accel = ops.build_accel(sc)
        ro, rd, ex = probe_rays(sc, accel, n, seed=n)
        yield name, n, sc, accel, ro, rd, ex


def _slot_of(accel, tri_id):
    """Row of each global triangle id in the (Morton-ordered) accel."""
    import jax.numpy as jnp

    n = accel.tri_ids.shape[0]
    ids = jnp.where(accel.tri_ids >= 0, accel.tri_ids, n)   # padding: sink row
    slot = jnp.zeros((n + 1,), jnp.int32).at[ids].set(
        jnp.arange(n, dtype=jnp.int32))
    return slot[jnp.maximum(tri_id, 0)]


def _tmax(hit, n):
    import jax.numpy as jnp
    import numpy as np

    u = np.random.default_rng(n + 1).uniform(0.5, 1.5, n)
    return jnp.where(hit.valid, hit.t * jnp.asarray(u, jnp.float32), 1e3)


@_phase("2 kernel parity")
def phase_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from monte_carlo_path_tracing_tpu.ops import intersect as ops
    from monte_carlo_path_tracing_tpu.ops import intersect_pallas as ip
    from monte_carlo_path_tracing_tpu.ops import intersect_ref as ir

    rt = ip.TILES[0]
    for name, n, sc, accel, ro, rd, ex in _cases():
        sms = getattr(jax.devices()[0], "core_count", "?")
        _print(f"-- {name}: {n} rays x {sc.num_tris} triangles, grid "
               f"{-(-n // rt)} programs of {rt} rays on {sms} SMs, "
               f"tiles {ip.TILES}")
        hk = ops.intersect(accel, ro, rd, ex, impl="pallas")
        hm = ops.intersect(accel, ro, rd, ex, impl="matmul")
        vm = np.asarray(hm.valid)
        valid = (np.asarray(hk.valid) == vm).mean()
        same = np.asarray(hk.tri_id)[vm] == np.asarray(hm.tri_id)[vm]
        _print(f"  hit fraction {vm.mean():.4f}")
        _check(valid >= VALID_FLOOR, f"valid agreement {valid:.6f} >= {VALID_FLOOR}")
        _check(same.mean() >= TRI_ID_FLOOR,
               f"tri_id agreement on valid {same.mean():.6f} >= {TRI_ID_FLOOR}")
        both = vm & (np.asarray(hk.tri_id) == np.asarray(hm.tri_id))
        tk, tm = np.asarray(hk.t)[both], np.asarray(hm.t)[both]
        # rounding scale of t: sum_k |g_k W_k3| / |det| for the hit triangle
        W = accel.W[_slot_of(accel, hm.tri_id)]
        g = np.abs(np.asarray(ir.ray_features(ro, rd)))
        mag = np.einsum("nf,nf->n", g, np.abs(np.asarray(W[:, :, 3])))
        det = np.abs(np.einsum("nf,nf->n", np.asarray(ir.ray_features(ro, rd)),
                               np.asarray(W[:, :, 0])))
        scale = (mag / np.maximum(det, 1e-30))[both]
        t_rel = float(np.max(np.abs(tk - tm) / np.abs(tm))) if tm.size else 0.0
        t_cond = float(np.max(np.abs(tk - tm) / scale)) if tm.size else 0.0
        _print(f"  t max rel diff {t_rel:.3g} (relative to t)")
        _check(t_cond <= T_RTOL,
               f"t max diff {t_cond:.3g} of its rounding scale <= {T_RTOL}")
        t_max = _tmax(hm, n)
        ok_ = np.asarray(ops.occluded(accel, ro, rd, t_max, ex, impl="pallas"))
        om = np.asarray(ops.occluded(accel, ro, rd, t_max, ex, impl="matmul"))
        occ = (ok_ == om).mean()
        _print(f"  occluded fraction {om.mean():.4f}")
        _check(occ >= OCCLUDED_FLOOR, f"occluded agreement {occ:.6f} >= {OCCLUDED_FLOOR}")

        # the oracle on a subset, in chunks ([N, T, 3] temporaries)
        m = SIZES["oracle_rays"]
        ids = jnp.arange(sc.num_tris, dtype=jnp.int32)
        orc = [ir.intersect_oracle(ro[i:i + 1024], rd[i:i + 1024], sc.tri_v0,
                                   sc.tri_e1, sc.tri_e2, ids, ex[i:i + 1024])
               for i in range(0, m, 1024)]
        ov = np.concatenate([np.asarray(h.valid) for h in orc])
        oid = np.concatenate([np.asarray(h.tri_id) for h in orc])
        v_o = (np.asarray(hk.valid)[:m] == ov).mean()
        id_o = (np.asarray(hk.tri_id)[:m][ov] == oid[ov]).mean()
        _check(v_o >= ORACLE_FLOOR, f"oracle valid agreement {v_o:.6f} >= {ORACLE_FLOOR}")
        _check(id_o >= ORACLE_FLOOR, f"oracle tri_id agreement {id_o:.6f} >= {ORACLE_FLOOR}")

    # device memory of the compiled regen step at the headline size
    from monte_carlo_path_tracing_tpu.core import rng
    from monte_carlo_path_tracing_tpu.integrator.regen import render_regen_cached

    res, spp = SIZES["veach_res"], SIZES["veach_spp"]
    sc = _scene(VEACH, res, res)
    cfg = _headline_cfg(res, spp)
    step = jax.jit(lambda s, k, r: render_regen_cached(
        s, cfg, k, res * res, spp, r, lanes=1 << 16))
    compiled = step.lower(sc, rng.base_key(0), jnp.int32(0)).compile()
    _print(f"  regen step memory_analysis: {compiled.memory_analysis()}")


def _headline_cfg(res, spp):
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    return RenderConfig(width=res, height=res, spp=spp, estimator="mis",
                        light_sampler="spherical_triangle", max_depth=16,
                        seed=0)


@_phase("3 kernel vs XLA times")
def phase_times():
    from monte_carlo_path_tracing_tpu.ops import intersect as ops
    from monte_carlo_path_tracing_tpu.utils.timing import median_seconds

    import jax

    for name, n, sc, accel, ro, rd, ex in _cases():
        t_max = _tmax(ops.intersect(accel, ro, rd, ex, impl="matmul"), n)
        row = {}
        for kind in ("nearest", "occluded"):
            for impl in ("pallas", "matmul"):
                if kind == "nearest":
                    f = jax.jit(lambda a, b, c, t, impl=impl: ops.intersect(
                        accel, a, b, c, impl=impl))
                else:
                    f = jax.jit(lambda a, b, c, t, impl=impl: ops.occluded(
                        accel, a, b, t, c, impl=impl))
                row[kind, impl] = median_seconds(f, ro, rd, ex, t_max) * 1e3
            _print(f"  {name} {n} rays {kind}: kernel "
                   f"{row[kind, 'pallas']:.4f} ms, XLA "
                   f"{row[kind, 'matmul']:.4f} ms (median of 20)")


@_phase("4 end to end")
def phase_e2e():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from monte_carlo_path_tracing_tpu.integrator import render_rays
    from monte_carlo_path_tracing_tpu.render import film
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays
    from monte_carlo_path_tracing_tpu.render.renderer import render_image
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    os.makedirs(OUT, exist_ok=True)
    res, spp = SIZES["veach_res"], SIZES["veach_spp"]
    imgs, secs = {}, {}
    for impl in ("pallas", "matmul"):
        path = os.path.join(OUT, f"veach_{res}_{impl}.npy")
        out = _cli(["render", VEACH, "--width", str(res), "--height", str(res),
                    "--spp", str(spp), "--max-depth", "16", "--regen",
                    "--impl", impl, "--out", path])
        imgs[impl], secs[impl] = np.load(path), out["seconds"]
        _check(bool(np.isfinite(imgs[impl]).all()) and imgs[impl].mean() > 0,
               f"veach {res}^2 x {spp} spp ({impl}) finite and positive, mean "
               f"radiance {imgs[impl].mean():.6f}")
    _print(f"  veach {res}^2 x {spp} spp render seconds: kernel "
           f"{secs['pallas']:.4f}, XLA {secs['matmul']:.4f}")
    film.write_image(os.path.join(OUT, f"veach_{res}.png"), imgs["pallas"],
                     380.0, 0.25)
    rel = _rel(imgs["pallas"], imgs["matmul"])
    _check(rel <= 1e-3, f"kernel vs matmul image mean rel diff {rel:.3g} <= 1e-3")

    # GPU vs CPU on the same streams (CPU pinned to the matmul path)
    w, h = SIZES["small_res"]
    sc = _scene(VEACH, w, h)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=6, seed=0)
    ro, rd = generate_rays(sc.camera, jnp.arange(w * h, dtype=jnp.int32))
    key = jax.random.key(0)
    gpu = np.asarray(jax.jit(
        lambda s, k, o, d: render_rays(s, cfg, k, o, d))(sc, key, ro, rd))
    cpu_dev = jax.devices("cpu")[0]
    cfg_cpu = cfg.replace(use_pallas=False)
    with jax.default_device(cpu_dev):
        args = jax.device_put((sc, key, ro, rd), cpu_dev)
        cpu = np.asarray(jax.jit(
            lambda s, k, o, d: render_rays(s, cfg_cpu, k, o, d))(*args))
    rel = _rel(gpu, cpu)
    _check(np.isfinite(gpu).all() and rel < 1e-2,
           f"{w}x{h} x 1 spp GPU vs CPU mean rel diff {rel:.3g} < 1e-2")

    # golden: tests/test_render.py::test_golden_image_regression's config
    sc = _scene(CORNELL, 16, 16)
    cfg = RenderConfig(width=16, height=16, spp=2, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=4,
                       seed=123, ray_chunk=256)
    img = render_image(sc, cfg).image
    golden = np.load(GOLDEN)
    err = np.abs(img - golden)
    per_px = float(np.max(err / (1e-6 + np.abs(golden))))
    _print(f"  golden: max abs diff {err.max():.3g}, max per-pixel rel diff "
           f"{per_px:.3g}, mean rel diff {_rel(img, golden):.3g}")
    # The CPU test holds each pixel to rtol 1e-5. Here the GPU's sin, cos,
    # acos, atan2, sqrt and log round differently in the last ulp, and a
    # pixel is a sum of products of them, so the agreement is f32 round-off
    # relative to the image's radiance scale: 1e-5 of its maximum.
    scale = float(np.abs(golden).max())
    _check(float(err.max()) <= 1e-5 * scale and _rel(img, golden) <= 1e-5,
           f"cornell 16^2 matches the golden within 1e-5 of its radiance "
           f"scale {scale:.3g} (mean rel diff <= 1e-5)")

    bw, bh = SIZES["bathroom_res"]
    path = os.path.join(OUT, f"bathroom_{bw}.npy")
    out = _cli(["render", BATHROOM, "--width", str(bw), "--height", str(bh),
                "--spp", str(SIZES["bathroom_spp"]), "--max-depth", "16",
                "--regen", "--out", path])
    img = np.load(path)
    _check(bool(np.isfinite(img).all()) and img.mean() > 0,
           f"bathroom {bw}x{bh} x {SIZES['bathroom_spp']} spp finite and "
           f"positive, mean radiance {img.mean():.6f}, {out['seconds']:.4f} s")


@_phase("5 gradient")
def phase_grad():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from monte_carlo_path_tracing_tpu.core import rng
    from monte_carlo_path_tracing_tpu.diff.grad import pixel_grad
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    w, h = SIZES["grad_res"]
    sc = _scene(VEACH, w, h)
    n = w * h
    ro, rd = generate_rays(sc.camera, jnp.arange(n, dtype=jnp.int32))
    key = rng.lane_keys(rng.sample_key(rng.base_key(0), 0),
                        jnp.arange(n, dtype=jnp.int32))
    sel = jnp.ones((n, 3))
    cfg = RenderConfig(width=w, height=h, spp=1, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=4, seed=0)

    def grads(cfg_, *args):
        g = jax.jit(lambda s, k, o, d, m: pixel_grad(s, cfg_, k, o, d, m))(*args)
        return np.concatenate([np.asarray(x).ravel()
                               for x in jax.tree_util.tree_leaves(g)])

    g_gpu = grads(cfg, sc, key, ro, rd, sel)
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        g_cpu = grads(cfg.replace(use_pallas=False),
                      *jax.device_put((sc, key, ro, rd, sel), cpu_dev))
    cos = float(g_gpu @ g_cpu / (np.linalg.norm(g_gpu) * np.linalg.norm(g_cpu)))
    _check(np.isfinite(g_gpu).all() and cos >= 0.9999,
           f"{w}x{h} pixel gradients GPU vs CPU cosine {cos:.6f} >= 0.9999")

    r = SIZES["inverse_res"]
    out = _cli(["inverse", CORNELL, "--width", str(r), "--height", str(r),
                "--steps", str(SIZES["inverse_steps"])])
    _check(bool(np.isfinite(out["final_loss"])),
           f"{SIZES['inverse_steps']} inverse steps, final loss {out['final_loss']}")


@_phase("6 four GPUs")
def phase_four():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from monte_carlo_path_tracing_tpu.core import rng
    from monte_carlo_path_tracing_tpu.integrator import render_rays
    from monte_carlo_path_tracing_tpu.parallel import make_mesh, make_train_step
    from monte_carlo_path_tracing_tpu.parallel.sharded import (
        deinterleave_framebuffer, make_regen_sharded,
    )
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays
    from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    _check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices >= 4")
    devs = jax.devices()[:4]
    res, spp = SIZES["veach_res"], SIZES["veach_spp"]
    sc = _scene(VEACH, res, res)
    cfg = _headline_cfg(res, spp)
    mesh = make_mesh((4,), ("tiles",), devices=devs)
    fn = make_regen_sharded(sc, cfg, mesh, lanes_per_device=1 << 16,
                            spp_cap=spp)
    jax.block_until_ready(fn(sc, rng.base_key(0), jnp.int32(0)))
    t0 = time.perf_counter()
    fb, nrays = jax.block_until_ready(fn(sc, rng.base_key(0), jnp.int32(spp)))
    dt = time.perf_counter() - t0
    img4 = deinterleave_framebuffer(fb, 4).reshape(res, res, 3) / spp
    ref = render_image_regen(sc, cfg, lanes=1 << 16)
    _print(f"  4-card render {dt:.4f} s, 1-card render {ref.seconds:.4f} s")
    err = np.abs(img4 - ref.image)
    # Radiance sums of non-negative f32 terms taken in another order (the
    # scatter-adds are atomics): the repo's CPU test tolerance.
    _print(f"  max abs diff {err.max():.3g}, mean rel diff {_rel(img4, ref.image):.3g}")
    _check(bool(np.all(err <= 1e-5 + 1e-4 * np.abs(ref.image))),
           f"4-card {res}^2 x {spp} spp image == 1-card within rtol 1e-4, atol 1e-5")

    # one train step on a (2, 2) mesh vs the same loss differentiated on
    # one device
    w, h = SIZES["grad_res"]
    sc = _scene(CORNELL, w, h)
    tcfg = RenderConfig(spp=1, estimator="mis", max_depth=4, seed=0)
    n = 2 * (w * h // 2)
    ro, rd = generate_rays(sc.camera, jnp.arange(n, dtype=jnp.int32))
    key = jax.random.key(0)
    target = render_rays(sc, tcfg, jax.random.key(1), ro, rd)
    mats = dataclasses.replace(
        sc.materials, kd=jnp.clip(sc.materials.kd + 0.1, 0.0, 1.0))
    lr = 0.1
    step = make_train_step(sc, tcfg, make_mesh((2, 2), ("tiles", "spp"),
                                               devices=devs), lr=lr)
    new4, loss4 = step(mats, key, ro, rd, target)

    def loss1(m):
        s = sc.with_materials(m)
        total = 0.0
        for t in range(2):        # the two ray shards, each spp-averaged
            sl = slice(t * n // 2, (t + 1) * n // 2)
            rad = sum(render_rays(s, tcfg, jax.random.fold_in(key, k),
                                  ro[sl], rd[sl]) for k in range(2)) / 2
            total = total + jnp.sum((rad - target[sl]) ** 2)
        return total / (n * 3)

    l1, g1 = jax.jit(jax.value_and_grad(loss1))(mats)
    new1 = jax.tree.map(lambda p, g: p - lr * g, mats, g1)
    flat = lambda t: np.concatenate(
        [np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(t)])
    d4, d1 = flat(mats) - flat(new4), flat(mats) - flat(new1)
    cos = float(d4 @ d1 / (np.linalg.norm(d4) * np.linalg.norm(d1)))
    _print(f"  loss 4-card {float(loss4):.6g} vs 1-device {float(l1):.6g}")
    _check(abs(float(loss4) - float(l1)) <= 1e-4 * abs(float(l1)),
           "train-step loss equal within f32 reduction order (rtol 1e-4)")
    _check(np.allclose(d4, d1, rtol=1e-3, atol=1e-7) and cos >= 0.9999,
           f"(2, 2)-mesh update == single-device gradient step, cosine "
           f"{cos:.6f} (rtol 1e-3: f32 psum order)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    from monte_carlo_path_tracing_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    cache_dir = enable_compile_cache()
    import jax

    dev = phase_device(cache_dir)
    if args.four_gpus:
        phase_four()
    else:
        phase_parity()
        phase_times()
        phase_e2e()
        phase_grad()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

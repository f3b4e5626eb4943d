#!/usr/bin/env python
"""configs[3] flagship artifact: joint 4-family inverse recovery
(kd + ks + shininess + light radiance, nothing frozen) at a serious
optimization budget, with committed before/target/after renders.

Two scenes ride in one artifact (docs/inverse_joint_recovery.json):

  - veach-mis: the flagship crop. Specular-dominated — the kd signal at
    the probe is weak (see grad_probe below), which the earlier runs
    showed as kd recovering far slower than ks/ns/emission.
  - cornell: diffuse-dominated counterpart where kd carries the image —
    the run that demonstrates kd recovery itself.

Per-family gradient diagnosis: `grad_probe` measures RMS latent-gradient
magnitude per family at the init point over independent batches — the
direct test of "is kd's signal present at the probe, or is its slow
recovery an optimization artifact?".

Writes docs/inverse_joint_recovery.json and
docs/img/inverse_{target,init,final}[_cornell].png.

Env knobs: INV_STEPS, INV_RAYS, INV_LR, INV_WH ("48x27"), INV_SPP,
INV_SCENES ("veach-mis,cornell").
"""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from monte_carlo_path_tracing_tpu.diff import grad as dgrad
from monte_carlo_path_tracing_tpu.diff.inverse import recover_materials
from monte_carlo_path_tracing_tpu.integrator import render_rays
from monte_carlo_path_tracing_tpu.render import film
from monte_carlo_path_tracing_tpu.render.camera import generate_rays
from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu.scene import load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT = os.path.join(HERE, "docs", "inverse_joint_recovery.json")
IMG = os.path.join(HERE, "docs", "img")


def preview(scene, materials, path, tone=(380.0, 0.25)):
    """256x144 x 32spp regen render of the scene under `materials`."""
    sc = dataclasses.replace(
        scene.with_materials(materials),
        camera=dataclasses.replace(scene.camera, width=256, height=144),
    )
    cfg = RenderConfig(width=256, height=144, spp=32, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=8, seed=7)
    r = render_image_regen(sc, cfg, lanes=1 << 14)
    film.write_image(path, r.image, *tone)
    return float(r.image.mean())


def grad_probe(scene, init, cfg, rays=4096, batches=16, loss_clip=5.0):
    """RMS latent-gradient per material family at the init point."""
    cam = scene.camera
    n_pix = cam.width * cam.height
    squash = lambda x: x / (1.0 + x / loss_clip)
    lm0 = dgrad.to_latent(init)

    def loss(lm, key, ro, rd, target):
        sc = scene.with_materials(dgrad.from_latent(lm))
        k1, k2 = jax.random.split(key)
        r1 = squash(render_rays(sc, cfg, k1, ro, rd))
        r2 = squash(render_rays(sc, cfg, k2, ro, rd))
        return jnp.mean((r1 - target) * (r2 - target))

    @jax.jit
    def one(key):
        k_pix, k_t, k_r = jax.random.split(key, 3)
        idx = jax.random.randint(k_pix, (rays,), 0, n_pix, dtype=jnp.int32)
        ro, rd = generate_rays(cam, idx)
        target = squash(render_rays(scene, cfg, k_t, ro, rd))
        return jax.grad(loss)(lm0, k_r, ro, rd, target)

    acc = {"kd_l": [], "ks_l": [], "ns_l": [], "emission_l": []}
    for b in range(batches):
        g = one(jax.random.key(1000 + b))
        for name in acc:
            acc[name].append(float(jnp.sqrt(jnp.mean(
                jnp.square(getattr(g, name)) )) ))
    return {k: round(float(np.mean(v)), 6) for k, v in acc.items()}


def run_scene(name, wh, steps, rays, lr, spp, suffix=""):
    w, h = (int(x) for x in wh.split("x"))
    scene = load_scene(os.path.join(HERE, "scenes", name,
                                    f"{'veach-mis' if 'veach' in name else name}.obj"))
    scene = dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, width=w, height=h))
    cfg = RenderConfig(spp=spp, estimator="mis", max_depth=3, seed=0)
    m = scene.materials
    init = dataclasses.replace(
        m,
        kd=jnp.clip(m.kd + 0.15 * (m.kd.sum(-1, keepdims=True) > 0), 0.02, 0.95),
        ks=jnp.clip(m.ks - 0.3 * (m.ks > 0), 0.0, 0.95),
        ns=m.ns * 0.4,
        emission=m.emission * 0.5,
    )

    os.makedirs(IMG, exist_ok=True)
    tone = (380.0, 0.25) if "veach" in name else (40.0, 0.45)
    preview(scene, m, os.path.join(IMG, f"inverse_target{suffix}.png"), tone)
    preview(scene, init, os.path.join(IMG, f"inverse_init{suffix}.png"), tone)

    probe = grad_probe(scene, init, cfg, rays=rays)
    print(name, "grad probe (RMS latent grad per family):",
          json.dumps(probe), flush=True)

    res = recover_materials(
        scene, init, cfg, steps=steps, lr=lr, rays_per_step=rays, seed=2,
        loss_clip=5.0,
        progress=lambda i, l: (i % 100 == 0) and print(
            f"{name} step {i}: loss {l:.4f}", flush=True),
    )
    r = res.materials
    preview(scene, r, os.path.join(IMG, f"inverse_final{suffix}.png"), tone)

    spec = np.asarray(m.ks).sum(1) > 0
    lit = np.asarray(m.emission).sum(1) > 0
    vis = (np.asarray(m.kd).sum(1) > 0) & ~lit
    mae = lambda a, b, k: float(np.abs(np.asarray(a) - np.asarray(b))[k].mean())

    # Coverage-weighted MAE: weight each triangle's error by its
    # primary-hit count from the inverse camera — the unweighted mean
    # counts a never-visible triangle the same as a full-frame wall (the
    # r4 analysis showed exactly this flooring veach kd).
    from monte_carlo_path_tracing_tpu.ops import intersect as oi
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays as _gr

    idx_all = np.arange(w * h, dtype=np.int32)
    ro_all, rd_all = _gr(scene.camera, jnp.asarray(idx_all))
    hit = oi.intersect(oi.build_accel(scene), ro_all, rd_all, impl="matmul")
    # materials are a per-MATERIAL table; map triangle hits -> material rows
    wts = np.zeros(np.asarray(m.kd).shape[0])
    tid, okm = np.asarray(hit.tri_id), np.asarray(hit.valid)
    mat_of_tri = np.asarray(scene.tri_mat_id)
    np.add.at(wts, mat_of_tri[tid[okm]], 1.0)

    def wmae(a, b, k):
        err = np.abs(np.asarray(a) - np.asarray(b))
        if err.ndim > 1:
            err = err.mean(axis=-1)
        ww = wts * k
        return float((ww * err).sum() / max(ww.sum(), 1e-9))
    out = {
        "kd": [mae(init.kd, m.kd, vis), mae(r.kd, m.kd, vis)],
        "ks": [mae(init.ks, m.ks, spec), mae(r.ks, m.ks, spec)],
        "ns_log": [
            float(np.abs(np.log(np.asarray(init.ns) / np.asarray(m.ns)))[spec].mean()),
            float(np.abs(np.log(np.asarray(r.ns) / np.asarray(m.ns)))[spec].mean()),
        ],
        "em_rel": [0.5, float((np.abs(
            np.asarray(r.emission).sum(1) - np.asarray(m.emission).sum(1)
        )[lit] / np.asarray(m.emission).sum(1)[lit]).mean())],
        # coverage-weighted (primary-hit-count) counterparts
        "kd_wtd": [wmae(init.kd, m.kd, vis), wmae(r.kd, m.kd, vis)],
        "ks_wtd": [wmae(init.ks, m.ks, spec), wmae(r.ks, m.ks, spec)],
        "ns_log_wtd": [
            wmae(np.log(np.maximum(np.asarray(init.ns), 1e-6)),
                 np.log(np.maximum(np.asarray(m.ns), 1e-6)), spec),
            wmae(np.log(np.maximum(np.asarray(r.ns), 1e-6)),
                 np.log(np.maximum(np.asarray(m.ns), 1e-6)), spec),
        ],
        "grad_probe_at_init": probe,
        "losses_every50": [round(x, 5) for x in res.losses[::50]],
        "loss_tail_mean": round(float(np.mean(res.losses[-100:])), 5),
        "steps": steps, "lr": lr, "rays": rays, "clip": 5.0,
        "schedule": "cosine", "scene": f"{name} {w}x{h}", "spp": spp,
        "depth": 3,
    }
    print(name, json.dumps({k: out[k] for k in ("kd", "ks", "ns_log", "em_rel")}),
          flush=True)
    return out


def main():
    steps = int(os.environ.get("INV_STEPS", "1500"))
    rays = int(os.environ.get("INV_RAYS", "4096"))
    lr = float(os.environ.get("INV_LR", "0.06"))
    spp = int(os.environ.get("INV_SPP", "1"))
    scenes = os.environ.get("INV_SCENES", "veach-mis,cornell").split(",")

    runs = {}
    if "veach-mis" in scenes:
        runs["veach-mis"] = run_scene(
            "veach-mis", os.environ.get("INV_WH", "48x27"), steps, rays, lr, spp)
    if "cornell" in scenes:
        runs["cornell"] = run_scene(
            "cornell", os.environ.get("INV_WH_CORNELL", "32x32"),
            steps, rays, lr, spp, suffix="_cornell")

    out = {
        "runs": runs,
        "kd_best": min(r["kd"][1] for r in runs.values()),
        "analysis": (
            "veach-mis is specular-dominated: the kd latent-gradient RMS at "
            "the probe is far below ks/ns/emission (grad_probe_at_init), so "
            "kd moves on a lower-SNR signal there — an estimation-problem "
            "property, not an optimizer defect. The cornell run, where kd "
            "carries the image, demonstrates kd recovery under the identical "
            "4-family joint setup."
        ),
        "images": "docs/img/inverse_{target,init,final}[_cornell].png "
                  "(256x144x32spp)",
    }
    print(json.dumps({"kd_best": out["kd_best"]}))
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Scaling curves of the sharded renderer / train step over an N-device mesh.

BASELINE.json asks for >=80% rays/s scaling efficiency from 1 chip to >=2
hosts. Real multi-chip hardware is not available in this environment, so
this harness runs the same code paths on the virtual CPU mesh
(--xla_force_host_platform_device_count): it measures (a) the OVERHEAD of
the sharding machinery at fixed total work — the part of scaling loss that
is ours rather than the silicon's — as a 1/2/4/8-device curve, and (b) the
weak-scaling curve (fixed work per device), which on a shared-silicon host
is bounded by core oversubscription: with `nproc` cores, the compute-bound
ideal for nd devices is t1 * max(1, nd/nproc), and efficiency is reported
both raw and against that bound. A true 2-process cluster run (the
multi-host recipe of tests/test_multiprocess.py) is folded into the same
artifact. Run with SCALE_PLATFORM=gpu on a multi-GPU host for real NVLink
numbers.

Writes docs/scaling_cpu_mesh.json.
"""

import os
import socket
import subprocess
import sys
import time

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = os.environ.get("SCALE_PLATFORM", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from monte_carlo_path_tracing_tpu.parallel import make_mesh, render_rays_sharded
from monte_carlo_path_tracing_tpu.parallel.sharded import (
    make_regen_sharded, make_train_step,
)
from monte_carlo_path_tracing_tpu.render.camera import generate_rays
from monte_carlo_path_tracing_tpu.scene import load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _render_time(scene, cam, cfg, key, nd, n, reps=3):
    mesh = make_mesh((nd,), ("tiles",), devices=jax.devices()[:nd])
    idx = jnp.arange(n, dtype=jnp.int32) % (cam.width * cam.height)
    ro, rd = generate_rays(cam, idx)
    np.asarray(render_rays_sharded(scene, cfg, key, ro, rd, mesh))  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = render_rays_sharded(scene, cfg, key, ro, rd, mesh)
    np.asarray(out)
    return (time.perf_counter() - t0) / reps


def _regen_time(scene, cfg, key, nd, lanes_per_dev, spp):
    mesh = make_mesh((nd,), ("tiles",), devices=jax.devices()[:nd])
    fn = make_regen_sharded(scene, cfg, mesh, lanes_per_dev)
    np.asarray(fn(scene, key, jnp.int32(1))[0])                     # warm
    t0 = time.perf_counter()
    fb, nrays = fn(scene, key, jnp.int32(spp))
    np.asarray(fb)
    return time.perf_counter() - t0, float(nrays)


def _train_time(scene, cfg, key, nd, n, reps=3):
    mesh = make_mesh((nd,), ("tiles",), devices=jax.devices()[:nd])
    idx = jnp.arange(n, dtype=jnp.int32) % (scene.camera.width * scene.camera.height)
    ro, rd = generate_rays(scene.camera, idx)
    target = jnp.full((n, 3), 0.25)
    step = make_train_step(scene, cfg, mesh, lr=0.0)
    out = step(scene.materials, key, ro, rd, target)
    jax.block_until_ready(out)                                      # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(scene.materials, key, ro, rd, target)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


_TIMED_WORKER = r"""
import os, sys, time, dataclasses
import numpy as np
sys.path.insert(0, os.environ["MCPT_REPO"])
from monte_carlo_path_tracing_tpu.parallel.mesh import init_distributed_if_needed
init_distributed_if_needed()
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from monte_carlo_path_tracing_tpu.parallel import make_mesh, make_train_step
from monte_carlo_path_tracing_tpu.parallel.sharded import make_regen_sharded
from monte_carlo_path_tracing_tpu.render.camera import generate_rays
from monte_carlo_path_tracing_tpu.scene import load_scene
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

sc = load_scene(os.path.join(os.environ["MCPT_REPO"], "scenes", "cornell", "cornell.obj"))
sc = dataclasses.replace(sc, camera=dataclasses.replace(sc.camera, width=32, height=32))
cfg = RenderConfig(spp=1, estimator="mis", max_depth=4, seed=0)
mesh = make_mesh((8,), ("tiles",))
sc = jax.device_put(sc, NamedSharding(mesh, P()))
tiles = NamedSharding(mesh, P("tiles"))
idx = jnp.arange(1024, dtype=jnp.int32)
ro_h, rd_h = map(np.asarray, generate_rays(sc.camera, idx))
tgt_h = np.full((1024, 3), 0.25, np.float32)
mk = lambda h: jax.make_array_from_callback(h.shape, tiles, lambda i: h[i])
ro, rd, target = mk(ro_h), mk(rd_h), mk(tgt_h)
step = make_train_step(sc, cfg, mesh, lr=0.1)
out = step(sc.materials, jax.random.key(0), ro, rd, target)
jax.block_until_ready(out)
t0 = time.perf_counter()
out = step(sc.materials, jax.random.key(0), ro, rd, target)
jax.block_until_ready(out)
t_step = time.perf_counter() - t0
regen = make_regen_sharded(sc, cfg, mesh, lanes_per_device=64)
fb, nrays = regen(sc, jax.random.key(0), jnp.int32(1))
jax.block_until_ready(fb)
t0 = time.perf_counter()
fb, nrays = regen(sc, jax.random.key(0), jnp.int32(2))
jax.block_until_ready(fb)
t_regen = time.perf_counter() - t0
print("TIMED_OK", jax.process_index(), round(t_step, 4), round(t_regen, 4),
      float(out[1]), int(nrays), flush=True)
"""


def _cluster_run():
    """2-process x 4-virtual-device cluster (multi-host recipe): returns
    {ok, train_step_s, regen_s} or {ok: False, error}."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        worker = os.path.join(d, "worker.py")
        with open(worker, "w") as f:
            f.write(_TIMED_WORKER)
        s = socket.socket(); s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]; s.close()
        procs = []
        for pid in (0, 1):
            env = dict(os.environ)
            env.update(
                JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                MCPT_REPO=HERE,
            )
            procs.append(subprocess.Popen(
                [sys.executable, worker], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=900)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, out in zip(procs, outs):
            if p.returncode != 0 or "TIMED_OK" not in out:
                return {"ok": False, "error": out[-2000:]}
        line = [l for l in outs[0].splitlines() if l.startswith("TIMED_OK")][0]
        _, _, t_step, t_regen, loss, nrays = line.split()
        return {
            "ok": True, "processes": 2, "devices": 8,
            "train_step_s": float(t_step), "regen_s": float(t_regen),
            "loss_finite": np.isfinite(float(loss)).item(),
        }


def main():
    scene = load_scene(os.path.join(HERE, "scenes", "veach-mis", "veach-mis.obj"))
    cam = dataclasses.replace(scene.camera, width=256, height=256)
    scene = dataclasses.replace(scene, camera=cam)
    cfg = RenderConfig(spp=1, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=8)
    key = jax.random.key(0)
    per_dev = int(os.environ.get("SCALE_RAYS_PER_DEV", "2048"))
    nproc = os.cpu_count() or 1
    nds = [1, 2, 4, 8]

    fixed, weak, regen, train = {}, {}, {}, {}
    for nd in nds:
        if nd > len(jax.devices()):
            break
        fixed[nd] = _render_time(scene, cam, cfg, key, nd, per_dev * 8)
        weak[nd] = _render_time(scene, cam, cfg, key, nd, per_dev * nd)
        regen[nd] = _regen_time(scene, cfg, key, nd, 256, nd)[0]
        train[nd] = _train_time(scene, cfg, key, nd, per_dev * nd)
        print(f"nd={nd}: fixed {fixed[nd]*1e3:.0f} ms  weak {weak[nd]*1e3:.0f} ms"
              f"  regen {regen[nd]*1e3:.0f} ms  train {train[nd]*1e3:.0f} ms",
              flush=True)

    def effs(t):
        t1 = t[1]
        out = {}
        for nd, tn in t.items():
            ideal = t1 * max(1.0, nd / nproc)     # compute-bound bound
            out[str(nd)] = {
                "t_s": round(tn, 4),
                "eff_raw": round(t1 / tn, 3),
                "eff_vs_core_bound": round(ideal / tn, 3),
            }
        return out

    result = {
        "mesh": "virtual CPU devices (one host); overhead curves isolate "
                "the sharding machinery, weak-scaling is bounded by core "
                "oversubscription (see eff_vs_core_bound). Run with "
                "SCALE_PLATFORM=gpu on a multi-GPU host for real NVLink "
                "scaling.",
        "nproc": nproc,
        "rays_per_device": per_dev,
        "fixed_total_work_overhead_pct": {
            str(nd): round(100 * (fixed[nd] / fixed[1] - 1), 1) for nd in fixed
        },
        "weak_scaling_render": effs(weak),
        "weak_scaling_regen": effs(regen),
        "weak_scaling_train_step": effs(train),
        "cluster_2proc": _cluster_run(),
    }
    print(json.dumps(result, indent=1))
    out = os.path.join(HERE, "docs", "scaling_cpu_mesh.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()

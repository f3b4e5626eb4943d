"""Card-only checks: the compiled Triton kernels and a render on the GPU
against the CPU. They skip without a GPU (the ``gpu`` fixture decides);
run them on the card with ``MCPT_GPU_TESTS=1 python -m pytest -m gpu
tests/``. chip_smoke.py runs the same comparisons at full size."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_path_tracing_tpu.ops import intersect as ops
from monte_carlo_path_tracing_tpu.ops import intersect_pallas as ip
from monte_carlo_path_tracing_tpu.ops import intersect_ref as ir

pytestmark = pytest.mark.gpu


def test_compiled_kernels_match_matmul(gpu, veach_scene, rng_np):
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays

    cam = dataclasses.replace(veach_scene.camera, width=128, height=128)
    ro, rd = generate_rays(cam, jnp.arange(128 * 128, dtype=jnp.int32))
    accel = ops.build_accel(veach_scene)
    ex = jnp.full((ro.shape[0],), ir.NO_HIT, jnp.int32)
    hk = ip.intersect_pallas(ro, rd, accel.W, accel.tri_ids, ex)
    hm = ir.intersect_matmul(ro, rd, accel.W, accel.tri_ids, ex)
    m = np.asarray(hm.valid)
    assert (np.asarray(hk.valid) == m).mean() >= 0.9999
    assert (np.asarray(hk.tri_id)[m] == np.asarray(hm.tri_id)[m]).mean() >= 0.999
    t_max = jnp.where(hm.valid, hm.t * 0.9, 10.0)
    ok = ip.occluded_pallas(ro, rd, accel.W, accel.tri_ids, ex, t_max)
    om = hm.valid & (hm.t < t_max)
    assert (np.asarray(ok) == np.asarray(om)).mean() >= 0.9999


def test_gpu_render_matches_cpu(gpu, veach_scene):
    from monte_carlo_path_tracing_tpu.integrator import render_rays
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    cam = dataclasses.replace(veach_scene.camera, width=64, height=36)
    scene = dataclasses.replace(veach_scene, camera=cam)
    cfg = RenderConfig(spp=1, estimator="mis", max_depth=6, seed=0)
    ro, rd = generate_rays(cam, jnp.arange(64 * 36, dtype=jnp.int32))
    key = jax.random.key(0)
    out_gpu = np.asarray(jax.jit(
        lambda s, k, o, d: render_rays(s, cfg, k, o, d))(scene, key, ro, rd))
    cpu = jax.devices("cpu")[0]
    cfg_cpu = cfg.replace(use_pallas=False)
    with jax.default_device(cpu):
        args = jax.device_put((scene, key, ro, rd), cpu)
        out_cpu = np.asarray(jax.jit(
            lambda s, k, o, d: render_rays(s, cfg_cpu, k, o, d))(*args))
    rel = np.abs(out_gpu - out_cpu).mean() / np.abs(out_cpu).mean()
    assert np.isfinite(out_gpu).all() and rel < 1e-2, rel

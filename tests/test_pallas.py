"""Triton-route intersect kernels (ops/intersect_pallas.py) in interpret mode
against the jnp references. The compiled kernels are checked on the GPU by
tests/test_gpu.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monte_carlo_path_tracing_tpu.ops import intersect as ops
from monte_carlo_path_tracing_tpu.ops import intersect_pallas as ip
from monte_carlo_path_tracing_tpu.ops import intersect_ref as ir


def _random_case(rng, T, N):
    v0 = jnp.asarray(rng.uniform(-2, 2, size=(T, 3)), jnp.float32)
    e1 = jnp.asarray(rng.normal(size=(T, 3)), jnp.float32)
    e2 = jnp.asarray(rng.normal(size=(T, 3)), jnp.float32)
    ro = jnp.asarray(rng.uniform(-4, 4, size=(N, 3)), jnp.float32)
    rd = rng.normal(size=(N, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True), jnp.float32)
    return v0, e1, e2, ro, rd


_RT, _TT, _ = ip.TILES
# (triangles, rays): neither a tile multiple / both tile multiples / a
# single tile of each, so padding on both axes is exercised.
_SHAPES = {
    "unaligned": (700, 513),
    "aligned": (4 * _TT, 2 * _RT),
    "single_tile": (_TT - 5, _RT - 7),
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ops, "PALLAS_INTERPRET", True)


@pytest.mark.parametrize("exclude", [False, True], ids=["noexcl", "excl"])
@pytest.mark.parametrize("shape", list(_SHAPES))
def test_pallas_matches_matmul_interpret(rng_np, shape, exclude):
    """Interpret-mode kernel vs the jnp matmul reference (same f32 math,
    different summation order) and the broadcast Moller-Trumbore oracle."""
    T, N = _SHAPES[shape]
    v0, e1, e2, ro, rd = _random_case(rng_np, T, N)
    ids = jnp.arange(T, dtype=jnp.int32)
    W = ir.pack_tri_matrix(v0, e1, e2)
    excl = None
    if exclude:
        # exclude each ray's own nearest triangle half of the time
        first = ir.intersect_matmul(ro, rd, W, ids)
        excl = jnp.where(jnp.arange(N) % 2 == 0, first.tri_id, ir.NO_HIT)
    hp = ip.intersect_pallas(ro, rd, W, ids, exclude_id=excl, interpret=True)
    hm = ir.intersect_matmul(ro, rd, W, ids, exclude_id=excl)
    ho = ir.intersect_oracle(ro, rd, v0, e1, e2, ids, exclude_id=excl)

    m = np.asarray(hm.valid)
    assert 0.05 < m.mean() < 0.95          # a non-trivial case
    np.testing.assert_array_equal(np.asarray(hp.valid), m)
    same = np.asarray(hp.tri_id)[m] == np.asarray(hm.tri_id)[m]
    assert same.mean() > 0.995
    assert (np.asarray(hp.tri_id) == np.asarray(ho.tri_id)).mean() > 0.99
    np.testing.assert_allclose(np.asarray(hp.t)[m], np.asarray(hm.t)[m], rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(hp.u)[m][same], np.asarray(hm.u)[m][same], atol=2e-3
    )


def test_pallas_single_triangle():
    v0 = jnp.asarray([[0.0, 0.0, 0.0]])
    e1 = jnp.asarray([[1.0, 0.0, 0.0]])
    e2 = jnp.asarray([[0.0, 1.0, 0.0]])
    ids = jnp.asarray([3], jnp.int32)
    W = ir.pack_tri_matrix(v0, e1, e2)
    ro = jnp.asarray([[0.25, 0.25, 2.0], [5.0, 5.0, 2.0]])
    rd = jnp.asarray([[0.0, 0.0, -1.0]] * 2)
    h = ip.intersect_pallas(ro, rd, W, ids, interpret=True)
    assert bool(h.valid[0]) and not bool(h.valid[1])
    np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
    assert int(h.tri_id[0]) == 3


def test_occlusion_kernels_agree(rng_np, interpret):
    T, N = 300, 257
    v0, e1, e2, ro, rd = _random_case(rng_np, T, N)
    ids = jnp.arange(T, dtype=jnp.int32)
    W = ir.pack_tri_matrix(v0, e1, e2)
    accel = ops.TriAccel(W=W, tri_ids=ids)
    t_max = jnp.asarray(rng_np.uniform(0.5, 6.0, size=(N,)), jnp.float32)
    excl = jnp.full((N,), -1, jnp.int32)
    a = ops.occluded(accel, ro, rd, t_max, excl, impl="matmul")
    b = ops.occluded(accel, ro, rd, t_max, excl, impl="pallas")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert 0.05 < np.asarray(a).mean() < 0.95  # non-trivial case


def test_occlusion_semantics():
    v0 = jnp.asarray([[0.0, 0.0, 1.0]])  # blocker plane z=1
    e1 = jnp.asarray([[4.0, 0.0, 0.0]])
    e2 = jnp.asarray([[0.0, 4.0, 0.0]])
    ids = jnp.asarray([0], jnp.int32)
    accel = ops.TriAccel(W=ir.pack_tri_matrix(v0, e1, e2), tri_ids=ids)
    ro = jnp.asarray([[0.5, 0.5, 0.0]] * 3)
    rd = jnp.asarray([[0.0, 0.0, 1.0]] * 3)
    # segment ends: before the blocker, past it, exactly on it (margin)
    t_max = jnp.asarray([0.5, 2.0, 1.0])
    out = np.asarray(ops.occluded(accel, ro, rd, t_max, impl="matmul"))
    assert not out[0] and out[1] and not out[2]


@pytest.mark.parametrize("kernel", ["nearest", "occluded"])
def test_kernel_raises_on_cpu_without_interpret(rng_np, kernel):
    """A compiled Triton kernel needs a GPU: on the CPU the wrapper refuses
    instead of silently falling back to interpret mode."""
    T, N = 16, 8
    v0, e1, e2, ro, rd = _random_case(rng_np, T, N)
    ids = jnp.arange(T, dtype=jnp.int32)
    W = ir.pack_tri_matrix(v0, e1, e2)
    excl = jnp.full((N,), ir.NO_HIT, jnp.int32)
    with pytest.raises(ValueError, match="interpret=True"):
        if kernel == "nearest":
            ip.intersect_pallas(ro, rd, W, ids, excl)
        else:
            ip.occluded_pallas(ro, rd, W, ids, excl, jnp.ones((N,)))


def test_render_grads_through_kernel_match_matmul(cornell_scene, interpret):
    """The kernels take no tangent; material gradients through render_rays
    with the kernel forced equal those of the matmul path (t/u/v reach the
    gradient through the same exact XLA re-evaluation of the winner)."""
    import dataclasses

    from monte_carlo_path_tracing_tpu.core import rng
    from monte_carlo_path_tracing_tpu.diff.grad import pixel_grad
    from monte_carlo_path_tracing_tpu.render.camera import generate_rays
    from monte_carlo_path_tracing_tpu.utils.config import RenderConfig

    cam = dataclasses.replace(cornell_scene.camera, width=8, height=8)
    scene = dataclasses.replace(cornell_scene, camera=cam)
    ro, rd = generate_rays(cam, jnp.arange(64, dtype=jnp.int32))
    cfg = RenderConfig(width=8, height=8, spp=1, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=3, seed=0)
    key = rng.lane_keys(rng.sample_key(rng.base_key(0), 0),
                        jnp.arange(64, dtype=jnp.int32))
    select = jnp.ones((64, 3))
    g_k = pixel_grad(scene, cfg.replace(use_pallas=True), key, ro, rd, select)
    g_m = pixel_grad(scene, cfg.replace(use_pallas=False), key, ro, rd, select)
    leaves = lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
    for a, b in zip(leaves(g_k), leaves(g_m)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    assert any(np.abs(b).sum() > 0 for b in leaves(g_m))

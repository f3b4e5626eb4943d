"""Intersect dispatch (ops/intersect.py::impl_for_platform) and accel='auto'.

The platform picks the implementation: the Triton-route Pallas kernels on a
GPU, the jnp matmul form on the CPU, and an unknown platform is an error
(no silent fallback that would hide the device).
"""

import dataclasses

import numpy as np
import pytest

from monte_carlo_path_tracing_tpu.ops.intersect import impl_for_platform
from monte_carlo_path_tracing_tpu.render.renderer import render_image_regen
from monte_carlo_path_tracing_tpu.utils.config import RenderConfig


@pytest.mark.parametrize(
    "platform,impl", [("gpu", "pallas"), ("cpu", "matmul"), ("metal", None)]
)
def test_impl_for_platform(platform, impl):
    if impl is None:
        with pytest.raises(ValueError, match="no intersect implementation"):
            impl_for_platform(platform)
    else:
        assert impl_for_platform(platform) == impl


def test_auto_matches_all_pairs_below_crossover(cornell_scene):
    """accel='auto' is the all-pairs engine: the identical program (exact
    image equality)."""
    s = dataclasses.replace(
        cornell_scene,
        camera=dataclasses.replace(cornell_scene.camera, width=16, height=12),
    )
    cfg = RenderConfig(width=16, height=12, spp=2, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=6, seed=1)
    a = render_image_regen(s, cfg.replace(accel="auto"), lanes=64)
    b = render_image_regen(s, cfg.replace(accel="all_pairs"), lanes=64)
    np.testing.assert_array_equal(a.image, b.image)


def test_bathroom_scene_exercises_cull_window():
    """The bundled bathroom scene (the reference's third scene slot,
    main.cpp:19-21 commented constants, ~30k triangles — ten times the
    other scenes) renders through the default path; smoke-render it."""
    import os

    from monte_carlo_path_tracing_tpu.scene import load_scene

    path = os.path.join(os.path.dirname(__file__), "..", "scenes",
                        "bathroom", "bathroom.obj")
    s = load_scene(path)
    assert s.num_tris > 20_000, s.num_tris
    s = dataclasses.replace(
        s, camera=dataclasses.replace(s.camera, width=16, height=12))
    cfg = RenderConfig(width=16, height=12, spp=1, estimator="mis",
                       light_sampler="spherical_triangle", max_depth=3,
                       seed=0)
    r = render_image_regen(s, cfg, lanes=64)
    assert np.isfinite(r.image).all()
    assert r.image.sum() > 0

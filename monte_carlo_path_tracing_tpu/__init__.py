"""Differentiable Monte Carlo path tracer for an accelerator (NVIDIA GPU).

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
C++20 CPU renderer ``luotong96/Monte_Carlo_Path_Tracing`` (see SURVEY.md):
Phong BRDF evaluation/sampling, uniform area-light and Arvo spherical-triangle
light sampling, three radiance estimators (split direct/indirect, BRDF-only,
Veach MIS with the balance heuristic), Russian-roulette termination, triangle
intersection, gamma tone mapping, cg23 OBJ/MTL/XML scene ingestion — all
re-designed for an accelerator: wavefront ray batches as sharded arrays,
intersection in matmul form with fused Pallas (Triton) kernels, counter-based
threefry RNG, end-to-end
differentiability, and multi-device scaling via jax.sharding meshes.
"""

__version__ = "0.1.0"

from monte_carlo_path_tracing_tpu.utils.config import RenderConfig  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps `import monte_carlo_path_tracing_tpu`
    cheap — jax-heavy modules load on first use)."""
    lazy = {
        "load_scene": ("monte_carlo_path_tracing_tpu.scene.build", "load_scene"),
        "Scene": ("monte_carlo_path_tracing_tpu.scene.types", "Scene"),
        "Camera": ("monte_carlo_path_tracing_tpu.scene.types", "Camera"),
        "Materials": ("monte_carlo_path_tracing_tpu.scene.types", "Materials"),
        "render_rays": ("monte_carlo_path_tracing_tpu.integrator.wavefront", "render_rays"),
        "render_image": ("monte_carlo_path_tracing_tpu.render.renderer", "render_image"),
        "render_image_regen": (
            "monte_carlo_path_tracing_tpu.render.renderer", "render_image_regen",
        ),
        "write_image": ("monte_carlo_path_tracing_tpu.render.film", "write_image"),
        "recover_materials": (
            "monte_carlo_path_tracing_tpu.diff.inverse", "recover_materials",
        ),
    }
    if name in lazy:
        import importlib

        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

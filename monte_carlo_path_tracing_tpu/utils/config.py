"""Render configuration.

The reference has no config system: estimator choice is a code edit
(main.cpp:575), P_RR / spp / resolution / tone map / camera are compile-time
constants (SURVEY.md §5 "Config / flag system"). Here every one of those
knobs is a field on a single frozen dataclass, shared by the CLI, the tests,
the benchmarks, and the distributed runner.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Estimators (reference main.cpp:269-494)
EST_BRDF = "brdf"      # shade_with_brdf  (main.cpp:348-399)
EST_SPLIT = "split"    # shade            (main.cpp:269-344)
EST_MIS = "mis"        # shade_with_mis   (main.cpp:402-494) — flagship
EST_SHOOT = "shoot"    # legacy shoot     (main.cpp:96-265, dead code in ref)
ESTIMATORS = (EST_BRDF, EST_SPLIT, EST_MIS, EST_SHOOT)

# Light samplers (reference Mylight.cpp:102-160 / 163-493)
LS_UNIFORM_AREA = "uniform_area"
LS_SPHERICAL = "spherical_triangle"
LIGHT_SAMPLERS = (LS_UNIFORM_AREA, LS_SPHERICAL)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Image
    width: int = 1280
    height: int = 720           # reference main.cpp:539 (1280x720)
    spp: int = 10               # reference main.cpp:567

    # Estimator
    estimator: str = EST_MIS
    light_sampler: str = LS_SPHERICAL
    rr_prob: float = 0.6        # survival probability P_RR (main.cpp:321,375,429)
    max_depth: int = 32         # wavefront bound on the RR chain; P(depth>32)=0.6^32~8e-8

    # Tone map (main.cpp:583)
    max_radiance: float = 380.0
    gamma: float = 0.25

    # RNG
    seed: int = 0

    # Sub-pixel jitter for antialiasing. The reference has none — all spp of
    # a pixel re-trace one direction (main.cpp:563-567) — so default off.
    pixel_jitter: bool = False

    # Quirk-compat flags (SURVEY.md §7 quirks registry). Defaults are the
    # measure-correct / unbiased choices; flip them on to reproduce the
    # reference's behaviour bit-for-bit for golden comparisons.
    fov_bug_compat: bool = False     # Q2: degrees-as-radians half-fov
    measure_bug_compat: bool = False  # Q3: area-form G with solid-angle pdf in `shade`
    branch_pdf_compat: bool = False   # Q4: divide by branch pdf, not mixture pdf
    ref_mis_weights: bool = False     # Q11: reference's nearest-light-denominator MIS
    # Q11 full parity: ALSO shade the occluder of a blocked MIS light ray
    # (the reference's recursive branch A, main.cpp:455-464), via the
    # regeneration renderer's blocker-chain work queue. Requires
    # ref_mis_weights (the reference's weighting) and estimator='mis';
    # supported by render_image_regen only (the fixed-depth wavefront
    # raises). CLI: --ref-mis-full sets both flags.
    mis_blocker_compat: bool = False

    # Debug tripwires (the reference's printf sentinels, SURVEY §4.2:
    # backface-at-hit "95", DDA stall "464!!!!"): when on, render_rays
    # reports non-finite radiance / suspicious states via jax.debug.print
    # and the with_stats counters.
    debug_checks: bool = False

    # Wavefront / performance
    ray_chunk: int = 1 << 16    # rays in flight per wavefront batch
    # Intersect implementation: None = auto (ops/intersect.py::
    # impl_for_platform — the Pallas kernels on a GPU, jnp on the CPU),
    # True = the Pallas kernels, False = jnp (intersect_matmul).
    use_pallas: Optional[bool] = None
    # Acceleration structure: "auto" and "all_pairs" (the default all-pairs
    # test, identical today), or "grid" (the reference's uniform grid +
    # 3D-DDA, C10/C12 — kept for parity; auto never picks it).
    accel: str = "auto"
    grid_n0: int = 100_000      # grid target cell count (main.cpp:520)
    # Regen renderer: reorder lanes by (direction cone, origin morton)
    # each iteration so ray tiles are coherent. Pure permutation — the
    # estimate is unchanged (streams are keyed by (sample, pixel), not
    # lane). Opt-in: the all-pairs intersect gains nothing from it.
    ray_sort: bool = False
    # Sort every k-th regen iteration (coherence decays slowly as lanes die
    # and regenerate; k>1 amortizes the sort). 1 = every iteration.
    ray_sort_every: int = 1
    # Primary-hit cache (regen renderer): with jitter off every spp of a
    # pixel re-traces one identical primary ray (the reference's behaviour,
    # main.cpp:563-572) and the depth-0 Arvo prepare field is per-pixel
    # constant. The cache pre-pass traces each pixel's primary ray ONCE,
    # prepares the spherical CDF ONCE per pixel, runs all depth-0 shading
    # densely, and feeds only the surviving continuations to the regen
    # loop (integrator/regen.py::render_regen_cached). Same estimate and
    # draw streams as the uncached path. None = auto (on when eligible:
    # estimator mis/brdf, no jitter, no blocker compat); True forces it
    # (validate() raises if ineligible); False forces the uncached loop.
    primary_cache: Optional[bool] = None

    # Distribution
    mesh_shape: Tuple[int, ...] = ()    # () = single device
    mesh_axes: Tuple[str, ...] = ("tiles",)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> None:
        if self.estimator not in ESTIMATORS:
            raise ValueError(f"estimator must be one of {ESTIMATORS}, got {self.estimator}")
        if self.light_sampler not in LIGHT_SAMPLERS:
            raise ValueError(
                f"light_sampler must be one of {LIGHT_SAMPLERS}, got {self.light_sampler}"
            )
        if not (0.0 < self.rr_prob < 1.0):
            raise ValueError("rr_prob must be in (0, 1)")
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.accel not in ("auto", "all_pairs", "grid"):
            raise ValueError(
                f"accel must be 'auto', 'all_pairs' or 'grid', got {self.accel}"
            )
        if self.mis_blocker_compat and not self.ref_mis_weights:
            raise ValueError(
                "mis_blocker_compat reproduces the reference's full MIS "
                "recursion and requires ref_mis_weights=True"
            )
        if self.ray_sort_every < 1:
            raise ValueError("ray_sort_every must be >= 1")
        if self.primary_cache:
            from monte_carlo_path_tracing_tpu.integrator.regen import (
                primary_cache_eligible,
            )

            if not primary_cache_eligible(self):
                raise ValueError(
                    "primary_cache=True requires estimator in "
                    "('mis','brdf','split'), pixel_jitter=False and "
                    "mis_blocker_compat=False (the depth-0 work must be "
                    "per-pixel deterministic)"
                )

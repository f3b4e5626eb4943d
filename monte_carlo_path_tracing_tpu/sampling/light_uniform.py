"""Uniform area-light sampling (reference Mylight.cpp:102-160, component C8).

Three-stage hierarchical draw, fully batched:
  1. light *class* (mtlname) with weight = radiance sum            (112-123)
  2. triangle within the class with weight = area                  (126-135)
  3. uniform point via the barycentric warp beta = 1 - sqrt(1-xi1),
     gamma = (1-beta)*xi2                                          (141-149)

Stages 1-2 collapse into a single static per-light-triangle categorical
p_sel[l] = P(class) * area_l / area(class) precomputed from the scene — the
batched form of the reference's two chained std::discrete_distribution draws.
The returned ``prob`` is an **area-measure density** p = p_sel / area
(sampledLightPoint.prob, Mylight.cpp:156-158).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.core import rng
from monte_carlo_path_tracing_tpu.core.radiometry import radiance_sum
from monte_carlo_path_tracing_tpu.scene.types import Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LightSample:
    """sampledLightPoint (Mylight.h:67-97): point, emitted radiance, density.

    ``pdf`` is an area density for the uniform sampler and a solid-angle
    density for the spherical sampler — integrators must pair the geometry
    term accordingly (quirk Q3).
    """

    coord: jnp.ndarray      # [N,3]
    light_idx: jnp.ndarray  # [N] index into scene.light_tri_ids
    tri_id: jnp.ndarray     # [N] global triangle id
    emission: jnp.ndarray   # [N,3]
    pdf: jnp.ndarray        # [N]
    valid: jnp.ndarray      # [N] bool (False => dummy sample, contribute 0)
    nl: jnp.ndarray         # [N,3] light geometric normal (vote-oriented)


def select_table(scene: Scene) -> jnp.ndarray:
    """Static per-light-tri selection probabilities p_sel[L]."""
    l_sum = radiance_sum(scene.light_emission())                 # [L]
    cls = scene.light_class
    # Class weight = radiance sum of the class's radiance value (not x area,
    # Mylight.cpp:112-123): every tri in a class shares the same emission, so
    # segment_max just recovers the per-class value. L is a safe static upper
    # bound on the number of classes.
    num_seg = scene.light_area.shape[0]
    class_rad = jax.ops.segment_max(l_sum, cls, num_segments=num_seg)
    class_area = jax.ops.segment_sum(scene.light_area, cls, num_segments=num_seg)
    w_class = jnp.where(class_area > 0, class_rad, 0.0)
    p_class = w_class / jnp.maximum(jnp.sum(w_class), 1e-30)
    p_tri_in_class = scene.light_area / jnp.maximum(class_area[cls], 1e-30)
    return p_class[cls] * p_tri_in_class                          # [L]


def pack_table(scene: Scene) -> jnp.ndarray:
    """[L,17] packed record: v0(3) e1(3) e2(3) nl(3) emission(3)
    pdf_area(1) tri_id(1) — one gather per lane instead of six."""
    p_sel = select_table(scene)
    tri = scene.light_tri_ids
    pdf_a = p_sel / jnp.maximum(scene.light_area, 1e-30)
    return jnp.concatenate(
        [
            scene.tri_v0[tri], scene.tri_e1[tri], scene.tri_e2[tri],
            scene.geo_n[tri], scene.light_emission(),
            pdf_a[:, None], tri.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


def sample(key: jax.Array, scene: Scene, n_rays: int) -> LightSample:
    """Draw one light point per ray (batched)."""
    p_sel = select_table(scene)
    k_sel, k_warp = rng.fold_in(key, 0), rng.fold_in(key, 1)
    lidx = rng.pick_weighted(k_sel, p_sel, n_rays)                 # [N]
    xi = rng.uniform(k_warp, (n_rays, 2))

    beta = 1.0 - jnp.sqrt(jnp.maximum(1.0 - xi[:, 0], 0.0))
    gamma = (1.0 - beta) * xi[:, 1]

    rec = pack_table(scene)[lidx]                        # [N,17] single gather
    coord = rec[:, 0:3] + beta[:, None] * rec[:, 3:6] + gamma[:, None] * rec[:, 6:9]
    return LightSample(
        coord=coord,
        light_idx=lidx,
        tri_id=rec[:, 16].astype(jnp.int32),
        emission=rec[:, 12:15],
        pdf=rec[:, 15],
        valid=jnp.ones((n_rays,), bool),
        nl=rec[:, 9:12],
    )


def pdf_area(scene: Scene, light_idx: jnp.ndarray) -> jnp.ndarray:
    """Area density of sampling a point on light triangle `light_idx` —
    used to convert to solid angle for MIS with the uniform sampler."""
    p_sel = select_table(scene)
    return p_sel[light_idx] / jnp.maximum(scene.light_area[light_idx], 1e-30)

"""Shared per-vertex machinery for the wavefront integrators.

Surface interaction gather (the reference's barycentric interpolation +
facet-attribute cache reads, main.cpp:273-292 / Myobj.cpp:626-709), Russian
roulette, and the solid-angle light-pdf conversions used by MIS.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu.ops.intersect_ref import Hit
from monte_carlo_path_tracing_tpu.scene.types import Scene


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    """Everything the estimators read at a path vertex."""

    p: jnp.ndarray          # [N,3] hit position (barycentric lerp, main.cpp:273)
    ns: jnp.ndarray         # [N,3] interpolated unit shading normal (main.cpp:274)
    ng: jnp.ndarray         # [N,3] vote-oriented geometric normal
    wo: jnp.ndarray         # [N,3] toward the previous vertex (unit)
    kd: jnp.ndarray         # [N,3]
    ks: jnp.ndarray         # [N,3]
    ns_exp: jnp.ndarray     # [N] Phong exponent
    emission: jnp.ndarray   # [N,3]
    is_light: jnp.ndarray   # [N] bool
    front: jnp.ndarray      # [N] bool: ns . wo > 0 (backface => black, Q9)
    tri_id: jnp.ndarray     # [N]
    light_idx: jnp.ndarray  # [N] index into light arrays (-1 for non-lights)


def light_index_table(scene: Scene) -> jnp.ndarray:
    """[T] map tri_id -> light array index (-1 for non-lights) — replaces
    the reference's per-point indiceMap (Mylight.h:119, Mylight.cpp:418)."""
    table = jnp.full((scene.num_tris,), -1, jnp.int32)
    return table.at[scene.light_tri_ids].set(
        jnp.arange(scene.num_lights, dtype=jnp.int32)
    )


def build_tri_table(scene: Scene, tri_to_light: jnp.ndarray) -> jnp.ndarray:
    """[T, 34] packed per-triangle record so a path vertex needs ONE gather
    instead of ~12. Layout: v0(3) e1(3) e2(3) vn(9) geo_n(3) kd(3) ks(3) ns(1)
    emission(3) is_light(1) light_idx(1) mat_id(1).

    Built from the materials table with plain gathers/concat, so gradients
    still flow into Materials — and since it only depends on loop-invariant
    scene arrays, XLA hoists the build out of the bounce loop.
    """
    mat = scene.tri_mat_id
    mats = scene.materials
    T = scene.num_tris
    return jnp.concatenate(
        [
            scene.tri_v0, scene.tri_e1, scene.tri_e2,
            scene.tri_vn.reshape(T, 9),
            scene.geo_n,
            mats.kd[mat], mats.ks[mat],
            mats.ns[mat][:, None],
            mats.emission[mat],
            scene.is_light[:, None].astype(jnp.float32),
            tri_to_light.astype(jnp.float32)[:, None],
            mat.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


def gather_interaction(
    scene: Scene, hit: Hit, rd: jnp.ndarray, tri_to_light: jnp.ndarray,
    tri_table: jnp.ndarray | None = None,
) -> SurfaceInteraction:
    tri = jnp.maximum(hit.tri_id, 0)  # clamp miss sentinel for safe gathers
    if tri_table is None:
        tri_table = build_tri_table(scene, tri_to_light)
    rec = tri_table[tri]                                 # [N, 34] single gather
    v0 = rec[:, 0:3]
    e1 = rec[:, 3:6]
    e2 = rec[:, 6:9]
    vn = rec[:, 9:18].reshape(-1, 3, 3)
    u = hit.u[:, None]
    v = hit.v[:, None]
    p = v0 + u * e1 + v * e2
    ns = vm.normalize(
        (1.0 - u - v) * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2]
    )
    wo = -rd
    # columns: 27 ns, 28:31 emission, 31 is_light, 32 light_idx, 33 mat_id
    return SurfaceInteraction(
        p=p,
        ns=ns,
        ng=rec[:, 18:21],
        wo=wo,
        kd=rec[:, 21:24],
        ks=rec[:, 24:27],
        ns_exp=rec[:, 27],
        emission=rec[:, 28:31],
        is_light=(rec[:, 31] > 0.5) & hit.valid,
        front=vm.dot(ns, wo) > 0.0,
        tri_id=hit.tri_id,
        light_idx=jnp.where(hit.valid, rec[:, 32].astype(jnp.int32), -1),
    )


def russian_roulette(key: jax.Array, n: int, p_survive: float):
    """Survive mask + 1/p weight (reference ksi > 0.6 => stop,
    main.cpp:321-329)."""
    xi = rng.uniform(key, (n,))
    return xi < p_survive, 1.0 / p_survive


def area_pdf_to_solid_angle(
    pdf_area: jnp.ndarray, dist2: jnp.ndarray, cos_light: jnp.ndarray
) -> jnp.ndarray:
    """p(w) = p(A) * r^2 / cos(theta_light); zero when the light is seen
    edge-on or from behind."""
    ok = cos_light > 1e-7
    return jnp.where(ok, pdf_area * dist2 / jnp.maximum(cos_light, 1e-7), 0.0)

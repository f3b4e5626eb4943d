"""Intersection engine: accel build + implementation dispatch.

The reference's acceleration structure is a uniform grid walked by 3D-DDA
(Myobj.cpp:78-162, 334-474). Here the default engine is an all-pairs tiled
test in matmul form (see intersect_ref.py for the math): at the
reference's scene scale (~3k triangles) brute force keeps every lane busy
where a divergent per-ray traversal would not. The "accel build" is
therefore just packing each triangle's [10,4] coefficient matrix (and
padding to a tile multiple).

Implementations:
  - 'matmul': plain jnp (intersect_ref.intersect_matmul); runs anywhere.
  - 'pallas': fused Pallas kernels on the Triton route (intersect_pallas.py);
    GPU only, or in interpret mode where a test sets PALLAS_INTERPRET.
  - 'auto': :func:`impl_for_platform` of the default backend.

A second, lights-only accel serves the reference's
closet_ray_intersect_light_triangle (Myobj.cpp:476-622) — needed only in
`ref_mis_weights` compat mode (quirk Q11) where the MIS denominator queries
the nearest *light* triangle along a BRDF ray.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.ops import intersect_ref
from monte_carlo_path_tracing_tpu.ops.intersect_ref import (  # noqa: F401
    Hit, NO_HIT, T_EPS, pack_tri_matrix,
)
from monte_carlo_path_tracing_tpu.scene.types import Scene

#: Triangle padding multiple of the packed accel.
TRI_BLOCK = 512

#: Run the Pallas kernels in interpret mode. Only tests set this (on the
#: CPU); nothing derives it from the backend.
PALLAS_INTERPRET = False


def impl_for_platform(platform: str) -> str:
    """The intersect implementation for a JAX platform name."""
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "matmul"
    raise ValueError(f"no intersect implementation for platform {platform!r}")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TriAccel:
    W: jnp.ndarray        # [Tpad, 10, 4] packed coefficient matrices
    tri_ids: jnp.ndarray  # [Tpad] int32 global ids (padding rows: -2)


def _morton_order(v0, e1, e2):
    """Sort order by 3x10-bit interleaved Morton code of the centroid —
    makes consecutive triangles (=> kernel tiles) spatially compact."""
    c = v0 + (e1 + e2) / 3.0
    lo = jnp.min(jnp.minimum(v0, jnp.minimum(v0 + e1, v0 + e2)), axis=0)
    hi = jnp.max(jnp.maximum(v0, jnp.maximum(v0 + e1, v0 + e2)), axis=0)
    q = jnp.clip(
        ((c - lo) / jnp.maximum(hi - lo, 1e-20) * 1023.0).astype(jnp.int32),
        0, 1023,
    )

    def spread(x):  # 10 bits -> every 3rd bit of 30
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return jnp.argsort(code)


def _build(v0, e1, e2, ids, block: int) -> TriAccel:
    order = _morton_order(v0, e1, e2)
    v0, e1, e2, ids = v0[order], e1[order], e2[order], ids[order]
    W = pack_tri_matrix(v0, e1, e2)
    pad = (-v0.shape[0]) % block
    if pad:
        W = jnp.concatenate([W, jnp.zeros((pad, 10, 4), W.dtype)], axis=0)
        ids = jnp.concatenate([ids, jnp.full((pad,), -2, jnp.int32)], axis=0)
    # Geometry is not a differentiation target (materials/emission are);
    # make that explicit so the accel never drags grads through packing.
    return TriAccel(W=jax.lax.stop_gradient(W), tri_ids=ids)


def build_accel(scene: Scene, block: int = TRI_BLOCK) -> TriAccel:
    ids = jnp.arange(scene.num_tris, dtype=jnp.int32)
    return _build(scene.tri_v0, scene.tri_e1, scene.tri_e2, ids, block)


def build_light_accel(scene: Scene, block: int = TRI_BLOCK) -> TriAccel:
    """Accel restricted to emissive triangles (ids remain global tri ids)."""
    sel = scene.light_tri_ids
    return _build(
        scene.tri_v0[sel], scene.tri_e1[sel], scene.tri_e2[sel], sel, block
    )


def _resolve(impl: str) -> str:
    return impl_for_platform(jax.default_backend()) if impl == "auto" else impl


@jax.named_scope("intersect_nearest")
def intersect(
    accel: TriAccel,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    exclude_id: jnp.ndarray | None = None,
    impl: str = "auto",
    t_eps: float = T_EPS,
) -> Hit:
    """Nearest hit of N rays against the accel's triangle set.

    Self-intersection avoidance is by triangle-id exclusion (quirk Q8,
    Myobj.cpp:417), not ray offsetting.
    """
    from monte_carlo_path_tracing_tpu.ops import grid as grid_mod

    if isinstance(accel, grid_mod.GridAccel):
        return grid_mod.intersect_grid(accel, ro, rd, exclude_id, t_eps=t_eps)
    impl = _resolve(impl)
    if impl == "pallas":
        from monte_carlo_path_tracing_tpu.ops import intersect_pallas

        return intersect_pallas.intersect_pallas(
            ro, rd, accel.W, accel.tri_ids, exclude_id, t_eps=t_eps,
            interpret=PALLAS_INTERPRET,
        )
    if impl == "matmul":
        return intersect_ref.intersect_matmul(
            ro, rd, accel.W, accel.tri_ids, exclude_id, t_eps=t_eps
        )
    raise ValueError(f"unknown intersect impl {impl!r}")


#: Relative margin for shadow-ray occlusion: a hit counts as blocking only
#: below t_max * (1 - margin), keeping the sampled light surface itself out.
OCCLUSION_MARGIN = 1e-3


@jax.named_scope("intersect_occluded")
def occluded(
    accel: TriAccel,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    t_max: jnp.ndarray,
    exclude_id: jnp.ndarray | None = None,
    impl: str = "auto",
    t_eps: float = T_EPS,
) -> jnp.ndarray:
    """[N] bool: something blocks the segment ro -> ro + t_max*rd.

    The NEE visibility predicate. The reference computes a full nearest hit
    and requires it to be exactly the sampled light triangle
    (main.cpp:309-311); "no accepted hit closer than the sampled point" is
    the same predicate, and the pallas path evaluates it with a pure
    OR-reduction any-hit kernel (no extraction work).
    """
    from monte_carlo_path_tracing_tpu.ops import grid as grid_mod

    if isinstance(accel, grid_mod.GridAccel):
        hit = grid_mod.intersect_grid(accel, ro, rd, exclude_id, t_eps=t_eps)
        return hit.valid & (hit.t < t_max * (1.0 - OCCLUSION_MARGIN))
    impl = _resolve(impl)
    scaled = t_max * (1.0 - OCCLUSION_MARGIN)
    if impl == "pallas":
        from monte_carlo_path_tracing_tpu.ops import intersect_pallas

        if exclude_id is None:
            exclude_id = jnp.full((ro.shape[0],), NO_HIT, jnp.int32)
        return intersect_pallas.occluded_pallas(
            ro, rd, accel.W, accel.tri_ids, exclude_id, scaled, t_eps=t_eps,
            interpret=PALLAS_INTERPRET,
        )
    if impl == "matmul":
        hit = intersect_ref.intersect_matmul(
            ro, rd, accel.W, accel.tri_ids, exclude_id, t_eps=t_eps
        )
        return hit.valid & (hit.t < scaled)
    raise ValueError(f"unknown intersect impl {impl!r}")

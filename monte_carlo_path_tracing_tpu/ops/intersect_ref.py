"""Ray-triangle intersection — jnp reference implementations.

Replaces the reference's uniform-grid 3D-DDA traversal + Cramer's-rule
triangle test (closet_ray_intersect Myobj.cpp:334-474, intersect_with_triangle
Myobj.cpp:165-192) with a dense, divergence-free all-pairs formulation:

**The matmul form.** Moller-Trumbore for ray (ro, rd) against triangle
(v0, e1, e2) reduces to four bilinear forms in the per-ray feature vector
g = [ro, rd, m, 1] (m = ro x rd, the ray's Plucker moment):

    det   = rd . (e2 x e1)
    u_num = m . e2 + rd . (v0 x e2)          (u * det)
    v_num = -m . e1 + rd . (e1 x v0)         (v * det)
    t_num = ro . n - v0 . n,  n = e1 x e2    (t * det)

so intersecting N rays against T triangles is ONE [N,10] @ [10,4T] matmul
followed by an elementwise accept test and a min-t reduction. The Pallas
kernels (intersect_pallas.py) fuse all three on the GPU; this module holds
(a) `intersect_oracle`, a direct broadcast Moller-Trumbore used as the
correctness oracle, and (b) `intersect_matmul`, the same matmul math in
plain jnp at Precision.HIGHEST (the CPU path and the kernels' reference).

Accept rules mirror the reference (Myobj.cpp:175-188): |det|>eps, u>=0, v>=0,
u+v<=1, t>t_eps, plus self-exclusion by triangle id (quirk Q8, Myobj.cpp:417)
rather than a large ray epsilon.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.core import vecmath as vm

#: Smallest |det| treated as a real (non-parallel, non-degenerate) hit.
DET_EPS = 1e-9
#: Minimum ray parameter. The reference uses 1e-8 in f64 (vec.h:7) and leans
#: on triangle-id exclusion; in f32 a slightly larger floor avoids acne from
#: *neighbouring* triangles at shared edges.
T_EPS = 1e-4

#: Sentinel for "no hit". numpy scalars, NOT jnp — module-level jnp values
#: would initialize the device backend at import time, which must stay
#: deferred until after jax.distributed.initialize() (parallel/mesh.py).
NO_HIT = np.int32(-1)
BIG_T = np.float32(3.0e38)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hit:
    """Wavefront hit record — the reference's ``intersec_result``
    (Myobj.h:10-41) with (s,f) flattened to ``tri_id``."""

    t: jnp.ndarray       # [N] ray parameter (BIG_T when miss)
    tri_id: jnp.ndarray  # [N] int32 (-1 when miss)
    u: jnp.ndarray       # [N] barycentric beta  (weight of v1)
    v: jnp.ndarray       # [N] barycentric gamma (weight of v2)
    valid: jnp.ndarray   # [N] bool


def pack_tri_matrix(v0: jnp.ndarray, e1: jnp.ndarray, e2: jnp.ndarray) -> jnp.ndarray:
    """Precompute the per-triangle [10, 4] matrix W of the matmul form.

    Rows: g = [ro(0:3), rd(3:6), m(6:9), 1(9)]. Columns: det,u,v,t numerators.
    Degenerate (zero-area) triangles produce det == 0 => never hit, which is
    also how padding triangles are encoded.
    """
    n = jnp.cross(e1, e2)                      # [T,3]
    W = jnp.zeros(v0.shape[:-1] + (10, 4), v0.dtype)
    W = W.at[..., 3:6, 0].set(jnp.cross(e2, e1))
    W = W.at[..., 3:6, 1].set(jnp.cross(v0, e2))
    W = W.at[..., 6:9, 1].set(e2)
    W = W.at[..., 3:6, 2].set(jnp.cross(e1, v0))
    W = W.at[..., 6:9, 2].set(-e1)
    W = W.at[..., 0:3, 3].set(n)
    W = W.at[..., 9, 3].set(-vm.dot(v0, n))
    return W


def ray_features(ro: jnp.ndarray, rd: jnp.ndarray) -> jnp.ndarray:
    """Per-ray feature vector g = [ro, rd, ro x rd, 1], shape [N, 10]."""
    m = jnp.cross(ro, rd)
    one = jnp.ones(ro.shape[:-1] + (1,), ro.dtype)
    return jnp.concatenate([ro, rd, m, one], axis=-1)


def _select_best(vals, tri_ids, exclude_id, t_eps):
    """From raw [N, B, 4] (det,u,v,t numerators) pick the nearest valid hit.

    Returns (t, id, u, v, valid) for the block.
    """
    det, u_num, v_num, t_num = (vals[..., k] for k in range(4))
    s = jnp.sign(det)
    adet = jnp.abs(det)
    up, vp, tp = u_num * s, v_num * s, t_num * s
    ok = (
        (adet > DET_EPS)
        & (up >= 0.0)
        & (vp >= 0.0)
        & (up + vp <= adet)
        & (tp > t_eps * adet)
        & (tri_ids[None, :] != exclude_id[:, None])
    )
    t = jnp.where(ok, t_num / jnp.where(adet > 0, det, 1.0), BIG_T)
    best = jnp.argmin(t, axis=-1)                       # [N]
    take = partial(jnp.take_along_axis, indices=best[:, None], axis=-1)
    bt = take(t)[:, 0]
    inv_det = 1.0 / jnp.where(jnp.abs(take(det)[:, 0]) > 0, take(det)[:, 0], 1.0)
    bu = take(u_num)[:, 0] * inv_det
    bv = take(v_num)[:, 0] * inv_det
    bid = tri_ids[best]
    bvalid = take(ok.astype(jnp.int8))[:, 0] > 0
    return bt, jnp.where(bvalid, bid, NO_HIT), bu, bv, bvalid


def intersect_matmul(
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    W: jnp.ndarray,
    tri_ids: jnp.ndarray,
    exclude_id: jnp.ndarray | None = None,
    t_eps: float = T_EPS,
    block: int = 512,
) -> Hit:
    """All-pairs nearest-hit via the matmul form, scanning triangle blocks.

    W: [T, 10, 4] from :func:`pack_tri_matrix` (T may include padding rows
    with det==0). tri_ids: [T] int32 ids reported for hits.
    """
    N = ro.shape[0]
    T = W.shape[0]
    if exclude_id is None:
        exclude_id = jnp.full((N,), NO_HIT, jnp.int32)
    g = ray_features(ro, rd)                             # [N,10]

    pad = (-T) % block
    if pad:
        W = jnp.concatenate([W, jnp.zeros((pad, 10, 4), W.dtype)], axis=0)
        tri_ids = jnp.concatenate(
            [tri_ids, jnp.full((pad,), NO_HIT - 1, jnp.int32)], axis=0
        )
    nb = W.shape[0] // block
    Wb = W.reshape(nb, block, 10, 4)
    idb = tri_ids.reshape(nb, block)

    def body(carry, blk):
        Wblk, ids = blk
        vals = jnp.einsum(
            "nf,bfk->nbk", g, Wblk, precision=jax.lax.Precision.HIGHEST
        )
        bt, bid, bu, bv, bok = _select_best(vals, ids, exclude_id, t_eps)
        ct, cid, cu, cv, cok = carry
        better = bt < ct
        carry = (
            jnp.where(better, bt, ct),
            jnp.where(better, bid, cid),
            jnp.where(better, bu, cu),
            jnp.where(better, bv, cv),
            cok | bok,
        )
        return carry, None

    init = (
        jnp.full((N,), BIG_T),
        jnp.full((N,), NO_HIT, jnp.int32),
        jnp.zeros((N,)),
        jnp.zeros((N,)),
        jnp.zeros((N,), bool),
    )
    (t, tid, u, v, ok), _ = jax.lax.scan(body, init, (Wb, idb))
    return Hit(t=t, tri_id=tid, u=u, v=v, valid=ok)


def intersect_oracle(
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    v0: jnp.ndarray,
    e1: jnp.ndarray,
    e2: jnp.ndarray,
    tri_ids: jnp.ndarray,
    exclude_id: jnp.ndarray | None = None,
    t_eps: float = T_EPS,
) -> Hit:
    """Direct broadcast Moller-Trumbore (the reference's Cramer solve,
    Myobj.cpp:165-192). O(N*T*3) memory — tests/oracle only."""
    N = ro.shape[0]
    if exclude_id is None:
        exclude_id = jnp.full((N,), NO_HIT, jnp.int32)
    pvec = jnp.cross(rd[:, None, :], e2[None])           # [N,T,3]
    det = jnp.sum(pvec * e1[None], axis=-1)              # [N,T]
    s = ro[:, None, :] - v0[None]                        # [N,T,3]
    u_num = jnp.sum(s * pvec, axis=-1)
    qvec = jnp.cross(s, e1[None])
    v_num = jnp.sum(rd[:, None, :] * qvec, axis=-1)
    t_num = jnp.sum(e2[None] * qvec, axis=-1)
    vals = jnp.stack([det, u_num, v_num, t_num], axis=-1)
    bt, bid, bu, bv, bok = _select_best(vals, tri_ids, exclude_id, t_eps)
    return Hit(t=bt, tri_id=bid, u=bu, v=bv, valid=bok)

"""Pallas kernels (Triton route): fused ray-triangle nearest hit and occlusion.

Same math as intersect_ref.intersect_matmul — the det/u/v/t numerators are
bilinear forms in the ray features [ro, rd, m = ro x rd] — but the accept
test and the reduction over triangles run in registers, so the [N, T]
candidate field never reaches device memory. XLA's scan form writes and
re-reads an [N, 512, 4] f32 block per 512-triangle step.

Layout. One program owns a tile of rays (TILES) and walks every triangle
tile with an in-kernel ``fori_loop`` (Hopper runs
programs in parallel and in no order, so nothing is carried across
programs). Rays arrive feature-major ([9, N]: one contiguous row per
feature) and triangles as the 19 structurally non-zero coefficient rows of
``pack_tri_matrix`` ([19, T]), so every load is one contiguous row.

Arithmetic. The dots are unrolled exact-f32 FMAs on the CUDA cores. There
is no ``pl.dot``: K is 10, below Triton's minimum, and an f32 dot would run
in TF32 (~3 decimal digits), which flips accept decisions.

Two kernels:

- ``nearest``: a division-free running best per (ray, lane) element, one
  min and one index-min per ray at the end; the winner's id, barycentrics
  and t are recovered outside the kernel by one [N]-sized gather and an
  exact re-evaluation in XLA at Precision.HIGHEST.
- ``occluded``: shadow-ray any-hit — is any accepted triangle closer than
  t_max? An elementwise OR, reduced once per ray; no extraction. It is what NEE visibility needs
  (the reference computes a full nearest hit and compares ids,
  main.cpp:309-311; "no closer hit than the sampled point" is the same
  predicate evaluated directly).

The kernels are not differentiable and take no tangent: their inputs are
detached, and gradients reach t/u/v through the XLA re-evaluation, exactly
as they do through intersect_matmul.

``interpret`` is an explicit argument. Nothing derives it from the backend;
calling a compiled kernel where there is no GPU raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from monte_carlo_path_tracing_tpu.ops.intersect_ref import (
    BIG_T, DET_EPS, Hit, NO_HIT, T_EPS, ray_features,
)

#: (rays per program, triangles per inner-loop step, warps per program).
#: The four numerator fields and the running best are [rays, triangles]
#: f32 fields; at 32 x 64 over 4 warps each is 16 registers per thread.
#: Chosen by a sweep on an H100 over seven shapes from 16 x 64 to 128 x 32
#: (PERF.md, "Bring-up findings").
TILES = (32, 64, 4)

# Python-literal twins of intersect_ref's sentinels (a kernel may not
# capture array constants).
_BIG_T = 3.0e38
_NO_HIT = -1
_NO_IDX = 2**31 - 1

#: Row layout of the packed triangle coefficients (see _pack_tris).
_N_ROWS = 19


def _pack_tris(W: jnp.ndarray, tri_ids: jnp.ndarray, tile: int):
    """[T, 10, 4] coefficient matrices -> ([19, Tp] f32, [Tp] i32).

    Keeps only the non-zero entries of pack_tri_matrix's layout:
      rows 0-2   det   = rd . W[3:6, 0]
      rows 3-8   u_num = rd . W[3:6, 1] + m . W[6:9, 1]
      rows 9-14  v_num = rd . W[3:6, 2] + m . W[6:9, 2]
      rows 15-18 t_num = ro . W[0:3, 3] + W[9, 3]
    Padding triangles are all-zero (det = 0, never accepted)."""
    T = W.shape[0]
    pad = (-T) % tile
    cols = jnp.concatenate(
        [W[:, 3:6, 0], W[:, 3:6, 1], W[:, 6:9, 1], W[:, 3:6, 2],
         W[:, 6:9, 2], W[:, 0:3, 3], W[:, 9:10, 3]],
        axis=1,
    )                                                   # [T, 19]
    ids = tri_ids
    if pad:
        cols = jnp.concatenate([cols, jnp.zeros((pad, _N_ROWS), cols.dtype)])
        ids = jnp.concatenate([ids, jnp.full((pad,), NO_HIT - 1, jnp.int32)])
    return cols.T, ids


def _ray_rows(ro: jnp.ndarray, rd: jnp.ndarray, n_pad: int) -> jnp.ndarray:
    """[9, Np] feature-major rays: ro, rd, m = ro x rd (the constant 1
    feature is implicit in the t row)."""
    g = jnp.concatenate([ro, rd, jnp.cross(ro, rd)], axis=1)
    if n_pad:
        g = jnp.concatenate([g, jnp.zeros((n_pad, 9), g.dtype)])
    return g.T


def _tile_numerators(rays, w_ref, cols):
    """det/u/v/t numerators of this program's rays against one triangle
    tile, as [rays, triangles] fields (exact-f32 FMAs)."""
    ox, oy, oz, dx, dy, dz, mx, my, mz = rays
    w = lambda r: w_ref[r, cols][None, :]
    det = dx * w(0) + dy * w(1) + dz * w(2)
    u_num = dx * w(3) + dy * w(4) + dz * w(5) + mx * w(6) + my * w(7) + mz * w(8)
    v_num = (dx * w(9) + dy * w(10) + dz * w(11)
             + mx * w(12) + my * w(13) + mz * w(14))
    t_num = ox * w(15) + oy * w(16) + oz * w(17) + w(18)
    return det, u_num, v_num, t_num


def _accepts(det, u_num, v_num, t_num, ids, excl, t_eps):
    """Returns (margin, tp, adet): a triangle is accepted iff margin >= 0.

    The five accept conditions (|det|>eps, u>=0, v>=0, u+v<=det, t>t_eps —
    reference Myobj.cpp:175-188, all scaled by |det|) fold into one
    min-composed margin; the exclusion test (quirk Q8) rides as a select
    to -1. Only the two eps thresholds move from strict > to >=, a
    measure-zero change."""
    s = jnp.where(det < 0.0, -1.0, 1.0)
    adet = det * s
    up = u_num * s
    vp = v_num * s
    tp = t_num * s
    m = jnp.minimum(up, vp)
    m = jnp.minimum(m, adet - (up + vp))
    m = jnp.minimum(m, tp - t_eps * adet)
    m = jnp.minimum(m, adet - DET_EPS)
    m = jnp.where(ids[None, :] == excl[:, None], -1.0, m)
    return m, tp, adet


def _load_rays(g_ref, excl_ref, rt):
    rows = pl.ds(pl.program_id(0) * rt, rt)
    rays = tuple(g_ref[k, rows][:, None] for k in range(9))
    return rows, rays, excl_ref[rows]


def _kernel_nearest(g_ref, w_ref, ids_ref, excl_ref, idx_ref, *,
                    nb: int, rt: int, tt: int, t_eps: float):
    rows, rays, excl = _load_rays(g_ref, excl_ref, rt)

    # Running best per (ray, lane) element, as the fraction tp / adet with
    # its triangle tile: the comparison is division-free and no value
    # crosses threads until the loop ends (a per-tile min + argmin costs
    # warp shuffles on every step).
    def body(b, carry):
        bn, bd, bb = carry
        cols = pl.ds(b * tt, tt)
        m, tp, adet = _accepts(*_tile_numerators(rays, w_ref, cols),
                               ids_ref[cols], excl, t_eps)
        better = (m >= 0.0) & (tp * bd < bn * adet)
        return (jnp.where(better, tp, bn), jnp.where(better, adet, bd),
                jnp.where(better, b, bb))

    init = (jnp.full((rt, tt), _BIG_T, jnp.float32),
            jnp.ones((rt, tt), jnp.float32),
            jnp.zeros((rt, tt), jnp.int32))
    bn, bd, bb = jax.lax.fori_loop(0, nb, body, init)
    # One reduction per ray: the smallest t, then the lowest triangle index
    # among the lanes that hold it (the matmul path's tie order).
    bt = bn / bd
    t = jnp.min(bt, axis=1)
    lane = jax.lax.broadcasted_iota(jnp.int32, (rt, tt), 1)
    idx = jnp.min(jnp.where(bt == t[:, None], bb * tt + lane, _NO_IDX), axis=1)
    idx_ref[rows] = jnp.where(t < _BIG_T, idx, _NO_HIT)


def _kernel_occluded(g_ref, w_ref, ids_ref, excl_ref, tmax_ref, out_ref, *,
                     nb: int, rt: int, tt: int, t_eps: float):
    rows, rays, excl = _load_rays(g_ref, excl_ref, rt)
    tmax = tmax_ref[rows][:, None]   # pre-scaled: t_max * (1 - margin)

    def body(b, blocked):
        cols = pl.ds(b * tt, tt)
        m, tp, adet = _accepts(*_tile_numerators(rays, w_ref, cols),
                               ids_ref[cols], excl, t_eps)
        # Division-free: t < tmax  <=>  tp < tmax * adet (adet >= 0).
        return blocked | ((m >= 0.0) & (tp < tmax * adet)).astype(jnp.int32)

    blocked = jax.lax.fori_loop(0, nb, body, jnp.zeros((rt, tt), jnp.int32))
    out_ref[rows] = jnp.max(blocked, axis=1)


def _check_interpret(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton intersect kernels compile only for a GPU; on "
            f"{jax.default_backend()!r} pass interpret=True or use "
            "impl='matmul'"
        )


def _launch(kernel, ro, rd, W, tri_ids, exclude_id, extra, out_dtypes,
            t_eps, interpret):
    """Shared pallas_call plumbing: pads rays and triangles to their tiles,
    detaches every input, returns the unpadded outputs."""
    rt, tt, warps = TILES
    sg = jax.lax.stop_gradient
    N = ro.shape[0]
    n_pad = (-N) % rt
    wk, ids = _pack_tris(sg(W), tri_ids, tt)
    g = _ray_rows(sg(ro), sg(rd), n_pad)
    pad1 = lambda x, v: jnp.concatenate([x, jnp.full((n_pad,), v, x.dtype)])
    excl = pad1(exclude_id.astype(jnp.int32), NO_HIT)
    extra = [pad1(sg(x), 0) for x in extra]
    outs = pl.pallas_call(
        functools.partial(kernel, nb=wk.shape[1] // tt, rt=rt, tt=tt,
                          t_eps=t_eps),
        grid=((N + n_pad) // rt,),
        out_shape=[jax.ShapeDtypeStruct((N + n_pad,), d) for d in out_dtypes],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=warps,
                                                 num_stages=1),
        interpret=interpret,
        name=kernel.__name__.lstrip("_"),
    )(g, wk, ids, excl, *extra)
    return [o[:N] for o in outs]


@functools.partial(jax.jit, static_argnames=("t_eps", "interpret"))
def _nearest(ro, rd, W, tri_ids, exclude_id, t_eps: float, interpret: bool):
    (idx,) = _launch(_kernel_nearest, ro, rd, W, tri_ids, exclude_id, [],
                     [jnp.int32], t_eps, interpret)
    valid = idx >= 0
    # Winner recovery in XLA: one gather + an exact re-evaluation of the
    # winner's numerators. Gradients flow through ro/rd here, as they do
    # through intersect_matmul's take_along_axis. Padding never wins.
    idx = jnp.maximum(idx, 0)
    vals = jnp.einsum("nf,nfk->nk", ray_features(ro, rd), W[idx],
                      precision=jax.lax.Precision.HIGHEST)
    det = vals[:, 0]
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 0, det, 1.0)
    return Hit(
        t=jnp.where(valid, vals[:, 3] * inv_det, BIG_T),
        tri_id=jnp.where(valid, tri_ids[idx], NO_HIT),
        u=jnp.where(valid, vals[:, 1] * inv_det, 0.0),
        v=jnp.where(valid, vals[:, 2] * inv_det, 0.0),
        valid=valid,
    )


@functools.partial(jax.jit, static_argnames=("t_eps", "interpret"))
def _occluded(ro, rd, W, tri_ids, exclude_id, t_max, t_eps: float,
              interpret: bool):
    (out,) = _launch(_kernel_occluded, ro, rd, W, tri_ids, exclude_id,
                     [t_max.astype(jnp.float32)], [jnp.int32], t_eps,
                     interpret)
    return out > 0


def intersect_pallas(ro, rd, W, tri_ids, exclude_id=None, t_eps=T_EPS, *,
                     interpret: bool = False) -> Hit:
    """Nearest hit of N rays against W ([T, 10, 4], pack_tri_matrix)."""
    _check_interpret(interpret)
    if exclude_id is None:
        exclude_id = jnp.full((ro.shape[0],), NO_HIT, jnp.int32)
    return _nearest(ro, rd, W, tri_ids, exclude_id, float(t_eps), interpret)


def occluded_pallas(ro, rd, W, tri_ids, exclude_id, t_max, t_eps=T_EPS, *,
                    interpret: bool = False):
    """[N] bool: some accepted triangle lies closer than t_max (pre-scaled
    by the caller's margin)."""
    _check_interpret(interpret)
    return _occluded(ro, rd, W, tri_ids, exclude_id, t_max, float(t_eps),
                     interpret)

"""Wavefront radiance estimators.

The reference's three recursive estimators (SURVEY.md §3.2-3.3):

  - `shade_with_brdf` (main.cpp:348-399) -> :func:`_run_brdf`
  - `shade`           (main.cpp:269-344) -> :func:`_run_split`
  - `shade_with_mis`  (main.cpp:402-494) -> :func:`_run_mis`   (flagship)

re-formulated as a bounded wavefront loop: all N rays advance one bounce per
iteration of a `lax.fori_loop`, with termination as masks (miss, backface,
emissive stop per Q5/Q6, Russian roulette) — no data-dependent control flow,
so the whole estimator jits into one XLA program and shards over devices.

MIS restructure (quirk Q11): the reference's light strategy recursively
shades *occluders* of the light ray, making the recursion a 2-ary tree with
nominal branching 1.2 > 1. Here the light strategy is standard
next-event-estimation — an unoccluded light ray contributes the emissive
term directly (identical value), an occluded one contributes nothing (the
documented estimator difference), and the BRDF continuation divides by the
full BRDF pdf alone. With `cfg.ref_mis_weights=True` the reference's
weighting is reproduced instead: every continuation denominator adds the
sampler pdf of the *nearest light triangle along the ray*
(closet_ray_intersect_light_triangle, Myobj.cpp:476-622), queried against a
lights-only accel; the occluded-blocker recursion remains dropped.

All random decisions draw from deterministic threefry streams keyed by
(bounce, purpose) — see core/rng.py (quirk Q1 fix).

Differentiability: gradients flow through BRDF values, emission, cosine /
geometry factors and MIS weights into the material table; discrete events
(lobe and triangle choices, RR masks, visibility) and sampling *pdfs* are
detached, giving the standard detached-sampling estimator of
differentiable-rendering practice (BASELINE.json north star).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu.integrator import common
from monte_carlo_path_tracing_tpu.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu.scene.types import Scene
from monte_carlo_path_tracing_tpu.utils.config import (
    EST_BRDF, EST_MIS, EST_SHOOT, EST_SPLIT, LS_SPHERICAL, LS_UNIFORM_AREA,
    RenderConfig,
)

_SG = jax.lax.stop_gradient


def _impl(cfg: RenderConfig) -> str:
    if cfg.use_pallas is None:
        return "auto"
    return "pallas" if cfg.use_pallas else "matmul"


def render_rays(
    scene: Scene,
    cfg: RenderConfig,
    key: jax.Array,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    with_stats: bool = False,
    accel=None,
):
    """Estimate radiance [N,3] arriving at ray origins along -rd.

    with_stats=True additionally returns {"rays": scalar} — the number of
    rays actually traced (extend + shadow, counting only wavefront lanes
    that were live at each trace), the honest numerator of Mrays/s.

    ``accel`` optionally injects a prebuilt acceleration structure
    (TriAccel or GridAccel). The grid build is host-side, so with
    ``cfg.accel == "grid"`` and a *traced* scene callers must prebuild the
    grid eagerly and pass it here (render/renderer.py does).
    """
    if cfg.mis_blocker_compat:
        raise NotImplementedError(
            "mis_blocker_compat (the reference's occluded-blocker recursion) "
            "is a work-queue feature of the regeneration renderer — use "
            "render_image_regen / integrator.regen.render_regen"
        )
    if cfg.estimator == EST_SHOOT:
        # Legacy C17 estimator lives in its own module (dead code in the
        # reference; inventory parity only).
        from monte_carlo_path_tracing_tpu.integrator import legacy_shoot

        out = legacy_shoot.render_rays_shoot(
            scene, cfg, key, ro, rd, with_stats=True
        )
        L, stats = out
        if with_stats:
            return L, {"rays": stats["rays"],
                       "nonfinite": jnp.sum(~jnp.isfinite(L).all(axis=-1))}
        return L
    if accel is None:
        if cfg.accel == "grid":
            from monte_carlo_path_tracing_tpu.ops import grid as grid_mod

            accel = grid_mod.build_grid(scene, n0=cfg.grid_n0)
        else:
            accel = ops_intersect.build_accel(scene)
    tri_to_light = common.light_index_table(scene)
    args = (scene, cfg, accel, tri_to_light, key, ro, rd)
    if cfg.estimator == EST_BRDF:
        out = _run_brdf(*args)
    elif cfg.estimator == EST_SPLIT:
        out = _run_split(*args)
    elif cfg.estimator == EST_MIS:
        light_accel = (
            ops_intersect.build_light_accel(scene) if cfg.ref_mis_weights else None
        )
        out = _run_mis(*args, light_accel=light_accel)
    else:
        raise ValueError(f"unknown estimator {cfg.estimator!r}")
    L, nrays = out
    nonfinite = jnp.sum(~jnp.isfinite(L).all(axis=-1))
    if cfg.debug_checks:
        # Tripwire (reference main.cpp:110 / Myobj.cpp:465 printf style):
        # fires in compiled code when any lane produced a non-finite sample.
        jax.debug.print(
            "[tripwire] non-finite radiance lanes: {n}", n=nonfinite,
            ordered=False,
        )
    if with_stats:
        return L, {"rays": nrays, "nonfinite": nonfinite}
    return L


def _trace(cfg, accel, ro, rd, exclude):
    return ops_intersect.intersect(accel, ro, rd, exclude, impl=_impl(cfg))


# ---------------------------------------------------------------------------
# BRDF-only estimator (shade_with_brdf, main.cpp:348-399)
# ---------------------------------------------------------------------------

def _run_brdf(scene, cfg, accel, tri_to_light, key, ro, rd):
    N = ro.shape[0]

    def body(d, st):
        active, ro, rd, excl, tp, L, nrays = st
        hit = _trace(cfg, accel, ro, rd, excl)
        nrays = nrays + jnp.sum(active.astype(jnp.int32))
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front            # backface => 0 (Q9)

        # Emissive hit terminates with its radiance at any depth
        # (main.cpp:362-366, 392-396).
        emit_now = alive & si.is_light
        L = L + jnp.where(emit_now[:, None], tp * si.emission, 0.0)
        alive = alive & ~si.is_light

        # Russian roulette (main.cpp:375-380), then BRDF bounce.
        k_rr = rng.bounce_key(key, d, rng.P_RR)
        survive, w_rr = common.russian_roulette(k_rr, N, cfg.rr_prob)
        alive = alive & survive

        bs = phong.sample_brdf(
            rng.bounce_key(key, d, rng.P_BSDF),
            si.ns, si.wo, si.kd, si.ks, si.ns_exp,
            branch_pdf_compat=cfg.branch_pdf_compat,
        )
        cos_i = vm.dot(bs.wi, si.ns)
        alive = alive & (cos_i > 0.0) & (bs.pdf > 1e-12)

        f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
        scale = jnp.maximum(cos_i, 0.0) / _SG(jnp.maximum(bs.pdf, 1e-12)) * w_rr
        tp = jnp.where(alive[:, None], tp * f * scale[:, None], tp)
        return (alive, si.p, bs.wi, hit.tri_id, tp, L, nrays)

    init = (
        jnp.ones((N,), bool), ro, rd,
        jnp.full((N,), ops_intersect.NO_HIT, jnp.int32),
        jnp.ones((N, 3)), jnp.zeros((N, 3)), jnp.zeros((), jnp.int32),
    )
    st = jax.lax.fori_loop(0, cfg.max_depth, body, init)
    return st[5], st[6]


# ---------------------------------------------------------------------------
# Split direct/indirect estimator (shade, main.cpp:269-344)
# ---------------------------------------------------------------------------

def _sample_light(key, scene, cfg, si):
    """Dispatch to the configured light sampler. Returns
    (LightSample, weights_sum or None)."""
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.sample(key, scene, si.p, si.ns)
    ls = light_uniform.sample(key, scene, si.p.shape[0])
    return ls, None


def _direct_term(scene, cfg, accel, si, ls, alive, d, key):
    """Shadow-rayed direct-light contribution of `shade` (main.cpp:298-314).

    Visibility requires the shadow ray's nearest hit to be exactly the
    sampled light triangle (main.cpp:311).
    """
    wl_raw = ls.coord - si.p
    dist2 = jnp.maximum(jnp.sum(wl_raw * wl_raw, axis=-1), 1e-20)
    dist = jnp.sqrt(dist2)
    wl = wl_raw / dist[:, None]
    nl = ls.nl
    cos_x = vm.dot(wl, si.ns)
    cos_l = -vm.dot(wl, nl)
    ok = alive & ls.valid & (cos_x > 0.0) & (cos_l > 0.0)

    blocked = ops_intersect.occluded(
        accel, si.p, wl, dist, si.tri_id, impl=_impl(cfg)
    )
    visible = ok & ~blocked

    f = phong.eval_brdf(si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp)
    pdf = _SG(jnp.maximum(ls.pdf, 1e-20))
    if cfg.light_sampler == LS_UNIFORM_AREA or cfg.measure_bug_compat:
        # Area-measure geometry factor (main.cpp:313-314). With the
        # spherical sampler this pairing is the reference's Q3 bug,
        # reproduced only under measure_bug_compat.
        g = cos_x * cos_l / dist2
    else:
        # Solid-angle measure: pdf already includes the geometry.
        g = cos_x
    contrib = ls.emission * f * (g / pdf)[:, None]
    return jnp.where(visible[:, None], contrib, 0.0)


def _run_split(scene, cfg, accel, tri_to_light, key, ro, rd):
    N = ro.shape[0]

    def body(d, st):
        active, ro, rd, excl, tp, L, nrays = st
        hit = _trace(cfg, accel, ro, rd, excl)
        nrays = nrays + jnp.sum(active.astype(jnp.int32))
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front

        # Lights are pure emitters (Q5): contribute only when hit by a
        # *primary* ray — BRDF-sampled light hits are discarded because the
        # direct term owns them (main.cpp:283-288, 338).
        emit_now = alive & si.is_light & (d == 0)
        L = L + jnp.where(emit_now[:, None], tp * si.emission, 0.0)
        alive = alive & ~si.is_light

        # Direct lighting via the configured sampler (main.cpp:298-314).
        ls, _ = _sample_light(
            rng.bounce_key(key, d, rng.P_LIGHT_SELECT), scene, cfg, si
        )
        nrays = nrays + jnp.sum(alive.astype(jnp.int32))  # shadow rays
        L = L + tp * _direct_term(scene, cfg, accel, si, ls, alive, d, key)

        # RR gates only the indirect continuation (main.cpp:321-329).
        survive, w_rr = common.russian_roulette(
            rng.bounce_key(key, d, rng.P_RR), N, cfg.rr_prob
        )
        alive = alive & survive

        bs = phong.sample_brdf(
            rng.bounce_key(key, d, rng.P_BSDF),
            si.ns, si.wo, si.kd, si.ks, si.ns_exp,
            branch_pdf_compat=cfg.branch_pdf_compat,
        )
        cos_i = vm.dot(bs.wi, si.ns)
        alive = alive & (cos_i > 0.0) & (bs.pdf > 1e-12)

        f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
        scale = jnp.maximum(cos_i, 0.0) / _SG(jnp.maximum(bs.pdf, 1e-12)) * w_rr
        tp = jnp.where(alive[:, None], tp * f * scale[:, None], tp)
        return (alive, si.p, bs.wi, hit.tri_id, tp, L, nrays)

    init = (
        jnp.ones((N,), bool), ro, rd,
        jnp.full((N,), ops_intersect.NO_HIT, jnp.int32),
        jnp.ones((N, 3)), jnp.zeros((N, 3)), jnp.zeros((), jnp.int32),
    )
    st = jax.lax.fori_loop(0, cfg.max_depth, body, init)
    return st[5], st[6]


# ---------------------------------------------------------------------------
# Veach MIS estimator (shade_with_mis, main.cpp:402-494) — flagship
# ---------------------------------------------------------------------------

def _light_pdf_of_hit(scene, cfg, si, prev_p, prev_ns, prev_wsum):
    """Solid-angle pdf with which the light sampler (at the *previous*
    vertex) would have generated the direction that hit light `si`."""
    wl_raw = si.p - prev_p
    dist2 = jnp.maximum(jnp.sum(wl_raw * wl_raw, axis=-1), 1e-20)
    if cfg.light_sampler == LS_SPHERICAL:
        return light_spherical.pdf_of_tri(
            scene, prev_p, prev_ns, si.light_idx, prev_wsum
        )
    pdf_a = light_uniform.pdf_area(scene, jnp.maximum(si.light_idx, 0))
    wl = wl_raw / jnp.sqrt(dist2)[:, None]
    nl = si.ng          # hit triangle's vote-oriented normal, already gathered
    cos_l = -vm.dot(wl, nl)
    pdf = common.area_pdf_to_solid_angle(pdf_a, dist2, cos_l)
    return jnp.where(si.light_idx >= 0, pdf, 0.0)


def _nee_term(scene, cfg, accel, si, ls, wsum, alive):
    """MIS light strategy as NEE (main.cpp:443-464 restructured per Q11):
    contribution = I * f * cos / (p_light + p_brdf), both solid-angle."""
    wl_raw = ls.coord - si.p
    dist2 = jnp.maximum(jnp.sum(wl_raw * wl_raw, axis=-1), 1e-20)
    dist = jnp.sqrt(dist2)
    wl = wl_raw / dist[:, None]
    nl = ls.nl
    cos_x = vm.dot(wl, si.ns)
    cos_l = -vm.dot(wl, nl)
    ok = alive & ls.valid & (cos_x > 0.0) & (cos_l > 0.0)

    blocked = ops_intersect.occluded(
        accel, si.p, wl, dist, si.tri_id, impl=_impl(cfg)
    )
    visible = ok & ~blocked

    if cfg.light_sampler == LS_SPHERICAL:
        p_light = ls.pdf
    else:
        p_light = common.area_pdf_to_solid_angle(ls.pdf, dist2, cos_l)
    f, p_brdf = phong.eval_and_pdf_brdf(
        si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp
    )
    denom = _SG(jnp.maximum(p_light + p_brdf, 1e-20))

    contrib = ls.emission * f * (cos_x / denom)[:, None]
    return jnp.where(visible[:, None], contrib, 0.0)


def _run_mis(scene, cfg, accel, tri_to_light, key, ro, rd, light_accel=None):
    N = ro.shape[0]
    spherical = cfg.light_sampler == LS_SPHERICAL

    def body(d, st):
        (active, ro, rd, excl, tp, L,
         prev_pb, prev_p, prev_ns, prev_wsum, nrays) = st
        hit = _trace(cfg, accel, ro, rd, excl)
        nrays = nrays + jnp.sum(active.astype(jnp.int32))
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        alive = active & hit.valid & si.front            # backface => 0 (main.cpp:410-413)

        # Emissive hit: primary rays get full emission (main.cpp:416-421);
        # BRDF-continued rays get the balance-heuristic weight
        # p_b / (p_b + p_light) unless ref_mis_weights already folded the
        # light pdf into the throughput at the previous vertex.
        is_emit = alive & si.is_light
        if cfg.ref_mis_weights:
            w_emit = jnp.ones((N,))
        else:
            p_l = _light_pdf_of_hit(scene, cfg, si, prev_p, prev_ns, prev_wsum)
            w_emit = jnp.where(
                d > 0, prev_pb / _SG(jnp.maximum(prev_pb + p_l, 1e-20)), 1.0
            )
        L = L + jnp.where(is_emit[:, None], tp * si.emission * w_emit[:, None], 0.0)
        alive = alive & ~si.is_light

        # RR gates BOTH strategies (main.cpp:429-437): weight applies to the
        # light term and the continuation alike.
        survive, w_rr = common.russian_roulette(
            rng.bounce_key(key, d, rng.P_RR), N, cfg.rr_prob
        )
        alive = alive & survive
        tp = jnp.where(alive[:, None], tp * w_rr, tp)

        # Light strategy (NEE with MIS weight).
        if spherical:
            ls, wsum = light_spherical.sample(
                rng.bounce_key(key, d, rng.P_LIGHT_SELECT), scene, si.p, si.ns
            )
        else:
            ls = light_uniform.sample(
                rng.bounce_key(key, d, rng.P_LIGHT_SELECT), scene, N
            )
            wsum = jnp.zeros((N,))
        nrays = nrays + jnp.sum(alive.astype(jnp.int32))  # shadow rays
        L = L + tp * _nee_term(scene, cfg, accel, si, ls, wsum, alive)

        # BRDF strategy: sample, weight, continue (main.cpp:471-491).
        bs = phong.sample_brdf(
            rng.bounce_key(key, d, rng.P_BSDF),
            si.ns, si.wo, si.kd, si.ks, si.ns_exp,
            branch_pdf_compat=cfg.branch_pdf_compat,
        )
        cos_i = vm.dot(bs.wi, si.ns)
        alive = alive & (cos_i > 0.0) & (bs.pdf > 1e-12)

        denom = _SG(jnp.maximum(bs.pdf, 1e-12))
        if cfg.ref_mis_weights:
            # Reference weighting (main.cpp:484-491): add the sampler pdf of
            # the nearest light triangle along wi to the denominator.
            lh = _trace(cfg, light_accel, si.p, bs.wi, si.tri_id)
            lsi_idx = jnp.where(lh.valid, tri_to_light[jnp.maximum(lh.tri_id, 0)], -1)
            if spherical:
                p_l_along = light_spherical.pdf_of_tri(
                    scene, si.p, si.ns, lsi_idx, wsum
                )
            else:
                lp = si.p + lh.t[:, None] * bs.wi
                d2 = jnp.maximum(jnp.sum((lp - si.p) ** 2, axis=-1), 1e-20)
                nl = scene.geo_n[jnp.maximum(lh.tri_id, 0)]
                cos_l = -vm.dot(bs.wi, nl)
                p_l_along = jnp.where(
                    lh.valid,
                    common.area_pdf_to_solid_angle(
                        light_uniform.pdf_area(scene, jnp.maximum(lsi_idx, 0)),
                        d2, cos_l,
                    ),
                    0.0,
                )
            denom = _SG(jnp.maximum(bs.pdf + p_l_along, 1e-12))

        f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
        scale = jnp.maximum(cos_i, 0.0) / denom
        tp = jnp.where(alive[:, None], tp * f * scale[:, None], tp)

        return (
            alive, si.p, bs.wi, hit.tri_id, tp, L,
            _SG(bs.pdf), si.p, si.ns, wsum, nrays,
        )

    init = (
        jnp.ones((N,), bool), ro, rd,
        jnp.full((N,), ops_intersect.NO_HIT, jnp.int32),
        jnp.ones((N, 3)), jnp.zeros((N, 3)),
        jnp.ones((N,)), ro, rd, jnp.zeros((N,)), jnp.zeros((), jnp.int32),
    )
    st = jax.lax.fori_loop(0, cfg.max_depth, body, init)
    return st[5], st[10]

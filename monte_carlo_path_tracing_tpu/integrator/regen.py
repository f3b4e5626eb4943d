"""Path-regeneration wavefront renderer (forward/bench fast path).

The fixed-depth wavefront in wavefront.py runs max_depth iterations with
lanes dying off geometrically (RR 0.6): average live occupancy over a
32-deep loop is ~8%, i.e. >10x wasted vector work. This module keeps every
lane busy: when a path terminates, its lane immediately pulls the next
(pixel, spp) sample from a global counter and restarts as a primary ray —
the standard wavefront-regeneration scheme of GPU path tracing (see
PAPERS.md, "Megakernel vs Wavefront GPU Path Tracing"), expressed as a
`lax.while_loop` over fully-dense lane arrays with a scatter-add into the
framebuffer at path death.

Estimator semantics are identical to wavefront._run_mis / _run_split /
_run_brdf (same NEE/MIS weights, RR, quirk flags). RNG streams follow the
core/rng.py contract exactly: each lane's draws are keyed by
fold(fold(fold(fold(base, spp index), global pixel id), depth), purpose) —
a pure function of the (pixel, sample) path being traced — so the estimate
is deterministic for a given seed and invariant to lane count, launch
splitting, and device count, and the regeneration renderer consumes the
SAME streams as the fixed-depth renderer (tests/test_regen.py pins both).

This path is forward-only (while_loop is not reverse differentiable); the
fixed-depth loop remains the differentiation path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.core import rng, vecmath as vm
from monte_carlo_path_tracing_tpu.integrator import common
from monte_carlo_path_tracing_tpu.integrator.wavefront import (
    _impl, _light_pdf_of_hit, _nee_term, _sample_light,
)
from monte_carlo_path_tracing_tpu.ops import intersect as ops_intersect
from monte_carlo_path_tracing_tpu.render.camera import camera_basis, pixel_len
from monte_carlo_path_tracing_tpu.sampling import light_spherical, light_uniform, phong
from monte_carlo_path_tracing_tpu.scene.types import Scene
from monte_carlo_path_tracing_tpu.utils.config import (
    EST_BRDF, EST_MIS, EST_SPLIT, LS_SPHERICAL, RenderConfig,
)

_SG = jax.lax.stop_gradient

# Fold level reserved for blocker-chain streams (see render_regen): real
# streams fold (spp index, pixel) directly off the base key and never see
# this tag, so chain streams are disjoint from every launch's real streams.
_CHAIN_TAG = 0x5EED_CA1  # arbitrary 32-bit constant

class RegenStats(NamedTuple):
    """Scalar diagnostics of one regen launch (4th element of the return).

    ``chains`` is the number of blocker-chain continuations enqueued
    (mis_blocker_compat only; 0 otherwise) — a low-variance conservation
    quantity the oracle parity test pins (tests/test_oracle.py)."""

    spilled: jnp.ndarray  # chains dropped on queue overflow
    chains: jnp.ndarray   # chains enqueued
    # Rays physically traced (primary counted once per pixel when the
    # primary cache served it) — set by render_regen_cached; 0 elsewhere
    # means "same as the logical count".
    rays_physical: jnp.ndarray = 0


def _nee_full(scene, cfg, accel, tri_to_light, si, ls, alive):
    """Reference MIS light strategy WITH occluder shading
    (/root/reference/main.cpp:450-464): the light ray's nearest hit is
    shaded whatever it is — an emissive front hit contributes its radiance
    inline (the common case, identical to NEE), a non-emissive front hit
    becomes a blocker-chain seed traced as a continuation path through the
    caller's work queue. Returns (contrib [N,3], spawn [N], wl [N,3],
    w_chain [N,3] = f * cos / (p_light + p_brdf))."""
    wl_raw = ls.coord - si.p
    dist2 = jnp.maximum(jnp.sum(wl_raw * wl_raw, axis=-1), 1e-20)
    wl = wl_raw / jnp.sqrt(dist2)[:, None]
    cos_x = vm.dot(wl, si.ns)
    ok = alive & ls.valid & (cos_x > 0.0)

    lh = ops_intersect.intersect(accel, si.p, wl, si.tri_id, impl=_impl(cfg))
    si2 = common.gather_interaction(scene, lh, wl, tri_to_light)

    if cfg.light_sampler == LS_SPHERICAL:
        p_light = ls.pdf
    else:
        p_light = common.area_pdf_to_solid_angle(
            ls.pdf, dist2, -vm.dot(wl, ls.nl)
        )
    f, p_b = phong.eval_and_pdf_brdf(si.ns, wl, si.wo, si.kd, si.ks, si.ns_exp)
    denom = _SG(jnp.maximum(p_light + p_b, 1e-20))
    w_chain = f * (cos_x / denom)[:, None]

    emit_now = ok & lh.valid & si2.front & si2.is_light
    contrib = jnp.where(emit_now[:, None], w_chain * si2.emission, 0.0)
    spawn = ok & lh.valid & si2.front & ~si2.is_light
    return contrib, spawn, wl, w_chain


def primary_cache_eligible(cfg: RenderConfig) -> bool:
    """The primary-hit cache pre-pass (``render_regen_cached``) covers the
    configurations whose depth-0 work is per-pixel-deterministic: no
    sub-pixel jitter (the reference's default — all spp of a pixel re-trace
    one direction, main.cpp:563-567) and no blocker-chain compat (whose
    depth-0 NEE spawns queue work). Estimators: mis, brdf and split (split
    partitions on the hit mask alone, since its direct term is NOT gated
    by Russian roulette — main.cpp:298-329)."""
    return (
        not cfg.pixel_jitter
        and not cfg.mis_blocker_compat
        and cfg.estimator in (EST_MIS, EST_BRDF, EST_SPLIT)
    )


def _primary_dirs(cam, u_ax, v_ax, n_ax, dist, plen, gpix):
    """Camera ray directions for global pixel ids (no jitter) — must match
    ``render_regen``'s primary_rays bit-for-bit (same expression order)."""
    i = (gpix // cam.width).astype(jnp.float32)
    j = (gpix % cam.width).astype(jnp.float32)
    dx = -plen * (i - (cam.height - 1) / 2.0)
    dy = plen * (j - (cam.width - 1) / 2.0)
    rd = vm.normalize(
        dx[:, None] * u_ax[None] + dy[:, None] * v_ax[None]
        + dist * n_ax[None]
    )
    ro = jnp.broadcast_to(cam.eye, rd.shape)
    return ro, rd


def primary_prepass(
    scene: Scene,
    cfg: RenderConfig,
    base_key: jax.Array,
    n_pix: int,
    spp_cap: int,
    spp_rounds,
    pixel_offset=0,
    pixel_stride: int = 1,
    spp0=0,
    pix_chunk: int = 1 << 15,
):
    """Per-pixel primary-hit + depth-0 shading pre-pass (VERDICT r3 item 1).

    With jitter off, the reference re-traces ONE identical direction per
    pixel for all spp (main.cpp:563-572) — ~39% of all traced rays at the
    bench config recompute a per-pixel-constant primary hit, and the
    depth-0 Arvo ``prepare`` field (Mylight.cpp:322-422) is likewise
    per-pixel-constant. This pass traces each pixel's primary ray ONCE,
    prepares the spherical-sampling CDF ONCE per pixel, then runs the
    depth-0 estimator work (emission, RR, NEE with per-sample draws, BRDF
    sample) densely for all ``spp_rounds`` samples, emitting:

      - ``fb_pre [n_pix, 3]``: all depth-0 radiance (emission + NEE terms),
      - ``cache_f`` = 7-tuple of [n_pix] arrays (p, ns, wsum) and
        ``cache_tri [n_pix]``: what a regenerated lane needs to resume at
        depth 1 (1-D components),
      - ``seeds``: compacted continuation records (sample id, wi, tp, pdf)
        for every sample whose path survives the primary vertex — the
        regeneration loop (``render_regen(seed_mode=...)``) pulls these
        instead of camera samples, so the in-loop work drops from ~2.5 to
        ~1.5 vertices per path.

    Draw streams are IDENTICAL to the uncached path by construction: every
    depth-0 draw uses fold(fold(fold(base, spp0+round), gpix), 0) then the
    same purpose tags, and the triangle pick replicates rng.pick_weighted
    against the cached per-pixel CDF.

    ``spp_rounds`` may be a traced scalar (<= static ``spp_cap``, which
    sizes the seed buffers) so a 0-round warmup compiles the same program.

    Returns (fb_pre, cache_f, cache_tri, seeds_sample, seeds_f, seed_count,
    nrays_logical, nrays_physical): nrays_logical counts the primary trace
    once per SAMPLE (the estimator's equal-work ray count, comparable with
    the uncached renderer); nrays_physical counts it once per PIXEL (what
    the hardware actually traced).
    """
    # Clamp to the static cap: seed buffers and the r_ids iota only span
    # [0, spp_cap), so rounds beyond the cap would be silently dropped while
    # still counted in nrays_logical (round-4 advisor finding). Callers that
    # statically know spp > spp_cap get a raise in make_regen_sharded.
    spp_rounds = jnp.minimum(jnp.asarray(spp_rounds, jnp.int32), spp_cap)
    accel = ops_intersect.build_accel(scene)
    light_accel = (
        ops_intersect.build_light_accel(scene) if cfg.ref_mis_weights else None
    )
    tri_to_light = common.light_index_table(scene)
    spherical = cfg.light_sampler == LS_SPHERICAL
    is_mis = cfg.estimator == EST_MIS
    is_split = cfg.estimator == EST_SPLIT
    cam = scene.camera
    u_ax, v_ax, n_ax, dist = camera_basis(cam)
    plen = pixel_len(cam, dist)

    # Flattened per-chunk batch is chunk * spp_cap samples; clamp so it
    # stays ~256k rows whatever the launch's spp is.
    chunk = min(pix_chunk, n_pix, max(4096, (1 << 18) // max(spp_cap, 1)))
    n_chunks = -(-n_pix // chunk)
    total = n_pix * spp_cap
    w_rr = 1.0 / cfg.rr_prob
    R = spp_cap
    S = R * chunk

    fb_pre = jnp.zeros((n_chunks * chunk, 3))
    # Per-pixel resume cache (p, ns, wsum) as SEVEN 1-D arrays — same
    # layout rationale as the seed buffers below.
    cache_f = tuple(jnp.zeros((n_chunks * chunk,)) for _ in range(7))
    cache_tri = jnp.full((n_chunks * chunk,), ops_intersect.NO_HIT, jnp.int32)
    # Seed record = (sample id, wi, tp, pdf) stored as EIGHT 1-D arrays
    # (+1 sink row each for masked scatter writes): per-component scalar
    # scatters, like the regen loop's per-channel framebuffer scatter.
    seeds_sample = jnp.zeros((total + 1,), jnp.int32)
    seeds_f = tuple(jnp.zeros((total + 1,)) for _ in range(7))

    def chunk_body(c, carry):
        fb_pre, cache_f, cache_tri, seeds_sample, seeds_f, count, nsh = carry
        pix_local = c * chunk + jax.lax.broadcasted_iota(jnp.int32, (chunk, 1), 0)[:, 0]
        valid_pix = pix_local < n_pix
        gpix = pix_local * pixel_stride + pixel_offset
        ro, rd = _primary_dirs(cam, u_ax, v_ax, n_ax, dist, plen, gpix)
        hit = ops_intersect.intersect(
            accel, ro, rd,
            jnp.full((chunk,), ops_intersect.NO_HIT, jnp.int32),
            impl=_impl(cfg),
        )
        si = common.gather_interaction(scene, hit, rd, tri_to_light)
        hitok = valid_pix & hit.valid & si.front

        # Emission at depth 0: tp = 1 and weight 1 for every estimator here
        # (mis/brdf primary, main.cpp:416-421 / 362-366) and every sample of
        # a pixel is identical — add spp * emission once.
        em_rows = (hitok & si.is_light)[:, None]
        em_add = jnp.where(
            em_rows, si.emission * spp_rounds.astype(jnp.float32), 0.0
        )
        shade0 = hitok & ~si.is_light

        if (is_mis or is_split) and spherical:
            weights, wsum = light_spherical.prepare(scene, si.p, si.ns)
            cdf = jnp.cumsum(weights, axis=-1)            # [chunk, L]
            n_lights = weights.shape[-1]
        else:
            wsum = jnp.zeros((chunk,))
            cdf = None

        # Packed per-pixel stage table: the per-sample stage gathers ONE
        # 17-wide row per sample instead of ~10 separate field rows.
        stage_tab = jnp.concatenate(
            [si.p, si.ns, si.wo, si.kd, si.ks, si.ns_exp[:, None],
             wsum[:, None]],
            axis=1,
        )

        # ---- all spp rounds of this chunk flattened into ONE [S] batch ----
        # Flatten order is row-major (round, pixel); rounds beyond the
        # traced spp_rounds are masked dead. Samples that fail the RR /
        # hit / emitter gates do NO further work: a stable argsort packs
        # the survivors to the front and every per-sample stage (Arvo
        # select + warp, shadow trace, BRDF sample/eval, seed write) runs
        # on a fixed survivor-sized prefix (the regen loop keeps lanes
        # dense the same way; here compaction is the dense-batch analogue).
        r_ids = jax.lax.broadcasted_iota(jnp.int32, (R, chunk), 0)
        r_live = (r_ids < spp_rounds).reshape(S)
        sample_all = (r_ids * n_pix + pix_local[None, :]).reshape(S)
        k_r = rng.fold_in(base_key, spp0 + jnp.arange(R, dtype=jnp.int32))
        lk = jax.vmap(lambda k: rng.fold_in(k, gpix))(k_r).reshape(S)
        lk0 = rng.fold_in(lk, 0)
        xi_rr = rng.uniform(rng.fold_in(lk0, rng.P_RR), (S,))
        survive = xi_rr < cfg.rr_prob

        # Dense light pick (mis/split + spherical): the inverse-CDF pick
        # runs over ALL (round, pixel) pairs with the [chunk, L] CDF
        # broadcast along rounds — the compacted stage then gathers only
        # the 1-D pick result instead of an L-wide CDF row per sample
        # (L=320 on veach). Streams identical: u is
        # the same fold(fold(lk0, P_LIGHT_SELECT), 0) draw the stage
        # previously made per survivor.
        if (is_mis or is_split) and spherical:
            k_sel_d = rng.fold_in(rng.fold_in(lk0, rng.P_LIGHT_SELECT), 0)
            u_d = rng.uniform(k_sel_d, (S,))
            thresh_d = u_d.reshape(R, chunk) * wsum[None, :]
            lidx_d = jnp.minimum(
                jnp.sum(
                    (cdf[None, :, :] <= thresh_d[:, :, None]).astype(
                        jnp.int32
                    ),
                    -1,
                ),
                n_lights - 1,
            ).reshape(S)
        else:
            lidx_d = None
        # mis: RR gates BOTH strategies (main.cpp:429-437); brdf: gates the
        # continuation (the only depth-0 work besides emission); split: the
        # direct term runs for every primary-hit sample and RR gates only
        # the continuation (main.cpp:298-329) — so split partitions on the
        # hit mask and applies RR inside the stage.
        hit_live = jnp.broadcast_to(shade0[None], (R, chunk)).reshape(S) \
            & r_live
        cont0 = hit_live & survive
        part_mask = hit_live if is_split else cont0

        # Stable partition: survivors first, original order preserved — so
        # seed order is identical to the uncompacted formulation.
        order = jnp.argsort(~part_mask, stable=True)
        n_live = jnp.sum(part_mask.astype(jnp.int32))
        # Survivor count is ~rr_prob * hit_fraction * S; the prefix covers
        # rr_prob + 2.5% which a Binomial(S, rr_prob) essentially never
        # exceeds — the cond'd tail pass below keeps exactness anyway.
        # (split: no RR gate before the direct term, so no usable prefix.)
        P = S if is_split else \
            min(S, -(-int(S * min(1.0, cfg.rr_prob + 0.025)) // 256) * 256)

        def stage(rows, fb_acc, seeds_sample, seeds_f, count, nsh):
            """Depth-0 shading for the samples at flat indices ``rows``
            ([K]): NEE contribution scatter-added into fb_acc and
            continuation seeds appended. Per-pixel state is gathered from
            the [chunk]-sized cache, per-sample draws from each sample's
            own stream key — values are identical to the unpacked form."""
            live = part_mask[rows]
            pix = rows % chunk                           # flat = r*chunk + pix
            K = rows.shape[0]
            tab = stage_tab[pix]
            tri_c = si.tri_id[pix]
            lk0_c = lk0[rows]
            si_c = common.SurfaceInteraction(
                p=tab[:, 0:3], ns=tab[:, 3:6], wo=tab[:, 6:9],
                kd=tab[:, 9:12], ks=tab[:, 12:15], ns_exp=tab[:, 15],
                # fields the depth-0 stage never reads (hit/emitter gating
                # happened per pixel before flattening) — cheap stand-ins
                ng=tab[:, 3:6], emission=tab[:, 0:3],
                is_light=jnp.zeros((K,), bool), front=jnp.ones((K,), bool),
                tri_id=tri_c, light_idx=tri_c,
            )
            wsum_c = tab[:, 16]

            if is_split:
                kstep = rng.fold_in(lk0_c, rng.P_LIGHT_SELECT)
                if spherical:
                    lidx = lidx_d[rows]
                    ls = light_spherical.sample_from_pick(
                        rng.fold_in(kstep, 1), scene, si_c.p, si_c.ns,
                        lidx, wsum_c,
                    )
                else:
                    ls = light_uniform.sample(kstep, scene, rows.shape[0])
                nsh = nsh + jnp.sum(live.astype(jnp.float32))
                from monte_carlo_path_tracing_tpu.integrator.wavefront import (
                    _direct_term,
                )

                direct = _direct_term(scene, cfg, accel, si_c, ls, live, 0, kstep)
                dz = jnp.where(live[:, None], direct, 0.0)
                # per-channel 1-D scatters (see the regen loop's fb write)
                fb_acc = tuple(
                    f.at[pix].add(dz[:, i]) for i, f in enumerate(fb_acc)
                )
                live = live & survive[rows]   # RR gates only the bounce

            if is_mis:
                kstep = rng.fold_in(lk0_c, rng.P_LIGHT_SELECT)
                if spherical:
                    # rng.pick_weighted semantics against the cached CDF,
                    # picked DENSELY before compaction (lidx_d above)
                    ls = light_spherical.sample_from_pick(
                        rng.fold_in(kstep, 1), scene, si_c.p, si_c.ns,
                        lidx_d[rows], wsum_c,
                    )
                else:
                    ls = light_uniform.sample(kstep, scene, rows.shape[0])
                nsh = nsh + jnp.sum(live.astype(jnp.float32))
                nee = _nee_term(scene, cfg, accel, si_c, ls, wsum_c, live)
                nz = jnp.where(live[:, None], w_rr * nee, 0.0)
                fb_acc = tuple(
                    f.at[pix].add(nz[:, i]) for i, f in enumerate(fb_acc)
                )

            kb = rng.fold_in(lk0_c, rng.P_BSDF)
            bs = phong.sample_brdf(
                kb, si_c.ns, si_c.wo, si_c.kd, si_c.ks, si_c.ns_exp,
                branch_pdf_compat=cfg.branch_pdf_compat,
            )
            cos_i = vm.dot(bs.wi, si_c.ns)
            cont = live & (cos_i > 0.0) & (bs.pdf > 1e-12)

            denom = _SG(jnp.maximum(bs.pdf, 1e-12))
            if is_mis and cfg.ref_mis_weights:
                lh = ops_intersect.intersect(
                    light_accel, si_c.p, bs.wi, si_c.tri_id, impl=_impl(cfg),
                )
                lidx_l = jnp.where(
                    lh.valid, tri_to_light[jnp.maximum(lh.tri_id, 0)], -1
                )
                if spherical:
                    p_al = light_spherical.pdf_of_tri(
                        scene, si_c.p, si_c.ns, lidx_l, wsum_c
                    )
                else:
                    d2 = jnp.maximum(lh.t * lh.t, 1e-20)
                    nl = scene.geo_n[jnp.maximum(lh.tri_id, 0)]
                    p_al = jnp.where(
                        lh.valid,
                        common.area_pdf_to_solid_angle(
                            light_uniform.pdf_area(
                                scene, jnp.maximum(lidx_l, 0)
                            ),
                            d2, -vm.dot(bs.wi, nl),
                        ),
                        0.0,
                    )
                denom = _SG(jnp.maximum(bs.pdf + p_al, 1e-12))

            f = phong.eval_brdf(
                si_c.ns, bs.wi, si_c.wo, si_c.kd, si_c.ks, si_c.ns_exp
            )
            tp_next = f * (jnp.maximum(cos_i, 0.0) / denom * w_rr)[:, None]

            rank = jnp.cumsum(cont.astype(jnp.int32)) - 1
            slot = jnp.where(cont, count + rank, total)
            seeds_sample = seeds_sample.at[slot].set(sample_all[rows])
            svals = (bs.wi[:, 0], bs.wi[:, 1], bs.wi[:, 2],
                     tp_next[:, 0], tp_next[:, 1], tp_next[:, 2],
                     _SG(bs.pdf))
            seeds_f = tuple(
                sf.at[slot].set(v) for sf, v in zip(seeds_f, svals)
            )
            count = count + jnp.sum(cont.astype(jnp.int32))
            return fb_acc, seeds_sample, seeds_f, count, nsh

        fb_acc = tuple(jnp.zeros((chunk,)) for _ in range(3))
        fb_acc, seeds_sample, seeds_f, count, nsh = stage(
            order[:P], fb_acc, seeds_sample, seeds_f, count, nsh
        )
        if P < S:
            # Overflow tail (survivors beyond the prefix): statistically
            # never taken; compiled but only executed when needed.
            fb_acc, seeds_sample, seeds_f, count, nsh = jax.lax.cond(
                n_live > P,
                lambda ops: stage(order[P:], *ops),
                lambda ops: ops,
                (fb_acc, seeds_sample, seeds_f, count, nsh),
            )
        fb_pre = jax.lax.dynamic_update_slice(
            fb_pre,
            jax.lax.dynamic_slice(fb_pre, (c * chunk, 0), (chunk, 3))
            + jnp.stack(fb_acc, axis=1) + em_add,
            (c * chunk, 0),
        )
        cvals = (si.p[:, 0], si.p[:, 1], si.p[:, 2],
                 si.ns[:, 0], si.ns[:, 1], si.ns[:, 2], wsum)
        cache_f = tuple(
            jax.lax.dynamic_update_slice(cf, v, (c * chunk,))
            for cf, v in zip(cache_f, cvals)
        )
        cache_tri = jax.lax.dynamic_update_slice(
            cache_tri, hit.tri_id, (c * chunk,)
        )
        return fb_pre, cache_f, cache_tri, seeds_sample, seeds_f, count, nsh

    fb_pre, cache_f, cache_tri, seeds_sample, seeds_f, seed_count, n_shadow = (
        jax.lax.fori_loop(
            0, n_chunks, chunk_body,
            (fb_pre, cache_f, cache_tri, seeds_sample, seeds_f,
             jnp.zeros((), jnp.int32), jnp.zeros((), jnp.float32)),
        )
    )
    nrays_logical = spp_rounds.astype(jnp.float32) * n_pix + n_shadow
    nrays_physical = jnp.float32(n_pix) + n_shadow
    return (
        fb_pre[:n_pix], tuple(cf[:n_pix] for cf in cache_f),
        cache_tri[:n_pix],
        seeds_sample, seeds_f, seed_count, nrays_logical, nrays_physical,
    )


def render_regen_cached(
    scene: Scene,
    cfg: RenderConfig,
    base_key: jax.Array,
    n_pix: int,
    spp_cap: int,
    spp_rounds,
    lanes: int = 1 << 16,
    pixel_offset=0,
    pixel_stride: int = 1,
    spp0=0,
):
    """Primary-cache renderer: :func:`primary_prepass` (dense depth-0 work,
    one primary trace + one Arvo prepare per PIXEL) + the regeneration loop
    pulling the pre-pass's continuation seeds (depth >= 1 only). Same
    estimate and draw streams as ``render_regen`` with
    ``total_samples = n_pix * spp_rounds`` (tests/test_regen.py pins the
    parity); returns the same (fb, nrays, iters, stats) tuple with nrays =
    the LOGICAL ray count (primary counted per sample — the equal-work
    number comparable across renderers; the physically-traced count is in
    ``stats.rays_physical``)."""
    spp_rounds = jnp.asarray(spp_rounds, jnp.int32)
    (fb_pre, cache_f, cache_tri, seeds_sample, seeds_f, seed_count,
     n_log, n_phys) = primary_prepass(
        scene, cfg, base_key, n_pix, spp_cap, spp_rounds,
        pixel_offset=pixel_offset, pixel_stride=pixel_stride, spp0=spp0,
    )
    fb, nrays_loop, iters, stats = render_regen(
        scene, cfg, base_key, n_pix, seed_count, lanes=lanes,
        pixel_offset=pixel_offset, pixel_stride=pixel_stride, spp0=spp0,
        seed_mode=(seeds_sample, seeds_f, cache_f, cache_tri, fb_pre),
    )
    stats = stats._replace(rays_physical=n_phys + nrays_loop)
    return fb, n_log + nrays_loop, iters, stats


def render_regen(
    scene: Scene,
    cfg: RenderConfig,
    base_key: jax.Array,
    n_pix: int,
    total_samples: int,
    lanes: int = 1 << 16,
    pixel_offset=0,
    pixel_stride: int = 1,
    spp0: int = 0,
    seed_mode=None,
):
    """Render `total_samples` paths distributed round-robin over `n_pix`
    local pixels; local pixel i maps to global image pixel
    i * pixel_stride + pixel_offset. Returns (framebuffer_sum [n_pix,3]
    indexed by LOCAL pixel, rays_traced scalar, iterations scalar).

    (stride, offset) lets a mesh shard own an INTERLEAVED pixel subset —
    neighbouring pixels cost similar work, so interleaving balances load
    across devices far better than contiguous blocks (SURVEY.md §7 hard
    part 4) — while ray generation still uses global image coordinates
    (see parallel.sharded.render_regen_sharded).

    ``spp0`` is the global spp index of this launch's first sample round, so
    multi-launch drivers (render/renderer.py) keep globally-keyed streams:
    local sample s is spp round spp0 + s // n_pix of global pixel
    (s % n_pix) * pixel_stride + pixel_offset.

    ``seed_mode`` (set by :func:`render_regen_cached`) switches the sample
    source from camera rays to the primary pre-pass's continuation seeds:
    a 5-tuple (seeds_sample, seeds_f, cache_f, cache_tri, fb_pre), where
    seeds_f and cache_f are 7-tuples of 1-D arrays (see primary_prepass).
    Free lanes then pull seed records (resuming at depth 1 with the cached
    per-pixel interaction) and ``total_samples`` is the seed count."""
    seeded = seed_mode is not None
    if seeded:
        seeds_sample, seeds_f, cache_f, cache_tri, fb_pre = seed_mode
        assert not cfg.mis_blocker_compat, "seed_mode excludes blocker compat"
    accel = ops_intersect.build_accel(scene)
    light_accel = (
        ops_intersect.build_light_accel(scene) if cfg.ref_mis_weights else None
    )
    # Blocker-chain work queue (cfg.mis_blocker_compat): the reference's MIS
    # recursion is a 2-ary tree (quirk Q11) whose light branch shades the
    # occluder of a blocked light ray; here those recursions become queued
    # continuation paths that free lanes pull before new camera samples —
    # the regeneration machinery doubles as the tree scheduler. Chains draw
    # from a DEDICATED stream family: sample ids < 0 encode a per-launch
    # chain counter, and lane_stream routes them through fold(base,
    # _CHAIN_TAG) -> fold(spp0) -> fold(chain id) — disjoint from every
    # real (spp, pixel) stream of every launch (real streams never fold
    # _CHAIN_TAG first), so multi-launch renders cannot correlate a
    # launch-k chain with a launch-k+1 camera sample. The chain id is
    # scheduler-dependent; the estimator mean is scheduling-invariant.
    blocker = bool(cfg.mis_blocker_compat) and cfg.estimator == EST_MIS
    tri_to_light = common.light_index_table(scene)
    spherical = cfg.light_sampler == LS_SPHERICAL
    cam = scene.camera

    u_ax, v_ax, n_ax, dist = camera_basis(cam)
    plen = pixel_len(cam, dist)

    C = lanes

    # Chain streams live under a tag fold no real stream ever applies;
    # folding spp0 next makes them launch-unique (spp0 is globally monotonic
    # across a multi-launch render, renderer.py).
    chain_base = rng.fold_in(rng.fold_in(base_key, _CHAIN_TAG), spp0)

    def lane_stream(sample, pixel):
        """Per-lane stream keys per the core/rng.py contract: base folded by
        (spp index, global pixel id) — matching render/renderer.py's
        _sample_pass fold order exactly. Negative samples are blocker-chain
        ids (-1 - chain_id) and draw from the disjoint chain_base family."""
        is_chain = sample < 0
        real = jnp.where(is_chain, 0, sample)
        k = rng.fold_in(base_key, spp0 + real // n_pix)
        k_real = rng.fold_in(k, pixel * pixel_stride + pixel_offset)
        k_chain = rng.fold_in(chain_base, -1 - sample)
        return jnp.where(is_chain, k_chain, k_real)

    def primary_rays(pixel, lk):
        i = (pixel // cam.width).astype(jnp.float32)
        j = (pixel % cam.width).astype(jnp.float32)
        if cfg.pixel_jitter:
            off = rng.uniform(
                rng.bounce_key(lk, 0, rng.P_PIXEL_JITTER), (C, 2), -0.5, 0.5
            )
            i = i + off[:, 0]
            j = j + off[:, 1]
        dx = -plen * (i - (cam.height - 1) / 2.0)
        dy = plen * (j - (cam.width - 1) / 2.0)
        rd = vm.normalize(
            dx[:, None] * u_ax[None] + dy[:, None] * v_ax[None]
            + dist * n_ax[None]
        )
        ro = jnp.broadcast_to(cam.eye, rd.shape)
        return ro, rd

    # Scene bounds for the lane-sort morton key.
    verts = jnp.concatenate([scene.tri_v0, scene.tri_v0 + scene.tri_e1,
                             scene.tri_v0 + scene.tri_e2])
    scene_lo = jnp.min(verts, axis=0)
    scene_inv = 1.0 / jnp.maximum(jnp.max(verts, axis=0) - scene_lo, 1e-20)

    _LANE_ARRAYS = (
        "alive", "pixel", "sample", "depth", "ro", "rd", "excl", "tp", "L",
        "prev_pb", "prev_p", "prev_ns", "prev_w",
    )

    def _spread5(x):  # 5 bits -> every 3rd bit of 15
        x = (x | (x << 8)) & 0x0100F
        x = (x | (x << 4)) & 0x010C3
        x = (x | (x << 2)) & 0x09249
        return x

    def sort_lanes(st):
        """Reorder lanes by (direction cone, origin morton) so each kernel
        ray tile is spatially/directionally coherent — what a culled or
        BVH intersect would need. Pure permutation of per-lane state: every
        draw is keyed by the lane's (sample, pixel, depth), so the estimate
        is unchanged. Opt-in (cfg.ray_sort): the all-pairs kernels gain
        nothing from it."""
        ro, rd = st["ro"], st["rd"]
        q = jnp.clip(
            ((ro - scene_lo) * scene_inv * 31.0).astype(jnp.int32), 0, 31
        )
        morton = (
            _spread5(q[:, 0]) | (_spread5(q[:, 1]) << 1)
            | (_spread5(q[:, 2]) << 2)
        )
        # Direction key: 3 bits per axis (not just the octant sign), so a
        # tile of sorted lanes spans a narrow cone.
        dq = jnp.clip(((rd * 0.5 + 0.5) * 7.0).astype(jnp.int32), 0, 7)
        dkey = (dq[:, 0] << 6) | (dq[:, 1] << 3) | dq[:, 2]
        # idle lanes sort to the back so live work stays dense in tiles
        key = jnp.where(st["alive"], (dkey << 15) | morton, (1 << 24) - 1)
        order = jnp.argsort(key)
        out = dict(st)
        for k in _LANE_ARRAYS:
            out[k] = st[k][order]
        return out

    do_sort = cfg.ray_sort
    sort_every = max(int(cfg.ray_sort_every), 1)

    def cond(st):
        more = (st["counter"] < total_samples) | jnp.any(st["alive"])
        if blocker:
            more = more | (st["buf_count"] > 0)
        return more

    def body(st):
        if do_sort:
            if sort_every == 1:
                st = sort_lanes(st)
            else:
                st = jax.lax.cond(
                    st["iter"] % sort_every == 0, sort_lanes, lambda s: s, st
                )
        alive = st["alive"]
        depth = st["depth"]
        # Stream keys of the (sample, pixel) each lane is currently tracing.
        lk = lane_stream(st["sample"], st["pixel"])
        # Hoist the depth fold: bounce_key(lk, depth, p) == fold(lk_d, p),
        # so the three per-iteration purposes share one [C] threefry fold
        # instead of paying it each (stream-identical by construction).
        lk_d = rng.fold_in(lk, depth)

        # ---- one bounce for live lanes (semantics of wavefront._run_mis
        #      / _run_split / _run_brdf depending on cfg.estimator) ----
        hit = ops_intersect.intersect(
            accel, st["ro"], st["rd"], st["excl"], impl=_impl(cfg)
        )
        # f32 accumulator: big renders overflow int32 (1024^2 x 1024 spp
        # traces ~2.7e9 rays); 1e-7 relative error is fine for throughput.
        nrays = st["nrays"] + jnp.sum(alive.astype(jnp.float32))
        si = common.gather_interaction(scene, hit, st["rd"], tri_to_light)
        cont = alive & hit.valid & si.front
        L = st["L"]
        tp = st["tp"]

        is_primary = depth == 0
        is_emit = cont & si.is_light
        if cfg.estimator == EST_MIS:
            if cfg.ref_mis_weights:
                w_emit = jnp.ones((C,))
            else:
                p_l = _light_pdf_of_hit(
                    scene, cfg, si, st["prev_p"], st["prev_ns"], st["prev_w"]
                )
                w_emit = jnp.where(
                    is_primary, 1.0,
                    st["prev_pb"] / _SG(jnp.maximum(st["prev_pb"] + p_l, 1e-20)),
                )
        elif cfg.estimator == EST_BRDF:
            w_emit = jnp.ones((C,))
        else:  # split: emission only on primary hits
            w_emit = jnp.where(is_primary, 1.0, 0.0)
        L = L + jnp.where(is_emit[:, None], tp * si.emission * w_emit[:, None], 0.0)
        cont = cont & ~si.is_light

        # Russian roulette placement differs per estimator (Q6/§3.2-3.3):
        # mis: gates both strategies; split: only the continuation; brdf:
        # before the bounce.
        xi_rr = rng.uniform(rng.fold_in(lk_d, rng.P_RR), (C,))
        survive = xi_rr < cfg.rr_prob
        w_rr = 1.0 / cfg.rr_prob

        if cfg.estimator == EST_MIS:
            cont = cont & survive
            tp = jnp.where(cont[:, None], tp * w_rr, tp)

        # Light strategy / direct term.
        if cfg.estimator in (EST_MIS, EST_SPLIT):
            kstep = rng.fold_in(lk_d, rng.P_LIGHT_SELECT)
            if cfg.estimator == EST_MIS:
                if spherical:
                    ls, wsum = light_spherical.sample(kstep, scene, si.p, si.ns)
                else:
                    ls = light_uniform.sample(kstep, scene, C)
                    wsum = jnp.zeros((C,))
                nrays = nrays + jnp.sum(cont.astype(jnp.float32))
                if blocker:
                    nee, spawn, wl_sp, w_chain = _nee_full(
                        scene, cfg, accel, tri_to_light, si, ls, cont
                    )
                    L = L + tp * nee
                    chain_tp = tp * w_chain
                else:
                    L = L + tp * _nee_term(scene, cfg, accel, si, ls, wsum, cont)
            else:
                ls, wsum_ = _sample_light(kstep, scene, cfg, si)
                wsum = jnp.zeros((C,))
                nrays = nrays + jnp.sum(cont.astype(jnp.float32))
                from monte_carlo_path_tracing_tpu.integrator.wavefront import _direct_term

                L = L + tp * _direct_term(scene, cfg, accel, si, ls, cont, depth, kstep)
            if cfg.estimator == EST_SPLIT:
                cont = cont & survive
                tp_rr = w_rr
            else:
                tp_rr = 1.0
        else:
            wsum = jnp.zeros((C,))
            cont = cont & survive
            tp_rr = w_rr

        # BRDF bounce.
        kstep_b = rng.fold_in(lk_d, rng.P_BSDF)
        bs = phong.sample_brdf(
            kstep_b, si.ns, si.wo, si.kd, si.ks, si.ns_exp,
            branch_pdf_compat=cfg.branch_pdf_compat,
        )
        cos_i = vm.dot(bs.wi, si.ns)
        cont = cont & (cos_i > 0.0) & (bs.pdf > 1e-12)

        denom = _SG(jnp.maximum(bs.pdf, 1e-12))
        if cfg.estimator == EST_MIS and cfg.ref_mis_weights:
            lh = ops_intersect.intersect(
                light_accel, si.p, bs.wi, si.tri_id, impl=_impl(cfg)
            )
            lidx = jnp.where(lh.valid, tri_to_light[jnp.maximum(lh.tri_id, 0)], -1)
            if spherical:
                p_al = light_spherical.pdf_of_tri(scene, si.p, si.ns, lidx, wsum)
            else:
                d2 = jnp.maximum(lh.t * lh.t, 1e-20)
                nl = scene.geo_n[jnp.maximum(lh.tri_id, 0)]
                p_al = jnp.where(
                    lh.valid,
                    common.area_pdf_to_solid_angle(
                        light_uniform.pdf_area(scene, jnp.maximum(lidx, 0)),
                        d2, -vm.dot(bs.wi, nl),
                    ),
                    0.0,
                )
            denom = _SG(jnp.maximum(bs.pdf + p_al, 1e-12))

        f = phong.eval_brdf(si.ns, bs.wi, si.wo, si.kd, si.ks, si.ns_exp)
        scale = jnp.maximum(cos_i, 0.0) / denom * tp_rr
        tp = jnp.where(cont[:, None], tp * f * scale[:, None], tp)

        # Lanes whose path ended this bounce (were alive, won't continue).
        died = alive & ~cont

        # ---- scatter finished paths & regenerate ----
        # Dead lanes write their pixel; live lanes each write a DISTINCT
        # dummy row (n_pix + lane). A single shared dummy row serializes
        # the scatter-add on the colliding index.
        lane_ids = jax.lax.broadcasted_iota(jnp.int32, (C, 1), 0)[:, 0]
        tgt = jnp.where(died, st["pixel"], n_pix + lane_ids)
        Lz = jnp.where(died[:, None], L, 0.0)
        # Framebuffer as three 1-D arrays, one scalar scatter-add each.
        fb = tuple(st["fb" + str(i)].at[tgt].add(Lz[:, i]) for i in range(3))

        free = died | ~alive            # dead now, or idle from before

        out = {}
        if blocker:
            # ---- enqueue this bounce's blocker chains ----
            B = C                       # queue capacity = lane count
            rank_s = jnp.cumsum(spawn.astype(jnp.int32)) - 1
            slot = st["buf_count"] + rank_s
            can = spawn & (slot < B)
            idx_w = jnp.where(can, slot, B)      # row B = overflow sink
            chain_sample = -1 - (st["chain_counter"] + rank_s)
            out["buf_ro"] = st["buf_ro"].at[idx_w].set(si.p)
            out["buf_rd"] = st["buf_rd"].at[idx_w].set(wl_sp)
            out["buf_tp"] = st["buf_tp"].at[idx_w].set(chain_tp)
            out["buf_pixel"] = st["buf_pixel"].at[idx_w].set(st["pixel"])
            out["buf_excl"] = st["buf_excl"].at[idx_w].set(si.tri_id)
            out["buf_sample"] = st["buf_sample"].at[idx_w].set(chain_sample)
            out["buf_depth"] = st["buf_depth"].at[idx_w].set(depth + 1)
            n_spawn = jnp.sum(can.astype(jnp.int32))
            buf_count = st["buf_count"] + n_spawn
            out["chain_counter"] = st["chain_counter"] + n_spawn
            out["spilled"] = st["spilled"] + jnp.sum(
                (spawn & ~can).astype(jnp.int32)
            )

        rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        if blocker:
            # ---- dequeue: free lanes pull queued chains (LIFO) first ----
            take_chain = free & (rank < buf_count)
            src = jnp.clip(buf_count - 1 - rank, 0, B)
            rank_new = rank - buf_count
            out["buf_count"] = buf_count - jnp.sum(take_chain.astype(jnp.int32))
        else:
            take_chain = jnp.zeros((C,), bool)
            src = jnp.zeros((C,), jnp.int32)
            rank_new = rank
        avail = total_samples - st["counter"]
        take = free & ~take_chain & (rank_new < avail)
        new_sample = st["counter"] + rank_new
        n_taken = jnp.sum(take.astype(jnp.int32))

        if seeded:
            # Pull the next continuation seeds (depth-1 resume records from
            # the primary pre-pass); per-pixel interaction from the cache.
            sidx = jnp.clip(new_sample, 0, seeds_sample.shape[0] - 1)
            s_val = seeds_sample[sidx]
            pixel_new = (s_val % n_pix).astype(jnp.int32)
            # per-component 1-D gathers (cache/seed buffers are tuples of
            # 1-D arrays — see primary_prepass's layout note)
            cf = [c[pixel_new] for c in cache_f]      # (p, ns, wsum)
            sf = [s[sidx] for s in seeds_f]           # (wi, tp, pdf)
            ro_new = jnp.stack(cf[0:3], axis=1)
            ns_new = jnp.stack(cf[3:6], axis=1)
            wsum_new = cf[6]
            rd_new = jnp.stack(sf[0:3], axis=1)
            tp_new = jnp.stack(sf[3:6], axis=1)
            pb_new = sf[6]
            excl_new = cache_tri[pixel_new]
            sample_new = s_val
            depth_new = jnp.ones((C,), jnp.int32)
        else:
            # local fb index in [0, n_pix); ray generation uses the global
            # image pixel id (local + shard offset)
            pixel_new = (new_sample % n_pix).astype(jnp.int32)
            ro_new, rd_new = primary_rays(
                pixel_new * pixel_stride + pixel_offset,
                lane_stream(new_sample, pixel_new),
            )
            ns_new, wsum_new = rd_new, jnp.zeros((C,))
            tp_new = jnp.ones((C, 3))
            pb_new = jnp.ones((C,))
            excl_new = jnp.full((C,), ops_intersect.NO_HIT, jnp.int32)
            sample_new = new_sample
            depth_new = jnp.zeros((C,), jnp.int32)

        def sel(a, b, c):
            """take -> a (new sample), take_chain -> b (queued chain),
            else -> c (continuation)."""
            tk, tc = take, take_chain
            if a.ndim > 1:
                tk, tc = take[:, None], take_chain[:, None]
            return jnp.where(tk, a, jnp.where(tc, b, c) if blocker else c)

        # Dequeue from the POST-enqueue buffers (out["buf_*"], written above):
        # buf_count and the LIFO top already include this iteration's spawns,
        # so reading st["buf_*"] here would hand freed lanes stale/unwritten
        # slots — chains dropped or double-traced (round-2 advisor finding).
        bq = (lambda k: out["buf_" + k][src]) if blocker else (lambda k: 0)
        out.update({
            "alive": cont | take | take_chain,
            "pixel": sel(pixel_new, bq("pixel"), st["pixel"]),
            "sample": sel(sample_new, bq("sample"), st["sample"]),
            "depth": sel(depth_new, bq("depth"), depth + 1),
            "ro": sel(ro_new, bq("ro"), si.p),
            "rd": sel(rd_new, bq("rd"), bs.wi),
            "excl": sel(excl_new, bq("excl"), hit.tri_id),
            "tp": sel(tp_new, bq("tp"), tp),
            "L": jnp.where((take | take_chain)[:, None], 0.0, L),
            # prev_* feed the balance-heuristic emission weight, which
            # blocker mode never uses (it implies ref_mis_weights) — chains
            # may inherit stale values harmlessly. Seeded pulls resume at
            # depth 1, so their prev_* are the REAL depth-0 vertex values
            # (from the pre-pass cache); fresh depth-0 pulls never read
            # theirs (w_emit is 1 on primary hits).
            "prev_pb": jnp.where(take, pb_new, _SG(bs.pdf)),
            "prev_p": jnp.where(take[:, None], ro_new, si.p),
            "prev_ns": jnp.where(take[:, None], ns_new, si.ns),
            "prev_w": jnp.where(take, wsum_new, wsum),
            "counter": st["counter"] + n_taken,
            "fb0": fb[0], "fb1": fb[1], "fb2": fb[2],
            "nrays": nrays,
            "iter": st["iter"] + 1,
        })
        return out

    zero3 = jnp.zeros((C, 3))
    st = {
        "alive": jnp.zeros((C,), bool),
        "pixel": jnp.zeros((C,), jnp.int32),
        "sample": jnp.zeros((C,), jnp.int32),
        "depth": jnp.zeros((C,), jnp.int32),
        "ro": zero3,
        "rd": jnp.concatenate([jnp.zeros((C, 2)), jnp.ones((C, 1))], axis=1),
        "excl": jnp.full((C,), ops_intersect.NO_HIT, jnp.int32),
        "tp": jnp.ones((C, 3)),
        "L": zero3,
        "prev_pb": jnp.ones((C,)),
        "prev_p": zero3,
        "prev_ns": jnp.concatenate([jnp.zeros((C, 2)), jnp.ones((C, 1))], axis=1),
        "prev_w": jnp.zeros((C,)),
        "counter": jnp.zeros((), jnp.int32),
        **{
            f"fb{i}": (
                jnp.concatenate([fb_pre[:, i], jnp.zeros((C,))])
                if seeded else jnp.zeros((n_pix + C,))
            )
            for i in range(3)
        },
        "nrays": jnp.zeros((), jnp.float32),
        "iter": jnp.zeros((), jnp.int32),
    }
    if blocker:
        st.update({
            "buf_ro": jnp.zeros((C + 1, 3)),
            "buf_rd": jnp.zeros((C + 1, 3)),
            "buf_tp": jnp.zeros((C + 1, 3)),
            "buf_pixel": jnp.zeros((C + 1,), jnp.int32),
            "buf_excl": jnp.full((C + 1,), ops_intersect.NO_HIT, jnp.int32),
            "buf_sample": jnp.zeros((C + 1,), jnp.int32),
            "buf_depth": jnp.zeros((C + 1,), jnp.int32),
            "buf_count": jnp.zeros((), jnp.int32),
            "chain_counter": jnp.zeros((), jnp.int32),
            "spilled": jnp.zeros((), jnp.int32),
        })
    st = jax.lax.while_loop(cond, body, st)
    zero = jnp.zeros((), jnp.int32)
    stats = RegenStats(
        spilled=st["spilled"] if blocker else zero,
        chains=st["chain_counter"] if blocker else zero,
    )
    fb_out = jnp.stack(
        [st["fb0"][:n_pix], st["fb1"][:n_pix], st["fb2"][:n_pix]], axis=1
    )
    return fb_out, st["nrays"], st["iter"], stats

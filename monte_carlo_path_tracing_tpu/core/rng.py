"""Counter-based RNG key discipline.

The reference re-constructs a ``std::default_random_engine`` seeded from the
wall clock at every call site (quirk Q1; reference main.cpp:127-131,323-326,
Mylight.cpp:107-108, BRDF.cpp:38-39) — irreproducible and correlated within a
clock tick. This design replaces it with jax's counter-based
threefry: one base key per render, deterministically folded by
(sample id, pixel id, bounce, purpose) — in that order — giving every
(pixel, sample) path its own stream. The rendered image is therefore
invariant to ray-chunk size, wavefront lane count, launch splitting, and
device count (tests/test_render.py, test_regen.py pin this), and CPU-oracle
vs accelerator image comparison is exact-stream (SURVEY.md §7 Q1).

Mechanics: the renderers build a *batched key array* (one key per lane,
pixel id folded in) and pass it down; every helper here broadcasts over
batched keys, so samplers and integrators are agnostic to whether they get
one shared key (lane-indexed draws — used by the raw ``render_rays`` API
when the caller has no pixel ids, e.g. the distributed train step) or
per-lane keys (full stream discipline — both production renderers).

Purpose constants keep independent decision streams decorrelated without
splitting keys inside the hot loop (fold_in is a cheap hash, vmap-safe).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Purpose tags — one per independent random decision in the estimators.
P_LOBE = 0          # diffuse-vs-specular lobe choice (BRDF.cpp:38-41)
P_BSDF = 1          # BRDF lobe warp (xi1, xi2)            (BRDF.cpp:48-100)
P_LIGHT_SELECT = 2  # light class / triangle categorical   (Mylight.cpp:112-135, 435-438)
P_LIGHT_WARP = 3    # point-in-triangle / Arvo warp        (Mylight.cpp:141-149, 449-461)
P_RR = 4            # Russian roulette                     (main.cpp:321-329)
P_PIXEL_JITTER = 5  # sub-pixel jitter for anti-aliasing (new capability)


def base_key(seed: int) -> jax.Array:
    return jax.random.key(seed)


def fold_in(key: jax.Array, data) -> jax.Array:
    """``jax.random.fold_in`` broadcast over batched keys and/or [N] data.

    (scalar key, scalar data) -> scalar key; any [N] operand -> [N] keys.
    """
    kdim = jnp.ndim(key)
    ddim = jnp.ndim(data)
    if kdim == 0 and ddim == 0:
        return jax.random.fold_in(key, data)
    if kdim == 0:
        return jax.vmap(lambda d: jax.random.fold_in(key, d))(data)
    if ddim == 0:
        return jax.vmap(lambda k: jax.random.fold_in(k, data))(key)
    return jax.vmap(jax.random.fold_in)(key, data)


def lane_keys(key: jax.Array, lane_ids) -> jax.Array:
    """[N] per-lane stream keys: one fold of the lane (pixel/sample) id."""
    return fold_in(key, lane_ids)


def bounce_key(key: jax.Array, bounce, purpose: int) -> jax.Array:
    """Key(s) for one (bounce, purpose) decision. With a scalar key,
    per-lane decorrelation comes from the batch axis of the draw; with a
    batched key each lane owns an independent stream (and ``bounce`` may be
    a per-lane array, as in the regeneration renderer)."""
    return fold_in(fold_in(key, bounce), purpose)


def sample_key(key: jax.Array, sample_id) -> jax.Array:
    """Key for one spp chunk (sample index folded in)."""
    return fold_in(key, sample_id)


def uniform(key: jax.Array, shape, minval=0.0, maxval=1.0) -> jnp.ndarray:
    """Uniform draw; a batched [N] key draws ``shape[1:]`` per lane (so
    ``shape[0]`` must equal the key batch)."""
    if jnp.ndim(key) == 0:
        return jax.random.uniform(
            key, shape, minval=minval, maxval=maxval, dtype=jnp.float32
        )
    assert shape[0] == key.shape[0], (shape, key.shape)
    return jax.vmap(
        lambda k: jax.random.uniform(
            k, shape[1:], minval=minval, maxval=maxval, dtype=jnp.float32
        )
    )(key)


def pick_weighted(
    key: jax.Array,
    weights: jnp.ndarray,
    n_rows: int,
    weights_sum: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """[n_rows] categorical draws proportional to non-negative ``weights``
    ([L] shared or [n_rows, L] per-row) by inverse-CDF: ONE uniform per row
    plus a cumsum/compare, instead of the gumbel trick's [rows, L] bits +
    log + argmax (the gumbel path draws L uniforms per lane). This is the
    batched form of the
    reference's ``std::discrete_distribution`` (Mylight.cpp:112-135,
    435-438), which is also inverse-CDF.

    Zero-weight entries are never selected (up to float coincidences on
    CDF plateau boundaries, where the draw lands on the next positive
    entry); all-zero rows return the last index — callers flag those rows
    invalid via their own weights_sum guard. ``weights_sum`` (per-row total)
    avoids recomputing the reduction when the caller already has it; when a
    caller's tree-reduced total exceeds cumsum[-1] by rounding, a u near 1
    clamps to the last column (possibly a zero-weight entry) — a documented
    ~1e-7-per-draw fringe, accepted to keep the caller-supplied total (and
    the fused kernel's identical convention) bit-compatible."""
    u = uniform(key, (n_rows,))
    if weights.ndim == 1:
        cdf = jnp.cumsum(weights)                            # [L]
        total = cdf[-1] if weights_sum is None else weights_sum
        thresh = u * total                                   # [N]
        idx = jnp.sum((cdf[None, :] <= thresh[:, None]).astype(jnp.int32), axis=-1)
        return jnp.minimum(idx, weights.shape[0] - 1)
    cdf = jnp.cumsum(weights, axis=-1)                       # [N, L]
    total = cdf[:, -1] if weights_sum is None else weights_sum
    thresh = u * total
    idx = jnp.sum((cdf <= thresh[:, None]).astype(jnp.int32), axis=-1)
    return jnp.minimum(idx, weights.shape[-1] - 1)


def categorical(key: jax.Array, logits: jnp.ndarray, n_rows: int) -> jnp.ndarray:
    """[n_rows] categorical draws from ``logits`` ([L] shared, or [n_rows, L]
    per-row); a batched key uses one stream per row."""
    if jnp.ndim(key) == 0:
        if logits.ndim == 1:
            return jax.random.categorical(key, logits, shape=(n_rows,))
        return jax.random.categorical(key, logits, axis=-1)
    assert key.shape[0] == n_rows, (key.shape, n_rows)
    if logits.ndim == 1:
        return jax.vmap(lambda k: jax.random.categorical(k, logits))(key)
    return jax.vmap(jax.random.categorical)(key, logits)

"""Radiance representation and gamma tone mapping.

Radiance is an array with a trailing RGB axis [..., 3] — the batched form
of the reference's ``RadianceRGB`` triple (RadianceRGB.h:1-37). Operators
(+, *scalar, pairwise * with radiance or BRDF throughput) are plain jnp
arithmetic; only the non-trivial members are reimplemented here.
"""

from __future__ import annotations

import jax.numpy as jnp

#: Reference tone-map constants (main.cpp:583): maxRadiance=380, gamma=0.25.
DEFAULT_MAX_RADIANCE = 380.0
DEFAULT_GAMMA = 0.25


def radiance_sum(rad: jnp.ndarray) -> jnp.ndarray:
    """R+G+B — the light-importance scalar (reference RadianceRGB.cpp:70-73),
    used as the class/triangle selection weight in both light samplers."""
    return jnp.sum(rad, axis=-1)


def tone_map(
    rad: jnp.ndarray,
    max_radiance: float = DEFAULT_MAX_RADIANCE,
    gamma: float = DEFAULT_GAMMA,
) -> jnp.ndarray:
    """Gamma tone map to uint8: clamp(floor((R/maxR)^gamma * 255 + 0.5), 0, 255).

    Exact semantics of reference RadianceRGB.cpp:51-67 (including the
    floor(x+0.5) rounding) so golden-image comparisons are bit-faithful.
    """
    x = jnp.maximum(rad, 0.0) / max_radiance
    x = jnp.power(x, gamma)
    q = jnp.floor(x * 255.0 + 0.5)
    return jnp.clip(q, 0.0, 255.0).astype(jnp.uint8)


def parse_radiance(text: str) -> jnp.ndarray:
    """Parse an ``"r,g,b"`` radiance string (reference RadianceRGB.cpp:17-27)."""
    parts = [float(p) for p in text.split(",")]
    if len(parts) != 3:
        raise ValueError(f"radiance string must be 'r,g,b', got {text!r}")
    return jnp.asarray(parts, dtype=jnp.float32)

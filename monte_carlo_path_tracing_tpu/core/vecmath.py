"""Batched 3-vector math on arrays of shape [..., 3].

Batched replacement for the reference's scalar ``vec`` class
(reference vec.cpp: cross_product vec.cpp:67-70, determinant vec.cpp:84-87,
normalized vec.cpp:99-103) and the column-major ``matrix3d``
(matrix3d.cpp:8-22,29-58). There is no vector *class*: everything is a pure
function over jnp arrays whose trailing axis is the xyz component axis, so
every op vmaps/jits/shards trivially and XLA fuses the elementwise chains.

All functions are f32-friendly (the reference is f64 on CPU; on an accelerator
f64 is slow, so epsilons are chosen for f32 — see SURVEY.md §7 hard part 3).
"""

from __future__ import annotations

import jax.numpy as jnp

#: Reference uses eps=1e-8 in f64 (vec.h:7). In f32 that is below the
#: round-off of typical scene-scale (~10) coordinates; 1e-6 relative-ish
#: epsilon is the f32 analogue used for zero tests.
EPS = 1e-6


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing xyz axis. Shape [...,3]x[...,3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (reference vec.cpp:67-70)."""
    return jnp.cross(a, b)


def det3(a: jnp.ndarray, b: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Scalar triple product det[a b c] = a . (b x c) (reference vec.cpp:84-87)."""
    return dot(a, cross(b, c))


def norm(a: jnp.ndarray) -> jnp.ndarray:
    """Euclidean length of the trailing axis."""
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize: returns a / max(|a|, eps) (reference vec.cpp:99-103).

    Uses rsqrt (native VPU op) rather than division by sqrt.
    """
    sq = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * jnp.where(sq > eps, jnp.reciprocal(jnp.sqrt(jnp.maximum(sq, eps))), 0.0)


def is_zero(a: jnp.ndarray, eps: float = EPS) -> jnp.ndarray:
    """Per-element zero test with epsilon (reference vec.h:7 semantics)."""
    return jnp.abs(a) < eps


def reflect(wi: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror direction of wi about n: 2(wi.n)n - wi.

    Matches the reference's Phong R construction (BRDF.cpp:17-25) where both
    wi and the result point *away* from the surface.
    """
    return 2.0 * dot(wi, n)[..., None] * n - wi


def orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build tangent/bitangent (t, b) so that (t, b, n) is right-handed.

    Branch-free Duff et al. construction — jit/vmap safe (no data-dependent
    control flow), replacing the reference's ad-hoc basis in BRDF.cpp:56-63.
    """
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], axis=-1
    )
    bt = jnp.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bt


def from_local(w_local: jnp.ndarray, t: jnp.ndarray, b: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Map a local-frame direction to world space: x*t + y*b + z*n.

    The batched analogue of the reference's column-major basis matrix
    multiply (matrix3d.cpp:8-40): the basis is never materialised as a 3x3,
    the contraction is written out so XLA fuses it with neighbours.
    """
    return (
        w_local[..., 0:1] * t + w_local[..., 1:2] * b + w_local[..., 2:3] * n
    )


def to_local(w: jnp.ndarray, t: jnp.ndarray, b: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`from_local` for orthonormal frames (transpose, matrix3d.cpp:60-72)."""
    return jnp.stack([dot(w, t), dot(w, b), dot(w, n)], axis=-1)

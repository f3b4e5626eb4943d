"""Device timing: host clock around work that ends in
``jax.block_until_ready`` (JAX returns before the device finishes)."""

from __future__ import annotations

import time

import jax
import numpy as np


def median_seconds(fn, *args, n: int = 20) -> float:
    """Median wall seconds of ``fn(*args)`` over ``n`` calls, after one
    warm-up call (compilation) outside the clock."""
    jax.block_until_ready(fn(*args))
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs))

"""Matmul-form stable counting/radix sort for lane permutation keys.

A counting sort whose stable within-block rank is a strict-lower-
triangular MATMUL (one [B,B] x [nblk,B,K] einsum with exact small-integer
arithmetic) instead of a serial scan:

  - one-hot        oh[i, k]   = [key_i == k]                  (compare)
  - block hist     h[b, k]    = sum_i oh[b*B+i, k]            (reduce)
  - in-block rank  r[b, i, k] = sum_{j<i} oh[b*B+j, k]        (matmul)
  - position_i     = excl_cumsum_k(tot)[k_i]                  (tiny cumsum)
                   + excl_cumsum_b(h)[b_i, k_i] + r[b_i, i mod B, k_i]

Counts are <= B = 256 so bf16 one-hots with f32 accumulation are exact.
Multi-byte keys compose by LSD radix (stability makes passes compose).

It was built as a faster replacement for ``jnp.argsort`` in the regen
lane sort and measured slower than it; ``regen.sort_lanes`` uses
``jnp.argsort``. Nothing in the renderer calls this module. It stays as a
tested alternative, pinned equivalent to ``argsort(stable=True)`` by
tests/test_sort.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BLK = 256  # lanes per block; ranks fit bf16's 8-bit mantissa exactly


@functools.partial(jax.jit, static_argnames=("num_buckets",))
def counting_rank(key: jnp.ndarray, num_buckets: int) -> jnp.ndarray:
    """Stable rank of each lane under an ascending sort of ``key``
    ([C] int32 in [0, num_buckets)). rank[i] is the sorted position of lane
    i; equal keys keep their original order. C must be a multiple of 256.
    """
    C = key.shape[0]
    assert C % _BLK == 0, C
    nblk = C // _BLK
    K = num_buckets

    buckets = jax.lax.broadcasted_iota(jnp.int32, (1, K), 1)
    oh = (key[:, None] == buckets).astype(jnp.bfloat16)      # [C, K]
    oh3 = oh.reshape(nblk, _BLK, K)
    hist = oh3.astype(jnp.float32).sum(axis=1)               # [nblk, K]

    # Strict lower-triangular matmul = stable prefix count within the block.
    row = jax.lax.broadcasted_iota(jnp.int32, (_BLK, _BLK), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (_BLK, _BLK), 1)
    L = (col < row).astype(jnp.bfloat16)                     # [B, B]
    pref = jnp.einsum(
        "ij,bjk->bik", L, oh3, preferred_element_type=jnp.float32
    )                                                        # [nblk, B, K]
    # one-hot select of the lane's own column (exact: single nonzero term)
    r_in_blk = (pref * oh3.astype(jnp.float32)).sum(axis=-1).reshape(C)

    total = hist.sum(axis=0)                                 # [K]
    key_base = jnp.cumsum(total) - total                     # exclusive [K]
    blk_base = jnp.cumsum(hist, axis=0) - hist               # exclusive [nblk, K]

    blk_id = jax.lax.broadcasted_iota(jnp.int32, (C,), 0) // _BLK
    pos = key_base[key] + blk_base[blk_id, key] + r_in_blk
    return pos.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("key_bits", "radix_bits"))
def sort_perm(key: jnp.ndarray, key_bits: int, radix_bits: int = 8) -> jnp.ndarray:
    """Permutation ``order`` such that ``key[order]`` is ascending and the
    sort is stable, via LSD radix over ``radix_bits``-wide digits. ``key``
    is [C] non-negative int32 below 2**key_bits; C a multiple of 256.

    Equivalent to ``jnp.argsort(key, stable=True)`` — pinned by
    tests/test_sort.py — at a fraction of the bitonic network's cost.
    """
    C = key.shape[0]
    order = jax.lax.broadcasted_iota(jnp.int32, (C,), 0)
    k = key
    for shift in range(0, key_bits, radix_bits):
        digit = (k >> shift) & ((1 << radix_bits) - 1)
        pos = counting_rank(digit, 1 << radix_bits)
        inv = jnp.zeros((C,), jnp.int32).at[pos].set(
            jax.lax.broadcasted_iota(jnp.int32, (C,), 0)
        )
        order = order[inv]
        k = k[inv]
    return order

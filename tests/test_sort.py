"""ops/sort.py: the matmul-form counting/radix sort vs jnp.argsort(stable)."""

import numpy as np
import pytest

import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.ops.sort import counting_rank, sort_perm


@pytest.mark.parametrize("C,K", [(256, 4), (1024, 256), (4096, 16)])
def test_counting_rank_matches_stable_argsort(C, K):
    rng = np.random.default_rng(C + K)
    key = rng.integers(0, K, size=C).astype(np.int32)
    pos = np.asarray(counting_rank(jnp.asarray(key), K))
    # position of lane i under a stable ascending sort
    expect = np.empty(C, np.int64)
    expect[np.argsort(key, kind="stable")] = np.arange(C)
    np.testing.assert_array_equal(pos, expect)


def test_counting_rank_degenerate_single_bucket():
    C = 512
    key = np.zeros(C, np.int32)
    pos = np.asarray(counting_rank(jnp.asarray(key), 8))
    np.testing.assert_array_equal(pos, np.arange(C))


@pytest.mark.parametrize("bits", [8, 16, 24])
def test_sort_perm_matches_argsort(bits):
    C = 2048
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 1 << bits, size=C).astype(np.int32)
    order = np.asarray(sort_perm(jnp.asarray(key), bits))
    np.testing.assert_array_equal(order, np.argsort(key, kind="stable"))
    assert (np.diff(key[order]) >= 0).all()


def test_sort_perm_is_permutation_with_duplicates():
    C = 1024
    key = np.repeat(np.arange(16, dtype=np.int32), C // 16)
    np.random.default_rng(0).shuffle(key)
    order = np.asarray(sort_perm(jnp.asarray(key), 8))
    assert sorted(order.tolist()) == list(range(C))

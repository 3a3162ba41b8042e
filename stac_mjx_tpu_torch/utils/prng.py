"""Bit-exact numpy twin of ``jax.random.permutation(PRNGKey(seed), jnp.arange(n), independent=True)``.

The fit's m-phase samples its frames with that permutation (JAX
``pipeline.offset_optimization``), so the sampled frames are part of the
fit's result, and the GPU machine has no jax. This reproduces JAX's default
threefry2x32 generator with ``jax_threefry_partitionable`` on (the default
since jax 0.5):

- ``PRNGKey(seed)`` is the pair (seed >> 32, seed & 0xFFFFFFFF);
- ``split(key)`` hashes the counters (0, i) for i in 0, 1 under the key:
  new key i = (hash_hi[i], hash_lo[i]);
- ``random_bits(key, 32, (n,))`` hashes the counters (0, i) for i < n and
  returns hash_hi ^ hash_lo;
- the shuffle runs ceil(3 ln n / ln(2^32 - 1)) rounds of
  ``key, sub = split(key)`` followed by a stable sort of x by
  ``random_bits(sub)``;
- ``fold_in(key, data)`` hashes the counter pair (0, data) under the key:
  the new key is the pair of outputs (the sharded m-phase folds the shard
  index into ``PRNGKey(0)``).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under key."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _hash_iota(key, n: int):
    with np.errstate(over="ignore"):
        return threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    hi, lo = _hash_iota(key, 2)
    return (int(hi[0]), int(lo[0])), (int(hi[1]), int(lo[1]))


def random_bits32(key: tuple[int, int], n: int) -> np.ndarray:
    hi, lo = _hash_iota(key, n)
    return hi ^ lo


def key_from_seed(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as a pair of uint32."""
    return (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for data < 2^32."""
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return int(hi[0]), int(lo[0])


def permutation(n: int, seed: int = 0, key: tuple[int, int] | None = None) -> np.ndarray:
    """The indices jax.random.permutation(PRNGKey(seed), arange(n), independent=True)
    returns; with ``key``, the same under that key (``seed`` is then unused)."""
    if key is None:
        key = key_from_seed(seed)
    x = np.arange(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x

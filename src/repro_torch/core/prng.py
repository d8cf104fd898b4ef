"""Host replay of JAX's threefry2x32 PRNG chain on raw uint32[2] keys.

The AMTL engines draw every event's (task, staleness), every sketch seed and
every minibatch seed from one serial PRNG chain.  The reference package
draws them with `jax.random` under the default `threefry2x32`
implementation in its partitionable mode (`jax_threefry_partitionable`,
the default since jax 0.5).  This module replays exactly those draws, bit
for bit, on the host, so that the port's event stream equals the
reference's for the same key:

    split(key, n)       lane i = threefry(key, (0, i))
    fold_in(key, data)  threefry(key, (0, data))
    bits(key)           x0 ^ x1 of threefry(key, (0, 0))
    randint(key, 0, n)  JAX's two-word modulus over split(key, 2)
    uniform(key)        the 23 high bits of bits(key) as a mantissa in [1, 2), minus 1

and their shaped forms, which the MTL head's staleness and activation
mask draw (`randint_shaped`, `uniform_shaped`, `bernoulli`): element i of
a row-major shape takes the counter pair (0, i), as partitionable threefry
counts by element index.

A key is a numpy uint32 array of shape (2,), the layout of a raw
`jax.random.PRNGKey`.  The chain is sequential in the key, so there is
nothing to vectorize: the hash runs on Python ints, which are faster than
numpy scalars at this size.  The shaped draws hash all their counters at
once in numpy uint32 arithmetic, which wraps as the hash does.
"""
from __future__ import annotations

import numpy as np

_M = 0xFFFFFFFF


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """The Threefry-2x32 block hash (20 rounds) of one counter pair.

    Written out round by round: the rotations are (13, 15, 26, 6) and
    (17, 29, 16, 24) in turn, with a key injection after every four.
    """
    M = _M
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    x0 = (x0 + k0) & M
    x1 = (x1 + k1) & M
    # rounds 1-4, inject (k1, k2 + 1)
    x0 = (x0 + x1) & M; x1 = (((x1 << 13) | (x1 >> 19)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 15) | (x1 >> 17)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 26) | (x1 >> 6)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 6) | (x1 >> 26)) & M) ^ x0  # noqa: E702
    x0 = (x0 + k1) & M; x1 = (x1 + k2 + 1) & M  # noqa: E702
    # rounds 5-8, inject (k2, k0 + 2)
    x0 = (x0 + x1) & M; x1 = (((x1 << 17) | (x1 >> 15)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 29) | (x1 >> 3)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 16) | (x1 >> 16)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 24) | (x1 >> 8)) & M) ^ x0  # noqa: E702
    x0 = (x0 + k2) & M; x1 = (x1 + k0 + 2) & M  # noqa: E702
    # rounds 9-12, inject (k0, k1 + 3)
    x0 = (x0 + x1) & M; x1 = (((x1 << 13) | (x1 >> 19)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 15) | (x1 >> 17)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 26) | (x1 >> 6)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 6) | (x1 >> 26)) & M) ^ x0  # noqa: E702
    x0 = (x0 + k0) & M; x1 = (x1 + k1 + 3) & M  # noqa: E702
    # rounds 13-16, inject (k1, k2 + 4)
    x0 = (x0 + x1) & M; x1 = (((x1 << 17) | (x1 >> 15)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 29) | (x1 >> 3)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 16) | (x1 >> 16)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 24) | (x1 >> 8)) & M) ^ x0  # noqa: E702
    x0 = (x0 + k1) & M; x1 = (x1 + k2 + 4) & M  # noqa: E702
    # rounds 17-20, inject (k2, k0 + 5)
    x0 = (x0 + x1) & M; x1 = (((x1 << 13) | (x1 >> 19)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 15) | (x1 >> 17)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 26) | (x1 >> 6)) & M) ^ x0  # noqa: E702
    x0 = (x0 + x1) & M; x1 = (((x1 << 6) | (x1 >> 26)) & M) ^ x0  # noqa: E702
    x0 = (x0 + k2) & M; x1 = (x1 + k0 + 5) & M  # noqa: E702
    return x0, x1


def key_from_seed(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` as a raw uint32[2] key (32-bit seeds)."""
    s = int(seed) & _M
    return np.array([0, s], np.uint32)


def to_pair(key) -> tuple[int, int]:
    """A raw uint32[2] key as a pair of Python ints (the chain's form)."""
    k = np.asarray(key, np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a raw threefry key is uint32[2], got {k.shape}")
    return int(k[0]), int(k[1])


def to_key(pair: tuple[int, int]) -> np.ndarray:
    return np.array(pair, np.uint32)


# The chain works on (k0, k1) pairs of Python ints; the array functions
# below wrap these for callers that hold uint32[2] keys.

def split_pair(pair: tuple[int, int], num: int) -> list[tuple[int, int]]:
    return [threefry2x32(pair[0], pair[1], 0, i) for i in range(num)]


def fold_in_pair(pair: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(pair[0], pair[1], 0, int(data) & _M)


def bits_pair(pair: tuple[int, int]) -> int:
    x0, x1 = threefry2x32(pair[0], pair[1], 0, 0)
    return x0 ^ x1


def randint_pair(pair: tuple[int, int], minval: int, maxval: int) -> int:
    k_hi, k_lo = split_pair(pair, 2)
    hi, lo = bits_pair(k_hi), bits_pair(k_lo)
    span = 1 if maxval <= minval else (maxval - minval) & _M
    mult = (1 << 16) % span
    mult = (mult * mult & _M) % span
    off = (((hi % span) * mult & _M) + lo % span) & _M
    return minval + off % span


def uniform_pair(pair: tuple[int, int]) -> np.float32:
    b = (bits_pair(pair) >> 9) | 0x3F800000
    f = np.array([b], np.uint32).view(np.float32)[0] - np.float32(1.0)
    return max(np.float32(0.0), f)


def split(key, num: int = 2) -> list[np.ndarray]:
    """`jax.random.split(key, num)`, partitionable mode."""
    return [to_key(p) for p in split_pair(to_pair(key), num)]


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)` for a uint32 `data`."""
    return to_key(fold_in_pair(to_pair(key), data))


def bits(key) -> int:
    """`jax.random.bits(key, dtype=uint32)` (shape ()) as a Python int."""
    return bits_pair(to_pair(key))


def randint(key, minval: int, maxval: int) -> int:
    """`jax.random.randint(key, (), minval, maxval)` for int32 bounds."""
    return randint_pair(to_pair(key), minval, maxval)


def uniform(key) -> np.float32:
    """`jax.random.uniform(key)`: float32 in [0, 1)."""
    return uniform_pair(to_pair(key))


# --------------------------------------------------------- shaped draws ---

def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32_array(k0: int, k1: int, x0: np.ndarray,
                       x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`threefry2x32` of many counter pairs at once (uint32 arrays)."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rots[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def bits_shaped(key, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)`, partitionable mode: element
    i (row-major) is x0 ^ x1 of threefry(key, (0, i))."""
    k0, k1 = to_pair(key)
    n = int(np.prod(shape, dtype=np.int64))
    ctr = np.arange(n, dtype=np.uint32)
    x0, x1 = threefry2x32_array(k0, k1, np.zeros(n, np.uint32), ctr)
    return (x0 ^ x1).reshape(shape)


def randint_shaped(key, shape: tuple[int, ...], minval: int,
                   maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` for int32 bounds,
    as int32: two sets of bits from split(key, 2) folded by JAX's two-word
    modulus."""
    k_hi, k_lo = split(key, 2)
    hi, lo = bits_shaped(k_hi, shape), bits_shaped(k_lo, shape)
    span = np.uint32(1 if maxval <= minval else (maxval - minval) & _M)
    mult = np.uint32((1 << 16) % int(span))
    mult = np.uint32(int(mult) * int(mult) % int(span))
    off = (hi % span) * mult + lo % span
    return (np.int64(minval) + (off % span)).astype(np.int32)


def uniform_shaped(key, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    b = (bits_shaped(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), b.view(np.float32) - np.float32(1.0))


def bernoulli(key, p: float, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.bernoulli(key, p, shape)` for a Python float p: a
    float32 uniform below float32(p)."""
    return uniform_shaped(key, shape) < np.float32(p)

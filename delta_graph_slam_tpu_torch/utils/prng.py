"""The JAX package's random stream in plain PyTorch: threefry2x32 keys,
``split`` and float32 ``uniform``, bit for bit as JAX 0.9.0 computes
``jax.random.PRNGKey``, ``jax.random.split`` and ``jax.random.uniform``
with its default ``threefry2x32`` implementation and
``jax_threefry_partitionable = True`` (the default from JAX 0.5 on).

Threefry-2x32 is the counter-based hash of Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3" (SC'11), 20 rounds. A key is a pair of 32-bit
words; here a key is an int64 tensor whose last dimension holds the pair,
each word in [0, 2**32). Every 32-bit word is carried in int64 and masked
with ``& 0xFFFFFFFF`` after each add and shift (``torch.uint32`` supports
only part of the ops). Every function takes a batch of keys (leading
dimensions) and works on the keys' device.

With partitionable threefry, the counters of a draw of shape ``s`` are the
row-major flat indices of ``s`` as 64-bit integers, split into a high and a
low word; ``split(key, n)`` is the hash of counters (0, i) for i < n, both
output words forming the new key; ``uniform`` xors the two output words and
puts the top 23 bits into the mantissa of a float in [1, 2), minus 1.
"""

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counters (x1, x2) under key (k1, k2); every
    argument an int64 tensor of 32-bit words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**63: the (2,) words
    (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed {seed} outside [0, 2**63)")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64, device=device)


def _hash(key, shape):
    """Both output words of the hash of ``shape``'s flat counters under
    every key of ``key`` (..., 2): two (..., *shape) tensors."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    return threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                        idx >> 32, idx & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def uniform(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): keys
    (..., 2) -> (..., *shape)."""
    b1, b2 = _hash(key, tuple(shape))
    mantissa = ((b1 ^ b2) >> 9) | 0x3F800000      # a float in [1, 2)
    return mantissa.to(torch.int32).view(torch.float32) - 1.0


class KeyChain:
    """A stateful key as the reference's stages hold one: every draw splits
    it in two, keeps the first half and hands out the second
    (``key, sub = jax.random.split(key)``)."""

    def __init__(self, seed: int, device="cpu"):
        self.key = prng_key(seed, device)

    def next(self) -> torch.Tensor:
        self.key, sub = split(self.key).unbind(0)
        return sub

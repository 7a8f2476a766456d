"""JAX's default PRNG (Threefry-2x32) in plain PyTorch.

The port's own copy of what ``gelly_tpu``'s sampled triangle estimator
draws through ``jax.random``, bit for bit, with ``jax_threefry_partitionable``
on (JAX's default) and x64 on (``gelly_tpu`` turns it on):

- :func:`threefry2x32`, the hash;
- :func:`prng_key` (``jax.random.PRNGKey``), :func:`split` (the fold-like
  split: counters ``(0, iota)``);
- :func:`random_bits` at 32 bits (``bits1 ^ bits2``) and 64 bits
  (``bits1 << 32 | bits2``);
- :func:`uniform` in ``float64`` and :func:`randint` in ``int32``
  (two 32-bit draws from a split key, reduced into the span with JAX's
  ``uint32`` wrap-around).

Unsigned 32-bit values live in ``int64`` tensors (``torch`` has no full
``uint32`` arithmetic); every result is masked back into ``[0, 2^32)``.
A key is an ``int64`` tensor of shape ``[..., 2]``. Every function is
elementwise over the leading axes, so ``S`` independent keys advance in
one call (JAX's ``vmap``).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the
    key ``(k1, k2)`` (20 rounds, JAX's rotations and key schedule);
    broadcasts its arguments."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` under x64: the seed's two 32-bit
    halves, high first (``PRNGKey(0xDEADBEEF)`` is ``[0, 3735928559]``)."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``[..., n, 2]``, key ``i`` the hash of
    the counter pair ``(0, i)``."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int = 32) -> torch.Tensor:
    """One draw of ``jax.random.bits(key, dtype=uint{bit_width})`` per key
    (shape ``[...]``): the hash of the counter pair ``(0, 0)``, its halves
    XORed at 32 bits; at 64 bits ``(hi << 32 | lo)`` as two ``int64``
    halves ``(hi, lo)``, since the value may not fit a signed ``int64``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError(f"random_bits takes 32 or 64 bits, got {bit_width}")


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` under x64: one ``float64`` in
    ``[0, 1)`` per key, the top 52 of 64 random bits as the mantissa."""
    hi, lo = random_bits(key, 64)
    mant = (hi << 20) | (lo >> 12)
    return mant.to(torch.float64) * 2.0 ** -52


def randint(key: torch.Tensor, maxval: torch.Tensor) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, maxval, int32)`` per key, for
    ``int32`` ``maxval >= 1``: 32 higher and 32 lower bits from the key's
    two halves, reduced into the span as JAX reduces them (its
    ``2^32 mod span`` multiplier wraps in ``uint32``)."""
    higher, lower = random_bits(split(key, 2), 32).unbind(-1)
    span = maxval.to(torch.int64)
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK32) % span
    off = (((higher % span) * mult) & MASK32) + lower % span
    off = (off & MASK32) % span
    return off.to(torch.int32)

"""The piece of ``jax.random`` the dual ascent solvers draw from, bit-equal to
JAX 0.9.0's defaults (``jax_default_prng_impl="threefry2x32"``,
``jax_threefry_partitionable=True``): ``jax.random.PRNGKey``, ``split``
and ``uniform`` for float32 and float64.

Mirrors ``jax/_src/prng.py`` (``threefry_seed``, ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py::_uniform``.  A key is a pair of uint32 values held as
Python ints ``(k1, k2)`` (the JAX key's two words): the key chain is
independent of the data, so it runs on the host.  :func:`uniform` draws an
array on any device, vectorised over its shape, in int64 tensors masked to
32 bits (torch has no uint32 arithmetic); :func:`uniform_scalar` draws one
value on the host.  H-DCA (``csrc/dca_sweep.cu``) carries a device copy of
:func:`threefry2x32`.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the 64-bit seed's high and low words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & MASK)


def _rotl(v, r):
    """Rotate the 32-bit word ``v`` (an int or an int64 tensor) left."""
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under ``key``: Python ints, or int64 tensors holding uint32 values."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def split(key):
    """``key, sub = jax.random.split(key)``: the hash of the counters
    ``(0, 0)`` and ``(0, 1)``."""
    a = threefry2x32(key, 0, 0)
    b = threefry2x32(key, 0, 1)
    return a, b


def _float_bits(b1, b2, dtype):
    """The mantissa of ``uniform``'s float from the two hash words:
    float32 keeps the top 23 bits of ``b1 ^ b2``, float64 the top 52 of
    ``b1 << 32 | b2``."""
    if dtype == torch.float32:
        return (b1 ^ b2) >> 9, 2.0 ** -23
    if dtype == torch.float64:
        return (b1 << 20) | (b2 >> 12), 2.0 ** -52
    raise TypeError(f"uniform draws float32 or float64, not {dtype}")


def uniform_scalar(key, dtype) -> float:
    """``jax.random.uniform(key, (), dtype)`` as a Python float (exactly
    the value of that dtype)."""
    b1, b2 = threefry2x32(key, 0, 0)
    mant, scale = _float_bits(b1, b2, dtype)
    return mant * scale


def uniform_at_zero(keys, dtype):
    """``jax.random.uniform(key, (), dtype)`` for many keys at once:
    ``keys`` is a pair of int64 tensors (the keys' two words)."""
    zero = torch.zeros_like(keys[0])
    b1, b2 = threefry2x32(keys, zero, zero)
    mant, scale = _float_bits(b1, b2, dtype)
    return mant.to(dtype) * scale


def uniform(key, shape, dtype, device="cpu", offset=0):
    """``jax.random.uniform(key, shape, dtype)`` on ``device``: element
    ``i`` (row-major) hashes the counter ``(0, i)``.  ``offset`` draws
    elements ``offset + i`` instead: the slice ``[offset:]`` of a longer
    draw of the same key."""
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    if offset + size >= 2 ** 32:
        raise ValueError("uniform: more than 2**32 draws")
    count = torch.arange(offset, offset + size, dtype=torch.int64,
                         device=device)
    b1, b2 = threefry2x32(key, torch.zeros_like(count), count)
    mant, scale = _float_bits(b1, b2, dtype)
    # the mantissa is an exact integer of the dtype; the product is the
    # bitcast float minus one, as JAX forms it
    return (mant.to(dtype) * scale).reshape(shape)


"""Counter-based uniform draws equal bit for bit to ``jax.random.uniform``.

The sampling strategies of the reference draw their masks with
``jax.random.uniform(jax.random.PRNGKey(seed), (n,))`` (lightgbm_tpu/models/
sample_strategy.py:127, :200-202), so the port's trees match the reference's
only when its masks do.  This module computes the same numbers with torch
integer ops on any device:

- the key: ``PRNGKey(seed)`` with JAX's 64-bit mode off (its default) keeps
  the seed's low 32 bits as the key words ``(0, seed & 0xFFFFFFFF)``;
- the bits of element i: the Threefry-2x32 hash (20 rounds) of the counter
  pair ``(i >> 32, i & 0xFFFFFFFF)`` under that key, its two output words
  xor-ed (JAX's partitionable mode, its default, in which element i does not
  depend on the length drawn);
- the float: the top 23 bits under the exponent of 1.0, ``((bits >> 9) |
  0x3F800000)`` read as a float32, minus 1.0: a value in [0, 1);
- a draw of shape (N, K) is the flat draw of N * K elements in row-major
  order;
- ``split(key, num)``: new key i is the two Threefry words of counter i,
  ``jax.random.split`` under the partitionable Threefry (its
  ``_threefry_split_foldlike``);
- ``fold_in(key, data)``: the two Threefry words of the counter ``(0, data
  & 0xFFFFFFFF)``, ``jax.random.fold_in`` (its ``threefry_seed`` of the
  data, hashed under the key);
- ``randint(key, shape, minval, maxval)``: ``jax.random.randint`` at its
  default int32: the key split in two, a 32-bit draw under each, and the
  offset ``(hi % span * m + lo % span) % span`` in uint32 arithmetic, where
  ``m = (2**16 % span)**2 % span`` (``jax/_src/random.py`` ``_randint``).

Since element i of a draw does not depend on the shape drawn, element (r,
f) of an (R, F) draw is element r * F + f of any draw with F columns:
``uniform_rows`` and ``randint_rows`` draw only the rows a caller names.

A key is two Python ints, or two 0-d int64 tensors: the fused iteration
reads its keys from device buffers, so that a captured CUDA graph draws
each iteration's numbers and not those of the iteration it was captured in.

torch's uint32 covers few operations, so the words are int64 tensors held
in [0, 2**32) by masking after every add and shift.
"""
from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def prng_key(seed: int):
    """The two 32-bit words of ``jax.random.PRNGKey(seed)``."""
    return 0, int(seed) & _MASK32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under ``key``: two int64
    tensors of 32-bit words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def split(key, num: int = 2):
    """``num`` new keys, ``jax.random.split(key, num)``.  A key of two
    Python ints gives keys of Python ints; a key of two 0-d int64 tensors
    (a device buffer the caller fills before each replay of a captured
    iteration) gives keys of 0-d tensors on their device, with no host
    read."""
    if isinstance(key[0], torch.Tensor):
        i = torch.arange(num, dtype=torch.int64, device=key[0].device)
        b0, b1 = threefry2x32(key, i >> 32, i & _MASK32)
        return [(b0[j], b1[j]) for j in range(num)]
    i = torch.arange(num, dtype=torch.int64)
    b0, b1 = threefry2x32(key, i >> 32, i & _MASK32)
    return [(int(a), int(b)) for a, b in zip(b0.tolist(), b1.tolist())]


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a key of two Python ints from
    Python ints; of two 0-d int64 tensors where the key or ``data`` is a
    tensor (a round counter kept on the device)."""
    if isinstance(data, torch.Tensor):
        x1 = data.to(torch.int64) & _MASK32
        return threefry2x32(key, torch.zeros_like(x1), x1)
    if isinstance(key[0], torch.Tensor):
        # a fill, not a copy from the host: it may run inside a capture
        x1 = torch.full((), int(data) & _MASK32, dtype=torch.int64,
                        device=key[0].device)
        return threefry2x32(key, torch.zeros_like(x1), x1)
    x1 = torch.tensor(int(data) & _MASK32, dtype=torch.int64)
    b0, b1 = threefry2x32(key, torch.zeros_like(x1), x1)
    return int(b0), int(b1)


def bits_at(key, idx: torch.Tensor) -> torch.Tensor:
    """int64 32-bit words of the elements at flat positions ``idx`` (int64)
    of a ``jax.random.bits(key, shape, uint32)`` draw."""
    b0, b1 = threefry2x32(key, idx >> 32, idx & _MASK32)
    return b0 ^ b1


def random_bits(key, n: int, device=None) -> torch.Tensor:
    """(n,) int64 32-bit words, ``jax.random.bits(key, (n,), uint32)``."""
    return bits_at(key, torch.arange(n, dtype=torch.int64, device=device))


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _flat_rows(rows: torch.Tensor, cols: int) -> torch.Tensor:
    """(R, cols) flat positions of rows ``rows`` of an (.., cols) draw."""
    c = torch.arange(cols, dtype=torch.int64, device=rows.device)
    return rows.to(torch.int64)[:, None] * cols + c[None, :]


def uniform_rows(key, rows: torch.Tensor, cols: int) -> torch.Tensor:
    """(R, cols) float32: rows ``rows`` of ``jax.random.uniform(key, (R',
    cols))`` for any R' past the largest row."""
    return _to_unit_float(bits_at(key, _flat_rows(rows, cols)))


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _randint_words(key, idx: torch.Tensor, minval: int, maxval: int):
    """``_randint`` at the flat positions ``idx``, int32 values as int64."""
    lo_v = min(max(int(minval), _I32_MIN), _I32_MAX)
    hi_v = min(max(int(maxval), _I32_MIN), _I32_MAX)
    span = (hi_v - lo_v) & _MASK32
    if hi_v <= lo_v:
        span = 1
    if int(maxval) > _I32_MAX and int(maxval) > int(minval):
        span = (span + 1) & _MASK32
    k1, k2 = split(key)
    higher, lower = bits_at(k1, idx), bits_at(k2, idx)
    if span == 0:
        # XLA's unsigned remainder by zero keeps the dividend, and the
        # multiplier is then 0
        off = lower
    else:
        mult = ((2 ** 16 % span) ** 2 & _MASK32) % span
        off = ((higher % span) * mult + lower % span) & _MASK32
        off = off % span
    v = (lo_v + off) & _MASK32
    return torch.where(v > _I32_MAX, v - 2 ** 32, v)


def randint(key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int64 holding the int32 values of ``jax.random.randint(key, shape,
    minval, maxval)`` (``shape`` an int or a tuple)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return _randint_words(key, idx, minval, maxval).reshape(shape)


def randint_rows(key, rows: torch.Tensor, cols: int, minval: int,
                 maxval: int) -> torch.Tensor:
    """(R, cols) int64: rows ``rows`` of ``jax.random.randint(key, (R',
    cols), minval, maxval)``."""
    return _randint_words(key, _flat_rows(rows, cols), minval, maxval)


def uniform(key, shape, device=None) -> torch.Tensor:
    """float32 in [0, 1) of ``shape`` (an int n or a tuple),
    ``jax.random.uniform(key, shape)``."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    bits = random_bits(key, math.prod(shape), device)
    return _to_unit_float(bits).reshape(shape)

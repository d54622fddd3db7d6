"""Threefry-2x32 as elementwise torch ops: the port's ``jax.random``.

Port of ``balatro_gym_tpu/ops/kernel_rng.py``. Torch has no full uint32
arithmetic, so every 32-bit word is held in an int64 tensor and masked back
to 32 bits after each add and shift. A key is a pair of such tensors
(``k1`` = hi word, ``k2`` = lo word) of any one shape, so a batch of envs
holds its keys as two ``[B]`` tensors (or one ``[B, 2]`` tensor split by
the caller).

The semantics are those of ``jax.random`` with partitionable Threefry (the
default of the pinned jax): the 20-round hash, ``seed_key``, ``fold_in``,
``split``, 32-bit draws (``bits1 ^ bits2`` of the counter pair) and, for the
x64 engine, 64-bit draws (``bits1 << 32 | bits2``), ``uniform`` by mantissa
fill, and ``randint`` by the double-width modulus. Every function is held bit
for bit against ``jax.random`` by tests/test_torch_rng.py. The fused rollout
kernel's sampled mode (csrc/fused_rollout.cu) carries the same hash as a
CUDA ``__device__`` function.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT1 = (13, 15, 26, 6)
_ROT2 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _u32(x):
    """``x`` (python int or integer tensor) as 32-bit words; python ints
    stay python ints, so no host-to-device copy is made."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash, 20 rounds. The key words are int64 tensors
    of 32-bit words; the counter words are such tensors or python ints. All
    broadcast together; returns (y1, y2)."""
    k1, k2 = _u32(k1), _u32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (_u32(x1) + ks[0]) & _M32
    x1 = (_u32(x2) + ks[1]) & _M32
    rounds = (_ROT1, _ROT2, _ROT1, _ROT2, _ROT1)
    if not (torch.is_tensor(x0) or torch.is_tensor(x1)):        # python ints
        for i, rots in enumerate(rounds):
            for r in rots:
                x0 = (x0 + x1) & _M32
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]) & _M32
            x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
        return x0, x1
    # tensors: the same words, updated in place on two full-shape copies
    dev = (x0 if torch.is_tensor(x0) else x1).device
    x0, x1 = (t.clone() for t in torch.broadcast_tensors(
        *(t if torch.is_tensor(t) else torch.tensor(t, dtype=torch.int64, device=dev)
          for t in (x0, x1))))
    for i, rots in enumerate(rounds):
        for r in rots:
            x0.add_(x1).bitwise_and_(_M32)
            hi = x1 >> (32 - r)
            x1.bitwise_left_shift_(r).bitwise_or_(hi).bitwise_and_(_M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def seed_key(seed, device=None):
    """(k1, k2) from a 32-bit integer seed: hi word 0, lo word the seed's
    32 bits (``jax.random.key(seed)``)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.zeros_like(s), s & _M32


def fold_in(k1, k2, data):
    """``jax.random.fold_in``: threefry(key, (0, data))."""
    return threefry2x32(k1, k2, 0, data)


def split2(k1, k2):
    """``jax.random.split(key)`` -> ((a1, a2), (b1, b2))."""
    return split_child(k1, k2, 0), split_child(k1, k2, 1)


def split_child(k1, k2, i):
    """Child ``i`` of ``jax.random.split(key, n)`` for any n < 2**32:
    threefry(key, (0, i))."""
    return threefry2x32(k1, k2, 0, i)


def split_keys(key, n: int):
    """``jax.random.split(key, n)`` of one key given as its two 32-bit words
    (hi, lo): the ``n`` children as pairs of python ints. They are computed
    on the host, so a kernel argument or a draw made from them copies
    nothing from the card."""
    k1, k2 = (torch.tensor(_u32(w), dtype=torch.int64) for w in key)
    c1, c2 = split_child(k1, k2, torch.arange(n))
    return list(zip(c1.tolist(), c2.tolist()))


def random_bits32(k1, k2, i=0):
    """Element ``i`` of ``jax.random.bits(key, shape, uint32)`` in row-major
    order (arrays under 2**32 elements): y1 ^ y2 of threefry(key, (0, i))."""
    y1, y2 = threefry2x32(k1, k2, 0, i)
    return y1 ^ y2


def random_bits64(k1, k2, i=0):
    """Element ``i`` of a 64-bit draw (``jax.random.bits(key, shape,
    uint64)``), as (hi, lo) 32-bit words: y1 and y2 of threefry(key, (0, i))."""
    return threefry2x32(k1, k2, 0, i)


def _span(minval, maxval, np_dtype):
    """(maxval - minval) rounded as the reference does, in ``np_dtype``."""
    return float(np_dtype(maxval) - np_dtype(minval))


def uniform_f32(bits, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32 from 32 random bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return (f * _span(minval, maxval, np.float32) + minval).clamp(min=minval)


def _mod(words, span, bits):
    """Unsigned ``x % span`` of a 32-bit word or a (hi, lo) 64-bit pair."""
    if bits == 32:
        return words % span
    hi, lo = words
    return ((hi % span) * ((1 << 32) % span) + lo % span) % span


def randint(k1, k2, minval, maxval, i=0, bits=32):
    """``jax.random.randint(key, shape, minval, maxval)`` element ``i``, for
    a 32-bit (int32) or 64-bit (int64, the x64 default) result dtype.
    Bounds may be tensors broadcast against the key; the span must be
    below 2**31. Returns int64."""
    (a1, a2), (b1, b2) = split2(k1, k2)
    draw = random_bits32 if bits == 32 else random_bits64
    higher, lower = draw(a1, a2, i), draw(b1, b2, i)
    span = maxval - minval
    span = span.clamp(min=1) if torch.is_tensor(span) else max(span, 1)
    mult = (1 << (bits // 2)) % span
    wrap = _M32 if bits == 32 else -1                   # uint32 products wrap
    mult = ((mult * mult) & wrap) % span
    off = ((_mod(higher, span, bits) * mult & wrap)
           + _mod(lower, span, bits)) & wrap
    return minval + off % span


def permutation(k1, k2, n: int):
    """``jax.random.permutation(key, n)`` for each key: ``[..., n]`` int64.

    jax shuffles by sorting: each of ``ceil(3 ln n / ln(2**32 - 1))`` rounds
    (one round for n <= 1625) splits ``key, subkey = split(key)``, draws
    ``bits(subkey, (n,))`` and applies a stable sort by those words, so tied
    words keep index order. The words are unsigned; held in int64 they sort
    in that order."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    idx = torch.arange(n, device=k1.device)
    x = idx.expand(*k1.shape, n)
    for _ in range(rounds):
        (k1, k2), (s1, s2) = split2(k1, k2)
        words = random_bits32(s1[..., None], s2[..., None], idx)
        order = torch.sort(words, dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x

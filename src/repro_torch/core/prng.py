"""The reference's sampling key chain in PyTorch, bit for bit.

The reference draws with ``jax.random`` on raw threefry keys: a key is a
pair of uint32 words, ``fold_in`` hashes a 32-bit index into it, and
``categorical`` is the Gumbel-max trick over ``uniform`` floats made from
the key's bits.  This module computes the same bits on either device, with
``jax_threefry_partitionable`` on (the default of the installed JAX): a draw
of shape ``S`` hashes the flat position ``i`` of each element as the
counter pair ``(i >> 32, i & 0xffffffff)`` and keeps ``bits1 ^ bits2``.

Words are held in int64 tensors, each value in ``[0, 2**32)``, because
PyTorch has few uint32 kernels: every sum is masked back to 32 bits and
right shifts of non-negative int64 are logical.  A key is an int64 tensor
whose last axis holds the two words; any leading axes batch keys.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# Threefry-2x32 with 20 rounds (Salmon et al., Random123): rotation
# constants of the two alternating groups of four rounds, and the key
# schedule's parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32: 23 mantissa bits, the exponent bits of 1.0, the smallest normal
_NMANT = 23
_ONE_BITS = 0x3F800000
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 hash of counter words ``(x1, x2)`` under key words
    ``(k1, k2)``, all int64 holding uint32 values and broadcast together."""
    k1, k2 = torch.as_tensor(k1), torch.as_tensor(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a raw key: ``[seed >> 32, seed &
    0xffffffff]``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK32], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the 32-bit index ``data``
    (an int or an integer tensor broadcast against the key's leading axes)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[num, 2]`` keys, key ``i`` the threefry hash
    of the counter pair ``(i >> 32, i & 0xffffffff)`` under ``key`` (both
    output words kept, not xor-ed as a draw's are)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], counts >> 32, counts & MASK32)
    return torch.stack([o1, o2], dim=-1)


def row_keys(key: torch.Tensor, seeds: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """[B, 2] per-row draw keys ``fold_in(fold_in(key, seeds[b]), iters[b])``:
    a request's stream depends only on its own seed and lifetime iteration."""
    return fold_in(fold_in(key, seeds), iters)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 values), for each key of
    ``key [..., 2]``: the result is ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    lead = key.shape[:-1]
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    k1 = key[..., 0].reshape(lead + (1,))
    k2 = key[..., 1].reshape(lead + (1,))
    b1, b2 = threefry2x32(k1, k2, counts >> 32, counts & MASK32)
    return (b1 ^ b2).reshape(lead + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform`` in ``[minval, maxval)``: the top 23 bits
    as the mantissa of a float in ``[1, 2)``, shifted and scaled, and never
    below ``minval``.  The scale and shift ``floats * (hi - lo) + lo`` round
    once, as XLA's fused multiply-add does: the f32 operands' exact result
    fits a float64 whenever ``lo`` is a multiple of 2**-47 (1e-3 is), and
    otherwise the float64 rounding cannot move the float32 one (``lo`` far
    below an ulp of ``floats``, as Gumbel's ``tiny``)."""
    bits = random_bits(key, shape)
    floats = ((bits >> (32 - _NMANT)) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (floats.double() * (hi - lo).double() + lo.double()).float())


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)``.  Both logs run in float64 and the result is rounded once,
    so the noise is the correctly rounded Gumbel of ``u`` (within half an
    ulp) on every device, whatever float32 ``log`` the build dispatches to
    or however it splits the tensor across threads."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0)
    return (-torch.log(-torch.log(u.double()))).float()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per leading
    row: ``key [B, 2]`` and ``logits [B, ..., V]`` draw ``argmax(logits +
    gumbel)`` with row ``b``'s noise of shape ``logits.shape[1:]``."""
    noise = gumbel(key, logits.shape[1:])
    return torch.argmax(noise + logits, dim=-1)

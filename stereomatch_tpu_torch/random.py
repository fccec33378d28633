"""Threefry-2x32 counter-based RNG, bit-exact with ``jax.random``.

The JAX package draws every random number on the main path from
``jax.random`` (candidate sampling in ``ops/mst.py``, the per-view key
split in ``models/sgbm_mst.py``, the per-frame key in ``serving.py``).
Reproducing that stream exactly makes every comparison between the two
packages like-for-like: the same key yields the same candidate planes.

A key is an int64 tensor of shape (..., 2) holding two uint32 words (the
JAX raw key layout, ``uint32[2]``). All arithmetic runs on int64 tensors
masked to 32 bits, on whatever device the key lives on. The semantics
follow jax 0.9 with ``jax_threefry_partitionable=True`` (its default):

- ``PRNGKey(s)`` = ``[0, s & 0xFFFFFFFF]`` for an int32 seed;
- ``split(k, n)[i]`` = threefry(k, (0, i));
- ``fold_in(k, d)`` = threefry(k, (0, d));
- random bits at flat index i = x0 ^ x1 of threefry(k, (i >> 32, i & M));
- ``uniform`` puts 23 random mantissa bits into [1, 2), subtracts 1 and
  rescales to [minval, maxval).
"""

from __future__ import annotations

import torch

from .utils.timing import span

__all__ = ["PRNGKey", "split", "fold_in", "uniform", "threefry2x32"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32
    values. k0/k1 are 0-dim (or broadcastable) tensors; returns (y0, y1)
    shaped like x0."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device: torch.device | str = "cuda") -> torch.Tensor:
    """Raw key for an int32 seed, as ``jax.random.PRNGKey`` builds it."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32 (jax's default seed type)")
    # device fills: a host-to-device copy of the seed (as `key[1] = seed`
    # makes on the card) would sync the stream
    with span("sm.rng"):
        key = torch.zeros(2, dtype=torch.int64, device=device)
        key[1:].fill_(seed & _M32)
    return key


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) subkeys; index or unpack the first axis."""
    with span("sm.rng"):
        lo = torch.arange(num, dtype=torch.int64, device=key.device)
        y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
        return torch.stack([y0, y1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """Key derived from `key` and a 32-bit Python integer."""
    # a device fill: a host-to-device copy of `data` would sync the stream
    with span("sm.rng"):
        d = torch.full((), int(data) & _M32, dtype=torch.int64, device=key.device)
        y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
        return torch.stack([y0, y1])


def _random_bits32(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(shape)


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add. XLA fuses
    jax.random.uniform's scale-and-shift into an FMA. a * b is exact in
    float64; the float64 sum r is off by the TwoSum error e, which only
    matters when r falls exactly halfway between two float32 values."""
    p = a.double() * b.double()
    cd = c.double().expand_as(p)
    r = p + cd
    bv = r - p
    e = (p - (r - bv)) + (cd - bv)
    r32 = r.float()
    lo32 = torch.where(r32.double() > r, torch.nextafter(r32, r32.new_full((), -float("inf"))), r32)
    hi32 = torch.nextafter(lo32, lo32.new_full((), float("inf")))
    tie = (lo32.double() + hi32.double()) * 0.5 == r
    return torch.where(tie & (e > 0), hi32, torch.where(tie & (e < 0), lo32, r32))


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """float32 uniform draws in [minval, maxval), bit-exact with
    ``jax.random.uniform(key, shape, minval=..., maxval=...)``."""
    shape = tuple(int(s) for s in shape)
    with span("sm.rng"):
        bits = _random_bits32(key, shape)
        fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
        floats = fbits.view(torch.float32) - 1.0
        lo = torch.full((), minval, dtype=torch.float32, device=key.device)
        hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
        return torch.maximum(lo, _fma_f32(floats, hi - lo, lo))

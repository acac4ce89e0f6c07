"""The port's copy of what the env runner needs from ``jax.random``: the
threefry2x32 key, its split, its random bits, the uniform float trick and
the Gumbel noise, as JAX computes them with ``jax_threefry_partitionable``
on (its default since jax 0.5; jax/_src/prng.py ``threefry_seed``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``;
jax/_src/random.py ``_uniform``, ``_gumbel`` with ``mode="low"``).

A key is the two uint32 words of a JAX key, held as a torch.int64 tensor
of shape [2] (values in [0, 2**32)), so that every step below is a plain
int64 torch op masked to 32 bits and runs on any device. The keys, the bits
and the uniforms are integer work and equal JAX's bit for bit; the Gumbel
noise goes through two float32 logs, within a few ulps of XLA's.

This module is the plain version of K11 (rllib_kernels.sample_actions),
which does the split, the draw and the log-probability in one launch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: the third key word's constant (Threefish's C240)
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal number: the uniform's lower end in _gumbel
F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash, 20 rounds, of the counter pairs (x1, x2)
    under the key (k1, k2): int64 tensors (or ints) holding uint32 values,
    broadcast together. jax/_src/prng.py ``_threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (``threefry_seed``) for a seed in [0,
    2**31), as JAX takes it with 64-bit types off: [0, seed]."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"PRNGKey: seed {seed} outside [0, 2**31)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _counters(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the flat index i < n as (i >> 32, i & mask)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] keys, key i the hash of the
    counter pair (0, i) (``_threefry_split_foldlike``)."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element, [*shape] int64 in [0, 2**32): the hash of
    each element's flat index, its two words xor-ed
    (``_threefry_random_bits_partitionable``)."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape)), key.device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


#: at most this many elements, a CPU key's split and bits are hashed on
#: Python integers (the same arithmetic; tens of microseconds where a
#: hash of int64 tensor ops costs ~0.7 ms in op dispatch)
SCALAR_LANES = 64


def split_and_bits(key: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """``key, sub = split(key)`` then ``random_bits(sub, shape)``: returns
    (the next key, the bits), as the env runner consumes its key each
    step."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    if key.device.type != "cpu" or n > SCALAR_LANES:
        keys = split(key)
        return keys[0].contiguous(), random_bits(keys[1], shape)
    k1, k2 = (int(w) for w in key.tolist())
    nxt = threefry_2x32(k1, k2, 0, 0)
    s1, s2 = threefry_2x32(k1, k2, 0, 1)
    bits = []
    for i in range(n):
        b1, b2 = threefry_2x32(s1, s2, i >> 32, i & MASK32)
        bits.append(b1 ^ b2)
    return (torch.tensor(nxt, dtype=torch.int64),
            torch.tensor(bits, dtype=torch.int64).reshape(shape))


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as a float32 mantissa of [1, 2), less 1: [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_of_bits(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0
                    ) -> torch.Tensor:
    """``_uniform``'s floats from 32 random bits: the unit float scaled by
    maxval - minval (in float32), minval added, the result kept at or
    above minval."""
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, bits_to_unit_float(bits) * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0
            ) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (``_uniform``), bit for bit where
    maxval - minval is 1 in float32, as for the Gumbel noise's [tiny, 1)
    (for other ranges XLA's CPU contracts the scale and the shift into one
    FMA, which two torch ops do not repeat)."""
    return uniform_of_bits(random_bits(key, shape), minval, maxval)


def gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """``_gumbel`` with mode "low" from 32 random bits: -log(-log(u)), u
    uniform in [tiny, 1)."""
    u = uniform_of_bits(bits, F32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 with mode "low"."""
    return gumbel_of_bits(random_bits(key, shape))


def categorical_of_bits(bits: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The argmax of logits + Gumbel noise of `bits` over the last axis, the
    first index at ties; int32."""
    return torch.argmax(gumbel_of_bits(bits) + logits, dim=-1).to(torch.int32)


"""JAX's default PRNG (threefry2x32) on torch integer ops, for the scan
trackers' device draws: `prng_key`, `fold_in` and `uniform` give the bits
and floats that `jax.random.PRNGKey`, `jax.random.fold_in` and
`jax.random.uniform` (float32) give in JAX 0.9.0 with
`jax_threefry_partitionable` True, its default since JAX 0.5.0:

- `PRNGKey(s)` is the pair (0, s) for a seed below 2**32;
- `fold_in(k, d)` is threefry2x32(k, (0, d));
- the 32 random bits at flat index i of a draw are b1 ^ b2 of
  threefry2x32(k, (0, i)) (the partitionable layout; the older layout
  splits the counters into two halves instead);
- `uniform` sets the exponent of float32 1.0 under the top 23 bits,
  subtracts 1, scales to [lo, hi) and takes max(lo, .).

torch has little uint32 arithmetic, so every word is an int64 tensor
holding a value in [0, 2**32), masked after each add and rotate. A key is a
pair (k1, k2) of Python ints or of int64 tensors of one batch shape, so a
draw keyed on a per-row counter (a (B,) device tensor) runs on the device
with no host value, inside a captured CUDA graph too.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block of (x0, x1) under `key`, as
    jax.random's threefry2x32 primitive; words in [0, 2**32) as int64."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return 0, int(seed)


def fold_in(key: Key, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.random.fold_in(key, d) for each element d of `data` (an integer
    tensor, taken as uint32): a key of data's shape."""
    d = data.to(torch.int64) & _MASK
    return threefry2x32(key, torch.zeros_like(d), d)


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) for each key
    of a batch of keys: (*key's shape, *shape) float32. `device` is used when
    both words of the key are Python ints."""
    words = [k for k in key if isinstance(k, torch.Tensor)]
    lead = words[0].shape if words else ()
    device = words[0].device if words else device
    n = 1
    for s in shape:
        n *= int(s)
    count = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = (k[..., None] if isinstance(k, torch.Tensor) else k for k in key)
    b0, b1 = threefry2x32((k0, k1), torch.zeros_like(count), count)
    bits = (b0 ^ b1).expand(*lead, n)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    out = torch.clamp_min(floats * float(hi - lo) + float(lo), float(lo))  # hi - lo in float32
    return out.reshape(*lead, *shape)

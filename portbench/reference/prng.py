"""Frozen copy of open3dsot_tpu_torch/utils/prng.py, unchanged below this
paragraph, so that the reference draws what the training-sample builder
must draw.

JAX's default PRNG (threefry2x32) on torch integer ops, for the scan
trackers' and the training-sample builder's device draws: `prng_key`,
`fold_in`, `split`, `bits`, `uniform`, `randint` and `bernoulli` give the
bits, integers and floats that `jax.random.PRNGKey`, `fold_in`, `split`,
`bits`, `uniform` (float32), `randint` (int32, here as int64) and
`bernoulli` give in JAX 0.9.0 with `jax_threefry_partitionable` True, its
default since JAX 0.5.0; `normal` is within `NORMAL_ULPS` of
`jax.random.normal` (float32):

- `PRNGKey(s)` is the pair (0, s) for a seed below 2**32;
- `fold_in(k, d)` is threefry2x32(k, (0, d));
- key i of `split(k, n)` is threefry2x32(k, (0, i));
- the 32 random bits at flat index i of a draw are b1 ^ b2 of
  threefry2x32(k, (0, i)) (the partitionable layout; the older layout
  splits the counters into two halves instead);
- `uniform` sets the exponent of float32 1.0 under the top 23 bits,
  subtracts 1, scales to [lo, hi) by one multiply-add rounded once (XLA
  fuses it) and takes max(lo, .);
- `randint` splits the key in two, draws a higher and a lower word and
  reduces them mod the span with 2**32 mod span computed as
  ((2**16 mod span)**2) mod span, in wrapping uint32
  (`jax._src.random._randint`); a span of 0 or 1 gives minval;
- `normal` is sqrt(2) erfinv(u) for u uniform on [nextafter(-1, 0), 1),
  with XLA's float32 erfinv (Giles' polynomials in w = -log1p(-u^2)).

torch has little uint32 arithmetic, so every word is an int64 tensor
holding a value in [0, 2**32) (or a Python int), masked after each add and
rotate. A key is a pair (k1, k2) of Python ints or of int64 tensors of one
batch shape, so a draw keyed on a per-row counter (a (B,) device tensor)
runs on the device with no host value, inside a captured CUDA graph too. A
key of Python ints is derived on the host (`fold_in` of an int, `split`:
Python integer arithmetic) and its draws are made on the device they are
asked for, with no host sync; `bits_many` makes many such draws in one
pass, and `uniform_of`, `randint_of`, `bernoulli_of` and `normal_of` turn
their bits into values.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: Word, r: int) -> Word:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The 20-round Threefry-2x32 block of (x0, x1) under `key`, as
    jax.random's threefry2x32 primitive; words in [0, 2**32) as int64
    tensors or Python ints."""
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


def _host_words(key: Key) -> bool:
    return not any(isinstance(k, torch.Tensor) for k in key)


def fold_in(key: Key, data) -> Key:
    """jax.random.fold_in(key, d) for each element d of `data` (an integer
    tensor, taken as uint32): a key of data's shape. A Python int `data`
    folded into a key of Python ints gives a key of Python ints, computed
    on the host."""
    if isinstance(data, int) and _host_words(key):
        return threefry2x32(key, 0, data & _MASK)
    d = torch.as_tensor(data).to(torch.int64) & _MASK
    return threefry2x32(key, torch.zeros_like(d), d)


def split(key: Key, num: int = 2) -> list:
    """jax.random.split(key, num) as a list of `num` keys, each of the
    key's shape (Python ints, computed on the host, for a key of Python
    ints)."""
    if _host_words(key):
        return [threefry2x32(key, 0, i) for i in range(num)]
    device = next(k.device for k in key if isinstance(k, torch.Tensor))
    count = torch.arange(num, dtype=torch.int64, device=device)
    k0, k1 = (k[..., None] if isinstance(k, torch.Tensor) else k for k in key)
    w0, w1 = threefry2x32((k0, k1), torch.zeros_like(count), count)
    return [(w0[..., i], w1[..., i]) for i in range(num)]


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def bits_many(requests: Sequence[Tuple[Key, Sequence[int]]], device=None) -> list:
    """[bits(key, shape) for each (key, shape)] for keys of Python ints, in
    one threefry pass on `device` (a draw costs some 170 elementwise
    kernels however small it is)."""
    sizes = [_numel(shape) for _, shape in requests]
    full = lambda n, w: torch.full((n,), w, dtype=torch.int64, device=device)  # noqa: E731
    count = torch.cat([torch.arange(n, dtype=torch.int64, device=device) for n in sizes])
    k0 = torch.cat([full(n, k[0]) for n, (k, _) in zip(sizes, requests)])
    k1 = torch.cat([full(n, k[1]) for n, (k, _) in zip(sizes, requests)])
    b0, b1 = threefry2x32((k0, k1), torch.zeros_like(count), count)
    return [b.reshape(tuple(shape)) for b, (_, shape) in zip(torch.split(b0 ^ b1, sizes), requests)]


def bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) as int64 words in [0, 2**32):
    (*key's shape, *shape). `device` is used when both words of the key are
    Python ints."""
    words = [k for k in key if isinstance(k, torch.Tensor)]
    if not words:
        return bits_many([(key, shape)], device)[0]
    lead, n = words[0].shape, _numel(shape)
    count = torch.arange(n, dtype=torch.int64, device=words[0].device)
    k0, k1 = (k[..., None] if isinstance(k, torch.Tensor) else k for k in key)
    b0, b1 = threefry2x32((k0, k1), torch.zeros_like(count), count)
    return (b0 ^ b1).expand(*lead, n).reshape(*lead, *shape)


def uniform_of(b: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The float32 uniform on [minval, maxval) of a draw's bits."""
    floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # floats * (hi - lo) + lo with one rounding, as XLA's fused multiply-add:
    # the float32 product is exact in float64
    out = (floats.double() * float(hi - lo) + float(lo)).float()  # hi - lo in float32
    return torch.clamp_min(out, float(lo))


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) for each key
    of a batch of keys: (*key's shape, *shape) float32. `device` is used when
    both words of the key are Python ints."""
    return uniform_of(bits(key, shape, device), minval, maxval)


def randint_requests(key: Key, shape: Sequence[int]) -> list:
    """The two draws of randint(key, shape, ...): its higher and lower words."""
    return [(k, shape) for k in split(key)]


def randint_of(higher: torch.Tensor, lower: torch.Tensor, minval, maxval) -> torch.Tensor:
    """randint's integers in [minval, maxval) from its two draws;
    `minval` / `maxval` ints or integer tensors that broadcast to them."""
    lo, hi = (v.long() if isinstance(v, torch.Tensor) else v for v in (minval, maxval))
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        span = torch.where(hi <= lo, 1, (hi - lo) & _MASK)
    else:
        span = 1 if hi <= lo else (hi - lo) & _MASK
    # (a * b) & _MASK is the uint32 product, even where int64 wraps
    multiplier = (((65536 % span) * (65536 % span)) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    return lo + (offset & _MASK) % span


def randint(key: Key, shape: Sequence[int], minval, maxval, device=None) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) (int32) as int64, for
    a key of Python ints; `minval` / `maxval` are ints or integer tensors
    that broadcast to `shape` (a per-row (B, 1) maxval, say)."""
    if device is None:
        device = next((v.device for v in (minval, maxval) if isinstance(v, torch.Tensor)), None)
    return randint_of(*bits_many(randint_requests(key, shape), device), minval, maxval)


def bernoulli_of(b: torch.Tensor, p: float) -> torch.Tensor:
    return uniform_of(b) < float(np.float32(p))


def bernoulli(key: Key, p: float, shape: Sequence[int], device=None) -> torch.Tensor:
    """jax.random.bernoulli(key, p, shape): uniform(key, shape) < p."""
    return bernoulli_of(bits(key, shape, device), p)


# XLA's float32 ErfInv (M. Giles, "Approximating the erfinv function"),
# highest power first, for w < 5 and for w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# The largest distance, in float32 ulps, of `normal` from jax.random.normal
# on the CPU: 3, over 2**20 draws of 16 keys (1 to 5% of draws differ at
# all). XLA's log1p is not torch's (2 ulps apart at most), and XLA fuses
# the polynomial's multiply-adds (fed XLA's log1p, this polynomial with
# fused multiply-adds gives XLA's bits; with torch's log1p, fusing them
# leaves the bound at 3).
NORMAL_ULPS = 3


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv of x in [-1, 1] (+-inf at +-1)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_of(b: torch.Tensor) -> torch.Tensor:
    """The float32 standard normal of a draw's bits."""
    u = uniform_of(b, float(np.nextafter(np.float32(-1.0), np.float32(0.0))), 1.0)
    return erfinv_f32(u) * float(np.float32(np.sqrt(2.0)))


def normal(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """jax.random.normal(key, shape) (float32), within NORMAL_ULPS."""
    return normal_of(bits(key, shape, device))

"""Random weights from the seed, made on the device in one call.

A reference model lists its parameters and buffers as (name, shape, init)
(`param_specs`); `make` draws every value at once from a torch.Generator on
the device and shapes them into a state dict in the port's names, float32.
The same seed gives the same weights on the same kind of device. Inits: a
Dense weight or bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default),
a BatchNorm scale U(0.5, 1.5), shift U(-0.1, 0.1), running mean U(-0.1,
0.1), running variance U(0.5, 1.5), the step count 0.
"""

from __future__ import annotations

import math

import torch

_RANGES = {"gamma": (0.5, 1.5), "beta": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}


def make(specs: list, seed: int, device) -> dict:
    """State dict {name: tensor} for `specs` [(name, shape, init), ...]."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    sd, at = {}, 0
    for (name, shape, init), size in zip(specs, sizes):
        u = flat[at: at + size].view(shape)
        at += size
        kind = init[0]
        if kind == "count":
            sd[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if kind in ("w", "b"):
            bound = 1.0 / math.sqrt(init[1])
            lo, hi = -bound, bound
        else:
            lo, hi = _RANGES[kind]
        sd[name] = (u * (hi - lo) + lo).contiguous()
    return sd

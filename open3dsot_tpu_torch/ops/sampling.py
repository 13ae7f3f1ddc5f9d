"""Furthest point sampling, port of `open3dsot_tpu/ops/sampling.py` and of
its Pallas kernel `open3dsot_tpu/ops/fps_pallas.py` (K3).

Semantics of the CUDA op and of the JAX XLA loop: seed index 0, squared
distances ((dx*dx) + (dy*dy)) + (dz*dz) rounded one op at a time, a
running min that starts at 1e10, argmax with the lowest index on ties.
The indices are exact, so every rounding is pinned: the kernel
(csrc/fps.cu) computes d^2 with __fmul_rn/__fadd_rn in the same order.

`furthest_point_sample` takes the plain version for a CPU tensor and
launches K3 for a CUDA tensor, or raises. Launches are counted in
`furthest_point_sample.launches`.
"""

from __future__ import annotations

import torch

from open3dsot_tpu_torch.ops._launch import check, on_cuda, raise_on, stream_of

_ERRORS = {-1: "B, N or npoint not accepted (1 <= npoint, N <= 32768)"}


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (B, N, 3) -> (B, npoint) int32; a torch loop over the samples."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    idxs = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = xyz[:, 0]
    for i in range(1, npoint):
        d = xyz - last[:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        min_d2 = torch.minimum(min_d2, d2)
        nxt = torch.argmax(min_d2, dim=-1)  # the first maximal index
        idxs[:, i] = nxt
        last = xyz[rows, nxt]
    return idxs.int()


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """K3: xyz (B, N, 3) -> (B, npoint) int32 indices."""
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if not on_cuda(xyz):
        return furthest_point_sample_plain(xyz, npoint)
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = xyz.shape
    check("xyz", xyz, xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    rc = load_library("fps").lib.fps_k3(xyz.data_ptr(), B, N, npoint, out.data_ptr(),
                                         stream_of(xyz))
    raise_on(rc, "K3 fps_k3", _ERRORS)
    furthest_point_sample.launches += 1
    return out


furthest_point_sample.launches = 0


def reset_launch_counts() -> None:
    furthest_point_sample.launches = 0

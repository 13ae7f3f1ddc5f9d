"""Furthest point sampling, port of `open3dsot_tpu/ops/sampling.py` and of
its Pallas kernel `open3dsot_tpu/ops/fps_pallas.py` (K3).

Semantics of the CUDA op and of the JAX XLA loop: seed index 0, squared
distances ((dx*dx) + (dy*dy)) + (dz*dz) rounded one op at a time, a
running min that starts at 1e10, argmax with the lowest index on ties.
The indices are exact, so every rounding is pinned: the kernel
(csrc/fps.cu) computes d^2 with __fmul_rn/__fadd_rn in the same order.

K3 is an operator (`open3dsot::furthest_point_sample`, registered with
torch.library.custom_op, with a fake implementation for torch.export; see
ops/chain_fused.py): the plain version for a CPU tensor, K3 for a CUDA
tensor, or it raises. `furthest_point_sample` calls the operator, or its
CUDA function directly for a CUDA tensor that is not being traced. Launches are counted in
`furthest_point_sample.launches`. K3's block (T threads, PPT points a
thread) is chosen here, by `fps_block`, and where the winner's coordinates
come from by `fps_winner`; the kernel only checks them.
"""

from __future__ import annotations

from typing import Optional

import torch

from open3dsot_tpu_torch.ops._launch import check, direct, on_cuda, raise_on, stream_of

MAX_N = 32768
MAX_PPT = 32
WINNERS = ("slot", "shared")  # the winner's coordinates: the warps' slots, or the cloud in smem
_SHARED_BYTES = 232448 - 1280  # a block's shared memory less K3's slots (csrc/fps.cu)
_ERRORS = {-1: "B, N or npoint not accepted (1 <= npoint, N <= 32768)",
           -2: "block not accepted (T a power of two in [32, 1024], PPT one up to 32, T * PPT >= N)",
           -3: "the cloud does not fit in shared memory (12 N bytes)"}


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def fps_block(n: int) -> tuple:
    """K3's block for a cloud of n points: (T threads, PPT points a thread),
    both powers of two, T in [32, 1024], PPT <= 32, T * PPT >= n. By N, from
    the block sweep of chip_smoke.py phase 6 (every T at N = 512 to 16384 on
    an H100), the fastest T at each: one point a thread up to 512 points;
    256 threads up to 2048; 32 points a thread up to 8192; 1024 threads
    above."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"K3 takes 1 <= N <= {MAX_N}, got {n}")
    if n <= 512:
        threads = max(32, _pow2_at_least(n))
    elif n <= 2048:
        threads = 256
    elif n <= 8192:
        threads = _pow2_at_least(n) // MAX_PPT
    else:
        threads = 1024
    return threads, _pow2_at_least(-(-n // threads))


def fps_winner(n: int) -> str:
    """Where K3 reads each step's winner: the cloud's copy in shared memory
    where its 12 n bytes fit, else the warps' slots."""
    return "shared" if 12 * n <= _SHARED_BYTES else "slot"


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


@torch.library.custom_op("open3dsot::furthest_point_sample", mutates_args=(),
                         device_types="cpu")
def _k3_op(xyz: torch.Tensor, npoint: int, threads: int, winner: int) -> torch.Tensor:
    """K3 on the CPU: the plain version. threads / winner -1: K3's own choice."""
    return furthest_point_sample_plain(xyz, npoint)


@_k3_op.register_fake
def _k3_fake(xyz, npoint, threads, winner):
    return xyz.new_empty(xyz.shape[0], npoint, dtype=torch.int32)


@_k3_op.register_kernel("cuda")
def _k3_cuda(xyz, npoint, threads, winner):
    from open3dsot_tpu_torch.ops._build import load_library

    B, N, _ = xyz.shape
    check("xyz", xyz, xyz.device)
    T, ppt = fps_block(N)
    if threads >= 0:
        T, ppt = threads, _pow2_at_least(-(-N // threads))
    form = winner if winner >= 0 else WINNERS.index(fps_winner(N))
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    rc = load_library("fps").lib.fps_k3(xyz.data_ptr(), B, N, npoint, T, ppt, form,
                                         out.data_ptr(), stream_of(xyz))
    raise_on(rc, "K3 fps_k3", _ERRORS)
    furthest_point_sample.launches += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int, threads: Optional[int] = None,
                          winner: Optional[str] = None) -> torch.Tensor:
    """K3: xyz (B, N, 3) -> (B, npoint) int32 indices. `threads` and
    `winner` force K3's block size and winner form (for timing them); by
    default `fps_block` and `fps_winner` choose."""
    if xyz.dim() != 3 or xyz.shape[2] != 3:
        raise ValueError(f"xyz must be (B, N, 3), got {tuple(xyz.shape)}")
    if winner is not None and winner not in WINNERS:
        raise ValueError(f"winner must be one of {WINNERS}, got {winner!r}")
    on_cuda(xyz)  # a device with neither a kernel nor a plain version raises
    return (_k3_cuda if direct(xyz) else _k3_op)(
        xyz, int(npoint), -1 if threads is None else int(threads),
        -1 if winner is None else WINNERS.index(winner))


furthest_point_sample.launches = 0


def reset_launch_counts() -> None:
    furthest_point_sample.launches = 0

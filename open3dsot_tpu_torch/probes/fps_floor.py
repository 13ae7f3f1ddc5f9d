"""K3's latency floor: the serial skeleton of furthest point sampling's steps
alone on K3's block (csrc/fps_floor.cu, the note is there). Its time over
npoint - 1 steps is K3's latency-aware bound, which chip_smoke.py phase 6
prints beside K3's device time. It needs a CUDA device: there is no plain
version of a latency.
"""

from __future__ import annotations

import torch

from open3dsot_tpu_torch.ops._launch import check, raise_on, stream_of


def block_threads(n: int) -> int:
    """K3's block size for a cloud of n points (csrc/fps.cu::fps_k3)."""
    return min(1024, (n + 31) // 32 * 32)


def fps_chain_floor(steps: int, n: int, sink: torch.Tensor) -> None:
    """Launch `steps` steps of the skeleton on K3's block for n points; sink is
    one float32 on the card that the chain's last value is written to."""
    if not sink.is_cuda:
        raise ValueError("fps_chain_floor measures a CUDA kernel: sink must be on a CUDA device")
    check("sink", sink, sink.device, (1,))
    from open3dsot_tpu_torch.ops._build import load_library

    rc = load_library("fps_floor").lib.fps_chain_floor(steps, block_threads(n), sink.data_ptr(),
                                                       stream_of(sink))
    raise_on(rc, "fps_chain_floor", {-1: "steps < 1 or a block size K3 does not take"})
    fps_chain_floor.launches += 1


fps_chain_floor.launches = 0

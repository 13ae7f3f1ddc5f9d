"""K3's skeleton floors: the serial skeleton of furthest point sampling's
step alone, in the design K3 had before its redesign (v1) and in the one it
has (v2), on each design's block (csrc/fps_floor.cu, the note is there).
Its time over npoint - 1 steps is a floor of that design, which
chip_smoke.py phase 6 prints beside K3's device time; it is not the card's
bound. It needs a CUDA device: there is no plain version of a latency.
"""

from __future__ import annotations

import torch

from open3dsot_tpu_torch.ops._launch import check, raise_on, stream_of
from open3dsot_tpu_torch.ops.sampling import fps_block

DESIGNS = (1, 2)


def design_threads(design: int, n: int) -> int:
    """The block a design runs for a cloud of n points: v1 took one point a
    thread up to 1024 threads; v2 takes `fps_block`'s T."""
    if design == 1:
        return min(1024, (n + 31) // 32 * 32)
    return fps_block(n)[0]


def fps_chain_floor(steps: int, n: int, sink: torch.Tensor, design: int = 2) -> None:
    """Launch `steps` steps of a design's skeleton on its block for n points;
    sink is one float32 on the card that the chain's last value is written to."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design}")
    if not sink.is_cuda:
        raise ValueError("fps_chain_floor measures a CUDA kernel: sink must be on a CUDA device")
    check("sink", sink, sink.device, (1,))
    from open3dsot_tpu_torch.ops._build import load_library

    rc = load_library("fps_floor").lib.fps_chain_floor(design, steps, design_threads(design, n),
                                                       sink.data_ptr(), stream_of(sink))
    raise_on(rc, "fps_chain_floor", {-1: "steps < 1 or a block size the skeleton does not take"})
    fps_chain_floor.launches += 1


fps_chain_floor.launches = 0

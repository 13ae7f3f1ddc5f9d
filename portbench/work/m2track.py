"""Closed-form work of M2-Track's eval forward and of its kernels K1/K2, from
shapes alone.

Copied from the port's chip check (chip_smoke.py::chain_work, k1_work,
k2_work): a per-point Dense chain over B * N points reads its input once,
its weights once and writes its outputs once (4 bytes a value), and does
2 * in * out operations a point a layer. The chains are M2-Track's at the
widths of portbench/reference/m2track.py; N is the two frames' points,
2 * point_sample_size.
"""

from __future__ import annotations

from portbench.reference import m2track as m

SEG1 = (5 + m.BC,) + m.SEG_MLP1
SEG2 = (m.SEG_MLP1[m.TAP_AT] + m.SEG_MLP1[-1],) + m.SEG_MLP2 + (m.SEG_OUT,)
MINI1 = (4 + m.BC,) + m.MINI_MLP
MINI2 = (3 + m.BC,) + m.MINI_MLP
HIDDEN = (m.MINI_MLP[-1],) + m.MINI_HIDDEN
HEADS = [(m.MINI_HIDDEN[-1],) + m.HEAD + (k,) for k in (4, 2, 4, 4)]


def _macs(widths) -> int:
    return sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def _params(widths) -> int:
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def forward_flops(n: int) -> float:
    """Operations of one frame's forward (2 a multiply-add), n points a frame."""
    N = 2 * n
    per_point = _macs(SEG1) + _macs(SEG2) + _macs(MINI1) + _macs(MINI2)
    per_cloud = 2 * _macs(HIDDEN) + sum(_macs(h) for h in HEADS)
    return 2.0 * (N * per_point + per_cloud)


def chain_work(widths, B: int, N: int, out_elems: int):
    """(bytes, operations) of one K1 call over a chain of `widths`."""
    return 4.0 * (B * N * widths[0] + _params(widths) + out_elems), 2.0 * B * N * _macs(widths)


def k2_work(B: int, N: int):
    """(bytes, operations) of K2: the per-point chain from the tap's share of
    the first layer on, and the pooled row's share of it once a cloud."""
    c_tap, c_pool, first = m.SEG_MLP1[m.TAP_AT], m.SEG_MLP1[-1], SEG2[1]
    nbytes = 4.0 * (B * N * c_tap + B * c_pool + _params(SEG2) + B * N * SEG2[-1])
    flops = 2.0 * B * N * (c_tap * first + _macs(SEG2[1:])) + 2.0 * B * c_pool * first
    return nbytes, flops


def step_kernel_calls(B: int, n: int) -> list:
    """(bytes, operations) of each K1/K2 call of one step at batch B."""
    N = 2 * n
    return [chain_work(SEG1, B, N, B * N * m.SEG_MLP1[m.TAP_AT] + B * SEG1[-1]),
            chain_work(MINI1, B, N, B * MINI1[-1]),
            chain_work(MINI2, B, N, B * MINI2[-1]),
            k2_work(B, N)]


def train_flops(n: int) -> float:
    """Operations of one training sample: the forward and a backward of
    twice its operations (the gradients of the inputs and of the weights)."""
    return 3.0 * forward_flops(n)

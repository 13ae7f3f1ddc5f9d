"""Closed-form work of BAT's farthest-point sampling K3 and of its training
SA kernel K6, from shapes alone.

Copied from the port's chip check: `chip_smoke.py::k3_work` (a K3 call
reads the clouds and writes the indices once, 4 bytes a value; each of its
npoint - 1 steps does 3 subtractions, 3 multiplies, 2 adds and a min a
point) and `chip_smoke.py::k6_work` in float32 (a K6 forward reads a = the
points' layer-1 product, ct = the centroids' term and the neighbour
indices, the weights and statistics once, and writes its output and the
grids y2, y3 that its backward reads; operations 2 a multiply-add of
layers 2-3 over the B * S * K rows, plus the BatchNorm and ReLU work
a row). K3's operations bound it at the float32 rate outside the tensor
cores; K6 computes in 3xTF32 (`peaks.tc_bound_s`).
"""

from __future__ import annotations

from portbench.reference import bat as ref


def k3_work(B: int, N: int, S: int):
    """(bytes, operations) of one K3 call: B clouds of N points -> S indices."""
    return 4 * B * (N * 3 + S), 9 * B * (S - 1) * N


def k3_calls(cfg: dict, B: int) -> list:
    """(bytes, operations) of the two K3 calls of one BAT forward at batch
    B: the template's and the search's first SA layer."""
    return [k3_work(B, n, n // 2) for n in (int(cfg["template_size"]), int(cfg["search_size"]))]


def k6_work(B: int, N: int, S: int, K: int, c1: int, c2: int, c3: int):
    """((bytes, operations) forward, (bytes, operations) backward) of one
    float32 K6 call: N points of layer-1 width c1, S centroids of K
    neighbours, layer widths c1, c2, c3."""
    R, cs = B * S * K, c1 + c2 + c3
    weights = 4 * (c1 * c2 + c2 * c3) + 4 * (c2 + c3 + 2 * cs)
    inputs = 4 * (B * N * c1 + B * S * c1 + B * S * K)  # a, ct, idx
    grids = 4 * R * (c2 + c3)
    fwd = (inputs + weights + 4 * B * S * c3 + 4 * 2 * cs + grids,
           2 * R * (c1 * c2 + c2 * c3) + 6 * R * cs + R * (c1 + c3))
    bwd = (4 * B * S * c3 + inputs + grids + 4 * 2 * cs + weights
           + 4 * (B * N * c1 + B * S * c1 + c1 * c2 + c2 * c3 + 2 * cs),
           4 * R * (c1 * c2 + c2 * c3) + 12 * R * cs)
    return fwd, bwd


def k6_calls(cfg: dict, B: int) -> list:
    """((fwd), (bwd)) work of the four K6 calls of one BAT training step at
    batch B: SA layers 2-3 of the backbone (the first takes no features,
    so it runs the plain path), template then search."""
    calls = []
    for n in (int(cfg["template_size"]), int(cfg["search_size"])):
        for i in (1, 2):
            mlp = ref.SA[i][0]
            calls.append(k6_work(B, n // (1 << i), n // (2 << i), ref.NSAMPLE, *mlp))
    return calls

"""Closed-form work of BAT's eval forward and of its SA kernel K4, from
shapes alone.

K4's count is copied from the port's chip check (chip_smoke.py::sa_work):
xyz, features and centroids read once, the folded weights read once, the
(B, S, C3) output written once (4 bytes a value); layer 1 in its A form
over the N points (2 * N * C_in * C1 a cloud), layers 2-3 over the
(B, S, K) grid. The ball query's distance tests (8 operations a point it
walks, which depend on the data) are left out, so the count is a floor of
the work and a share of the roofline reads low rather than high. The
forward's count (`forward_flops`) takes K4's for the seven SA layers and
2 * in * out a row for every other Dense layer; the kNN, the farthest-point
sampling and the rigid math are left out.
"""

from __future__ import annotations

from portbench.reference import bat as ref


def _params(widths) -> int:
    return sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))


def sa_work(B: int, N: int, C: int, S: int, K: int, mlp):
    """(bytes, operations) of one K4 call: N points of C features, S centroids."""
    widths = (3 + C,) + tuple(mlp)
    c1, c2, c3 = mlp
    nbytes = 4.0 * (B * (N * (3 + C) + S * 3 + S * c3) + _params(widths))
    flops = 2.0 * B * N * (3 + C) * c1 + 2.0 * B * S * K * (c1 * c2 + c2 * c3)
    return nbytes, flops


def sa_calls(cfg: dict, B: int) -> list:
    """(bytes, operations) of the seven K4 calls of one forward at batch B."""
    calls = []
    for n in (int(cfg["template_size"]), int(cfg["search_size"])):
        C = 0
        for i, (mlp, _) in enumerate(ref.SA):
            N, S = n // (1 << i), n // (2 << i)
            calls.append(sa_work(B, N, C, S, ref.NSAMPLE, mlp))
            C = mlp[-1]
    o, v = int(cfg["out_channel"]), int(cfg["vote_channel"])
    n_votes = int(cfg["search_size"]) // 8
    calls.append(sa_work(B, n_votes, 1 + o, int(cfg["num_proposal"]), ref.VOTE_NSAMPLE,
                         (v, v, v)))
    return calls


def forward_flops(cfg: dict, B: int = 1) -> float:
    """Operations of one forward at batch B (2 a multiply-add)."""
    f, h, o, v = (int(cfg[k]) for k in ("feature_channel", "hidden_channel", "out_channel",
                                        "vote_channel"))
    bc, k = int(cfg.get("bc_channel", 9)), int(cfg.get("k", 4))
    M, N, P = int(cfg["template_size"]) // 8, int(cfg["search_size"]) // 8, int(cfg["num_proposal"])
    c_out = ref.SA[-1][0][-1]

    def dense(rows, widths):
        return 2.0 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))

    flops = sum(fl for _, fl in sa_calls(cfg, B))
    flops += dense(B * (M + N), (c_out, f))  # conv_final
    flops += dense(B * N, (3 + f, f, f, bc))  # mlp_bc
    flops += dense(B * N * k, (3 + bc + f, h, h, h)) + dense(B * N, (h, h, o))  # xcorr
    flops += dense(B * N, (o, o, o, 1)) + dense(B * N, (3 + o, o, o, 3 + o))  # cla, votes
    flops += dense(B * P, (v, v, v, 5))  # proposals
    return flops

"""K6's backward picks its ordered da path under torch's deterministic
algorithms, in both modes, with a stand-in library (tests/
test_torch_bf16_kernels.py's): the `ordered` argument of sa_train_bwd /
sa_train_bf16_bwd is 1 with `torch.use_deterministic_algorithms(True)` and
0 without, read at each call, and `ordered_bwd_launches` counts the
ordered launches. The kernels themselves are checked on the card
(chip_smoke.py phases 11, 19 and 22e)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from open3dsot_tpu_torch.ops import _build
from open3dsot_tpu_torch.ops import sa_fused_train as k6
import tests._torch_port  # noqa: F401  (one torch thread, as every port test)
from tests.test_torch_bf16_kernels import stand_in  # noqa: F401

B, N, S, K, C1, C2, C3 = 2, 16, 4, 3, 8, 8, 12


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _args(bf16: bool):
    rng = np.random.default_rng(1)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    idx = torch.from_numpy(rng.integers(0, N, (B, S, K)).astype(np.int32))
    if bf16:
        grids = (torch.zeros(B, S, K, _round8(C1), dtype=torch.bfloat16),
                 torch.zeros(B, S, K, _round8(C2), dtype=torch.bfloat16), f(3, B, S, C3))
        packs = SimpleNamespace(bf16=True, w2=None, w3=None, check=lambda *w: None,
                                w2t=torch.zeros(1, dtype=torch.bfloat16),
                                w3t=torch.zeros(1, dtype=torch.bfloat16))
        packs.w2 = packs.w3 = packs.w2t
    else:
        grids = (f(B, S, K, C2), f(B, S, K, C3))
        packs = SimpleNamespace(bf16=False, w2t=f(5), w3t=f(5), check=lambda *w: None)
    stats = [f(C1), f(C1), f(C2), f(C2), f(C3), f(C3)]
    bn = [f(C1), f(C1), f(C2), f(C2), f(C3), f(C3)]
    return (f(B, S, C3), f(B, N, C1), f(B, S, C1), idx, grids, stats, f(C1, C2), f(C2), f(C2, C3),
            f(C3), bn, packs)


@pytest.mark.parametrize("bf16", [False, True])
def test_backward_takes_the_ordered_entry_under_deterministic_algorithms(stand_in, bf16,  # noqa: F811
                                                                          monkeypatch):
    monkeypatch.setattr(k6, "stream_of", lambda t: 0)
    lib = "sa_fused_train_bf16" if bf16 else "sa_fused_train"
    entry = "sa_train_bf16_bwd" if bf16 else "sa_train_bwd"
    k6.reset_launch_counts()
    was = torch.are_deterministic_algorithms_enabled()
    try:
        for flag in (False, True, False):
            torch.use_deterministic_algorithms(flag)
            k6.sa_train_bwd_kernel(*_args(bf16))
    finally:
        torch.use_deterministic_algorithms(was)
    calls = [args for fn, args in stand_in[lib].lib.calls if fn == entry]
    sig = _build.SIGNATURES[lib][entry]
    assert all(len(a) == len(sig) for a in calls)
    # the flag before the stream, after the seven dims
    assert [a[-2] for a in calls] == [0, 1, 0]
    assert list(calls[0][-9:-2]) == [B, N, S, K, C1, C2, C3]
    assert k6.fused_sa_train_apply.ordered_bwd_launches == 1
    assert k6.fused_sa_train_apply.bwd_launches == 3
    assert k6.fused_sa_train_apply.bf16_bwd_launches == (3 if bf16 else 0)

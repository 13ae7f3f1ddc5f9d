"""Port of ops/chain_fused.py (kernels K1, K2) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX fused kernels (Pallas, interpret mode on CPU) and the
unfused flax modules, with the widths and tolerance of
tests/test_chain_fused.py (atol 2e-5: f32 everywhere, the BN fold
reassociates). The CUDA kernels themselves are compared with the plain
versions on the card by chip_smoke.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from open3dsot_tpu.models.pointnet import MiniPointNet as JMini
from open3dsot_tpu.models.pointnet import SegPointNet as JSeg
from open3dsot_tpu.ops.chain_fused import fused_pointnet_encoder as j_encoder
from open3dsot_tpu.ops.chain_fused import fused_seg_head as j_head
from open3dsot_tpu_torch.models.pointnet import MiniPointNet, SegPointNet
from open3dsot_tpu_torch.ops import chain_fused as cf
from tests._torch_port import load_into, randomize, t

ATOL = 2e-5
MLP1, MLP2 = [16, 16, 16, 32, 64], [32, 16, 16]
MINI = [16, 16, 32]


def _seg(n, seed, c_in=14):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n, c_in)).astype(np.float32)
    jm = JSeg(per_point_mlp1=MLP1, per_point_mlp2=MLP2, output_size=11)
    v = randomize(jm.init(jax.random.PRNGKey(0), x, train=False), rng)
    port = load_into(SegPointNet(c_in, MLP1, MLP2, 11), v)
    return x, jm, v, port


def _mini(n, seed, c_in=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n, c_in)).astype(np.float32)
    jm = JMini(per_point_mlp=MINI, hidden_mlp=[32, 16], output_size=-1)
    v = randomize(jm.init(jax.random.PRNGKey(0), x, train=False), rng)
    port = load_into(MiniPointNet(c_in, MINI, [32, 16], output_size=-1), v)
    return x, jm, v, port


# N = 50 and 52: no power-of-two tile divides them (the CUDA kernel masks
# the ragged last tile; the plain version must agree at any N)
@pytest.mark.parametrize("n", [64, 50, 52])
def test_plain_k1_with_tap_matches_jax_kernel(n):
    x, _, v, port = _seg(n, seed=n)
    p, st = v["params"], v["batch_stats"]
    want_tap, want_pool = j_encoder(
        x, [p[f"mlp1_{i}"]["layer0"] for i in range(5)],
        [st[f"mlp1_{i}"]["layer0"] for i in range(5)], tap_at=1)
    chain1, _ = port.folded_chains()
    tap, pooled = cf.fused_pointnet_encoder(t(x), chain1, tap_at=1)
    np.testing.assert_allclose(tap.numpy(), np.asarray(want_tap), atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pool), atol=ATOL)


@pytest.mark.parametrize("n,c_in", [(48, 13), (50, 12)])
def test_plain_k1_without_tap_matches_jax_kernel(n, c_in):
    x, _, v, port = _mini(n, seed=n, c_in=c_in)
    p, st = v["params"]["per_point"], v["batch_stats"]["per_point"]
    tap_none, want = j_encoder(x, [p[f"layer{i}"] for i in range(3)],
                               [st[f"layer{i}"] for i in range(3)], tap_at=None)
    assert tap_none is None
    tap, pooled = cf.fused_pointnet_encoder(t(x), port.folded_chains())
    assert tap is None
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("n", [64, 50])
def test_plain_k2_matches_jax_kernel(n):
    x, _, v, port = _seg(n, seed=10 + n)
    p, st = v["params"], v["batch_stats"]
    rng = np.random.default_rng(n)
    tap = np.abs(rng.standard_normal((3, n, MLP1[1]))).astype(np.float32)
    pooled = np.abs(rng.standard_normal((3, MLP1[-1]))).astype(np.float32)
    want = j_head(tap, pooled, [p[f"mlp2_{i}"]["layer0"] for i in range(3)],
                  [st[f"mlp2_{i}"]["layer0"] for i in range(3)], p["fc"])
    _, chain2 = port.folded_chains()
    got = cf.fused_seg_head(t(tap), t(pooled), chain2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fused_eval", [True, False])
def test_seg_pointnet_matches_unfused_flax(fused_eval):
    x, jm, v, port = _seg(64, seed=3)
    port.fused_eval = fused_eval
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fused_eval", [True, False])
def test_mini_pointnet_matches_unfused_flax(fused_eval):
    x, jm, v, port = _mini(48, seed=4)
    port.fused_eval = fused_eval
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    x, _, _, port = _seg(64, seed=5)
    cf.reset_launch_counts()
    with torch.no_grad():
        port(t(x))
    assert cf.fused_pointnet_encoder.launches == 0
    assert cf.fused_seg_head.launches == 0


def test_fold_cache_follows_load_state_dict_and_to():
    x, _, v, port = _seg(64, seed=6)
    with torch.no_grad():
        before = port(t(x)).clone()
        chain_before = port.folded_chains()[0]
        assert port.folded_chains()[0] is chain_before  # cached while unchanged
        _, _, v2, other = _seg(64, seed=7)
        port.load_state_dict(other.state_dict())
        after = port(t(x))
        np.testing.assert_allclose(after.numpy(), other(t(x)).numpy(), atol=0)
        assert not torch.allclose(before, after)
        port.to(torch.float32)
        port.to("cpu")
        np.testing.assert_allclose(port(t(x)).numpy(), after.numpy(), atol=0)


def test_packed_layout_and_split():
    _, _, _, port = _seg(64, seed=8)
    chain1, chain2 = port.folded_chains()
    r4 = lambda k: -(-k // 4) * 4  # noqa: E731
    for chain in (chain1, chain2):
        w = chain.packed_widths
        size = sum(r4(w[i] * w[i + 1]) + r4(w[i + 1]) for i in range(len(w) - 1))
        assert chain.packed.numel() == size
    assert chain1.packed_widths == [14] + MLP1
    assert chain2.packed_widths == [MLP1[1]] + MLP2 + [11]
    assert chain2.w_pool.shape == (MLP1[-1], MLP2[0])
    # first packed segment of K2 is W_tap, the first C_tap rows of W0
    w_tap = chain2.packed[: MLP1[1] * MLP2[0]].reshape(MLP1[1], MLP2[0])
    torch.testing.assert_close(torch.cat([w_tap, chain2.w_pool]), chain2.weights[0], atol=0, rtol=0)


def test_wrappers_check_their_inputs():
    x, _, _, port = _seg(64, seed=9)
    chain1, chain2 = port.folded_chains()
    with pytest.raises(ValueError):
        cf.fused_pointnet_encoder(t(x[..., :13]), chain1)
    with pytest.raises(ValueError):
        cf.fused_pointnet_encoder(t(x), chain2)
    with pytest.raises(ValueError):
        cf.fused_seg_head(torch.zeros(3, 64, 8), torch.zeros(3, 64), chain2)
    with pytest.raises(ValueError):
        cf.fused_pointnet_encoder(t(x).to("meta"), chain1)


def test_training_mode_is_refused():
    x, _, _, port = _seg(64, seed=11)
    port.train()
    with pytest.raises(NotImplementedError):
        port(t(x))


"""Port of ops/chain_fused.py (kernels K1, K2) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held against the JAX fused kernels (Pallas, interpret mode on CPU) and the
unfused flax modules, with the widths and tolerance of
tests/test_chain_fused.py (atol 2e-5: f32 everywhere, the BN fold
reassociates). The CUDA kernels themselves are compared with the plain
versions on the card by chip_smoke.py.

The bf16 mode (`dtype=torch.bfloat16`) against JAX's `dtype=jnp.bfloat16`,
kernels and eager flax modules alike, at tests/_torch_port.py's bf16 limits:
|port - jax| <= 2^-8 max|jax| at any element, one bf16 step at the top of
the range, and <= 2^-15 max|jax| on average. Both sides round the same
operands; their f32 sums run in another order (MKL, Eigen, the
interpreter), which now and then moves a value across a bf16 rounding
boundary, one step of one activation. Measured: equal, or within 5e-8 of
max|jax| at any element. The f32 mode on the same inputs is held outside
those limits (the control).
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu.models.pointnet import MiniPointNet as JMini
from open3dsot_tpu.models.pointnet import SegPointNet as JSeg
from open3dsot_tpu.ops.chain_fused import fused_pointnet_encoder as j_encoder
from open3dsot_tpu.ops.chain_fused import fused_seg_head as j_head
from open3dsot_tpu_torch.models.layers import computes_in_bf16, set_compute_dtype
from open3dsot_tpu_torch.models.pointnet import MiniPointNet, SegPointNet
from open3dsot_tpu_torch.ops import chain_fused as cf
from tests._torch_port import (assert_close_bf16, assert_f32_fails_bf16, load_into, randomize,
                               t)

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


def _r8(k):
    return -(-k // 8) * 8


def _unpack(chain):
    """[(W^T hi, W^T lo, b)] per layer from the packed buffer, by the layout
    rule of csrc/chain_fused.cu::make_layout: whole chunks of CHUNK_OUT x
    CHUNK_IN channels, output-chunk major, hi then lo, each in core matrices
    of 8 x 4; W^T parts returned whole ((out chunks, in chunks) x chunk, with
    their zero padding), b as (Cp,)."""
    co, ci = cf.CHUNK_OUT, cf.CHUNK_IN
    w, off, out = chain.packed_widths, 0, []
    for k, c in zip(w[:-1], w[1:]):
        nc, nk = -(-_r8(c) // co), -(-_r8(k) // ci)
        size = nc * nk * 2 * co * ci
        parts = (chain.packed[off: off + size]
                 .reshape(nc, nk, 2, co // 8, ci // 4, 8, 4)
                 .permute(2, 0, 3, 5, 1, 4, 6).reshape(2, nc * co, nk * ci))
        out.append((parts[0], parts[1], chain.packed[off + size: off + size + _r8(c)]))
        off += size + _r8(c)
    assert off == chain.packed.numel()
    return out


def _rna_tf32_np(a):
    """numpy's own TF32 rounding (to nearest, ties away from zero) on the bits."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return (((u + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def test_packed_layout_and_split():
    _, _, _, port = _seg(64, seed=8)
    chain1, chain2 = port.folded_chains()
    co, ci = cf.CHUNK_OUT, cf.CHUNK_IN
    for chain in (chain1, chain2):
        w = chain.packed_widths
        size = sum(2 * -(-_r8(w[i + 1]) // co) * co * -(-_r8(w[i]) // ci) * ci + _r8(w[i + 1])
                   for i in range(len(w) - 1))
        assert chain.packed.numel() == size
    assert chain1.packed_widths == [14] + MLP1
    assert chain2.packed_widths == [MLP1[1]] + MLP2 + [11]
    assert chain2.w_pool.shape == (MLP1[-1], MLP2[0])
    # K2's first packed layer is W_tap, the first C_tap rows of W0, transposed
    hi, lo, _ = _unpack(chain2)[0]
    w_tap = (hi.double() + lo.double()).t()[: MLP1[1], : MLP2[0]]
    torch.testing.assert_close(torch.cat([w_tap, chain2.w_pool.double()]),
                               chain2.weights[0].double(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("which", ["seg mlp1", "seg head", "mini"])
def test_packing_unpacks_to_the_folded_weights(which):
    """Transposed (K-major), zero-padded to whole chunks, hi = tf32(W),
    lo = tf32(W - hi) bit for bit, every hi/lo word with its 13 low mantissa
    bits zero, hi + lo within 2^-22 of W, and the biases exact."""
    if which == "mini":
        _, _, _, port = _mini(48, seed=12)
        chain = port.folded_chains()
    else:
        _, _, _, port = _seg(64, seed=13)
        chain = port.folded_chains()[which == "seg head"]
    first = chain.weights[0][: chain.split] if chain.split else chain.weights[0]
    for (hi, lo, b), w, bias in zip(_unpack(chain), [first] + chain.weights[1:], chain.biases):
        k, c = w.shape
        assert hi.shape == lo.shape == (-(-c // cf.CHUNK_OUT) * cf.CHUNK_OUT,
                                        -(-k // cf.CHUNK_IN) * cf.CHUNK_IN)
        for part in (hi, lo):
            assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
            assert not part[c:].any() and not part[:, k:].any()
        wt = w.t().contiguous().numpy()
        want_hi = _rna_tf32_np(wt)
        np.testing.assert_array_equal(hi[:c, :k].numpy().view(np.uint32), want_hi.view(np.uint32))
        want_lo = _rna_tf32_np(wt - want_hi)
        np.testing.assert_array_equal(lo[:c, :k].numpy().view(np.uint32), want_lo.view(np.uint32))
        err = np.abs(wt.astype(np.float64) - hi[:c, :k].double().numpy() - lo[:c, :k].double().numpy())
        assert (err <= 2.0 ** -22 * np.abs(wt)).all()
        np.testing.assert_array_equal(b[:c].numpy(), bias.numpy())
        assert not b[c:].any()


def test_tf32_rounding_is_rna():
    """cvt.rna.tf32.f32: to nearest, ties away from zero, on the 13 dropped bits."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 2 - 2.0 ** -23,
                      1.0 + 1.5 * one_ulp, 0.0, -3.0])
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + 2 * one_ulp, 0.0, -3.0])
    torch.testing.assert_close(cf.tf32_rna(x), want, atol=0, rtol=0)
    hi, lo = cf.split_tf32(x)
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


def _layers_3xtf32(chain):
    """(W hi, W lo, b) per layer, (Kp, Cp) and (Cp,), from the packed buffer as
    the kernel reads it."""
    return [(hi[: b.numel(), : _r8(k)].t(), lo[: b.numel(), : _r8(k)].t(), b)
            for (hi, lo, b), k in zip(_unpack(chain), chain.packed_widths)]


def _dense(h, hi, lo, b, three: bool):
    """One Dense as the kernel computes it: inputs zero-padded to Kp, the
    activations split in hi/lo, f32 products; `three` False is TF32 alone."""
    h = torch.nn.functional.pad(h, (0, hi.shape[0] - h.shape[-1]))
    h_hi, h_lo = cf.split_tf32(h)
    if not three:
        return b + h_hi @ hi
    return (b + h_hi @ hi) + (h_lo @ hi + h_hi @ lo)


def _k1_emulated(x, chain, tap_at, three=True):
    h, tap, layers = x, None, _layers_3xtf32(chain)
    for i, (hi, lo, b) in enumerate(layers):
        h = torch.relu(_dense(h, hi, lo, b, three))
        if i == tap_at:
            tap = h[..., : chain.widths[i + 1]]
    return tap, h[..., : chain.widths[-1]].amax(dim=1)


def _k2_emulated(tap, pooled, chain, three=True):
    layers = _layers_3xtf32(chain)
    g = pooled @ chain.w_pool + layers[0][2]  # pool_bias_kernel: f32 on CUDA cores
    h = tap
    for i, (hi, lo, b) in enumerate(layers):
        h = _dense(h, hi, lo, g[:, None, :] if i == 0 else b, three)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h[..., : chain.widths[-1]]


def _within(got, want, tol):
    """The kernels' tolerance form: |got - want| <= tol * max|want| + tol * |want|."""
    err = (got.double() - want).abs()
    return bool((err <= tol * want.abs().max() + tol * want.abs()).all()), err.max().item()


def test_3xtf32_emulation_within_bound_of_float64():
    """The kernels' arithmetic (3xTF32 products, rna rounding, f32 sums) on a
    K1 chain with its tap and the K2 chain, held to a float64 chain within
    TOL_3XTF32, the bound chip_smoke.py holds the kernels to on the card; TF32
    alone is far from it."""
    x, _, _, port = _seg(50, seed=14)
    chain1, chain2 = port.folded_chains()
    xt = t(x)
    w64 = lambda c: [(w.double(), b.double()) for w, b in c.layers]  # noqa: E731
    h, tap64 = xt.double(), None
    for i, (w, b) in enumerate(w64(chain1)):
        h = torch.relu(h @ w + b)
        if i == 1:
            tap64 = h
    pool64 = h.amax(dim=1)
    h = torch.cat([tap64, pool64[:, None, :].expand(-1, tap64.shape[1], -1)], dim=-1)
    layers2 = w64(chain2)
    for w, b in layers2[:-1]:
        h = torch.relu(h @ w + b)
    out64 = h @ layers2[-1][0] + layers2[-1][1]

    tap, pooled = _k1_emulated(xt, chain1, 1)
    out = _k2_emulated(tap, pooled, chain2)
    errs = {}
    for name, got, want in (("tap", tap, tap64), ("pooled", pooled, pool64), ("logits", out, out64)):
        ok, errs[name] = _within(got, want, cf.TOL_3XTF32)
        assert ok, f"{name}: {errs[name]}"
    tap1, pooled1 = _k1_emulated(xt, chain1, 1, three=False)
    out1 = _k2_emulated(tap1, pooled1, chain2, three=False)
    err1 = (out1.double() - out64).abs().max().item()
    assert err1 > 100 * errs["logits"], (err1, errs)


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
    """The fused chains are eval-only: folding in training mode is refused,
    and a training forward runs the plain layers with batch statistics
    (as JAX's, whose fused chain is eval-only too)."""
    x, _, _, port = _seg(64, seed=11)
    port.train()
    with pytest.raises(NotImplementedError):
        port.folded_chains()
    plain = copy.deepcopy(port)
    plain.fused_eval = False
    torch.testing.assert_close(port(t(x)), plain(t(x)), rtol=0, atol=0)


# --- the bf16 mode ------------------------------------------------------------

BF = torch.bfloat16


def _f32(chain: cf.FoldedChain) -> cf.FoldedChain:
    """The same folded layers packed for the f32 (3xTF32) mode."""
    return cf.FoldedChain(chain.layers, split=chain.split)


@pytest.mark.parametrize("n", [64, 50])
def test_plain_k1_bf16_matches_jax_kernel(n):
    x, _, v, port = _seg(n, seed=20 + n)
    set_compute_dtype(port, BF)
    p, st = v["params"], v["batch_stats"]
    want_tap, want_pool = j_encoder(
        x, [p[f"mlp1_{i}"]["layer0"] for i in range(5)],
        [st[f"mlp1_{i}"]["layer0"] for i in range(5)], tap_at=1, dtype=jnp.bfloat16,
        interpret=True)
    chain1, _ = port.folded_chains()
    assert chain1.dtype is BF
    tap, pooled = cf.fused_pointnet_encoder(t(x), chain1, tap_at=1)
    assert tap.dtype == pooled.dtype == torch.float32  # as JAX's out_shape
    assert_close_bf16(tap, want_tap)
    assert_close_bf16(pooled, want_pool)
    f32_tap, f32_pool = cf.fused_pointnet_encoder(t(x), _f32(chain1), tap_at=1)
    assert_f32_fails_bf16(f32_tap, want_tap)
    assert_f32_fails_bf16(f32_pool, want_pool)
    # a bf16 input is the same f32 input
    _, again = cf.fused_pointnet_encoder(t(x).to(BF), chain1, tap_at=1)
    _, direct = cf.fused_pointnet_encoder(t(x).to(BF).float(), chain1, tap_at=1)
    assert torch.equal(again, direct)


@pytest.mark.parametrize("c_in", [13, 4])
def test_plain_k1_bf16_without_tap_matches_jax_kernel(c_in):
    """13 (box_aware) and 4 input channels: the kernel's first k16 step
    reaches past both (padded to 16 and 8)."""
    x, _, v, port = _mini(48, seed=30 + c_in, c_in=c_in)
    set_compute_dtype(port, BF)
    p, st = v["params"]["per_point"], v["batch_stats"]["per_point"]
    _, want = j_encoder(x, [p[f"layer{i}"] for i in range(3)],
                        [st[f"layer{i}"] for i in range(3)], tap_at=None, dtype=jnp.bfloat16,
                        interpret=True)
    _, pooled = cf.fused_pointnet_encoder(t(x), port.folded_chains())
    assert_close_bf16(pooled, want)
    assert_f32_fails_bf16(cf.fused_pointnet_encoder(t(x), _f32(port.folded_chains()))[1], want)


@pytest.mark.parametrize("n", [64, 50])
def test_plain_k2_bf16_matches_jax_kernel(n):
    x, _, v, port = _seg(n, seed=40 + n)
    set_compute_dtype(port, BF)
    p, st = v["params"], v["batch_stats"]
    rng = np.random.default_rng(n)
    tap = np.abs(rng.standard_normal((3, n, MLP1[1]))).astype(np.float32)
    pooled = np.abs(rng.standard_normal((3, MLP1[-1]))).astype(np.float32)
    want = j_head(tap, pooled, [p[f"mlp2_{i}"]["layer0"] for i in range(3)],
                  [st[f"mlp2_{i}"]["layer0"] for i in range(3)], p["fc"], dtype=jnp.bfloat16,
                  interpret=True)
    _, chain2 = port.folded_chains()
    got = cf.fused_seg_head(t(tap), t(pooled), chain2)
    assert got.dtype == torch.float32
    assert_close_bf16(got, want)
    assert_f32_fails_bf16(cf.fused_seg_head(t(tap), t(pooled), _f32(chain2)), want)


@pytest.mark.parametrize("fused_eval", [True, False])
@pytest.mark.parametrize("which", ["seg", "mini"])
def test_pointnets_match_flax_bf16(which, fused_eval):
    rng = np.random.default_rng(3 + fused_eval)
    if which == "seg":
        x = rng.standard_normal((3, 50, 14)).astype(np.float32)
        jkw = dict(per_point_mlp1=MLP1, per_point_mlp2=MLP2, output_size=11)
        v = randomize(JSeg(**jkw).init(jax.random.PRNGKey(0), x), rng)
        jm = JSeg(fused_eval=fused_eval, dtype=jnp.bfloat16, **jkw)
        port = SegPointNet(14, MLP1, MLP2, 11, fused_eval=fused_eval, dtype=BF)
    else:
        x = rng.standard_normal((3, 48, 13)).astype(np.float32)
        jkw = dict(per_point_mlp=MINI, hidden_mlp=[32, 16], output_size=-1)
        v = randomize(JMini(**jkw).init(jax.random.PRNGKey(0), x), rng)
        jm = JMini(fused_eval=fused_eval, dtype=jnp.bfloat16, **jkw)
        port = MiniPointNet(13, MINI, [32, 16], output_size=-1, fused_eval=fused_eval, dtype=BF)
    load_into(port, v)
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = port(t(x))
    # K2's logits are f32 (JAX's too); the plain bf16 stack and the hidden MLP give bf16
    assert got.dtype == (torch.float32 if which == "seg" and fused_eval else BF)
    assert got.dtype == {jnp.float32: torch.float32, jnp.bfloat16: BF}[jnp.dtype(want.dtype).type]
    assert_close_bf16(got, want)
    set_compute_dtype(port, None)
    with torch.no_grad():
        assert_f32_fails_bf16(port(t(x)), want)


def test_switching_the_mode_refolds_and_keeps_the_weights():
    """The fold caches key on the compute dtype: a net switched to bf16 and
    back never reuses the other mode's packing, and its parameters and
    statistics stay f32 throughout."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, 14)).astype(np.float32)
    jkw = dict(per_point_mlp1=MLP1, per_point_mlp2=MLP2, output_size=11)
    port = load_into(SegPointNet(14, MLP1, MLP2, 11),
                     randomize(JSeg(**jkw).init(jax.random.PRNGKey(0), x), rng))
    with torch.no_grad():
        f32 = port(t(x))
        chains = port.folded_chains()
        set_compute_dtype(port, BF)
        assert computes_in_bf16(port)
        bf = port(t(x))
        bf_chains = port.folded_chains()
        assert bf_chains[0] is not chains[0] and bf_chains[0].dtype is BF
        assert bf_chains[0].packed.numel() < chains[0].packed.numel()  # one bf16 part, not hi + lo
        set_compute_dtype(port, None)
        assert port.folded_chains()[0].dtype is None
        np.testing.assert_array_equal(port(t(x)).numpy(), f32.numpy())
    assert not torch.equal(bf, f32)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype == torch.float32 for b in port.buffers() if b.is_floating_point())




def _unpack_bf16(chain):
    """[(W^T, b)] per layer from a bf16 packed buffer (bf16 values in f32
    words), by csrc/chain_fused_bf16.cu::make_layout's rule: whole panels of
    panel_width(out) x PANEL_K channels, output-chunk major, each in core
    matrices of 8 x 8, then the bias padded to 8."""
    P = cf.PANEL_K
    w, off, out = chain.packed_widths, 0, []
    for k, c in zip(w[:-1], w[1:]):
        pw = cf.panel_width(c)
        nc, nk = -(-c // pw), -(-k // P)
        floats = nc * nk * pw * P // 2
        wt = (chain.packed[off: off + floats].contiguous().view(BF)
              .reshape(nc, nk, pw // 8, P // 8, 8, 8)
              .permute(0, 2, 4, 1, 3, 5).reshape(nc * pw, nk * P))
        out.append((wt, chain.packed[off + floats: off + floats + _r8(c)]))
        off += floats + _r8(c)
    assert off == chain.packed.numel()
    return out


@pytest.mark.parametrize("which", ["seg mlp1", "seg head", "mini"])
def test_bf16_packing_unpacks_to_the_rounded_weights(which):
    """bf16 mode: W^T rounded to bf16 (to nearest even) bit for bit,
    zero-padded to whole chunks, and the biases f32 and exact."""
    if which == "mini":
        _, _, _, port = _mini(48, seed=14)
        set_compute_dtype(port, BF)
        chain = port.folded_chains()
    else:
        _, _, _, port = _seg(64, seed=15)
        set_compute_dtype(port, BF)
        chain = port.folded_chains()[which == "seg head"]
    first = chain.weights[0][: chain.split] if chain.split else chain.weights[0]
    for (wt, b), w, bias in zip(_unpack_bf16(chain), [first] + chain.weights[1:], chain.biases):
        k, c = w.shape
        assert torch.equal(wt[:c, :k], w.t().to(BF))
        assert not wt[c:].float().any() and not wt[:, k:].float().any()
        assert torch.equal(b[:c], bias) and not b[c:].any()

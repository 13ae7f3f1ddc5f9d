"""The bf16 modes of K1/K2 (csrc/chain_fused_bf16.cu) and K4/K5
(csrc/sa_fused_bf16.cu): what the CPU can check of kernels that run only on
the card.

An emulation of each kernel's arithmetic in torch (bf16 operands, each
product's whole K summed before one rounding to f32, h1 and h2 rounded to bf16
where the kernels store them, layer 3 rounded before the max over K, the tap
and the pool in f32 from the unrounded ReLU, K2's pooled rows summed apart as
pool_bias_kernel sums them) is held to the plain bf16 versions (which
tests/test_torch_chain_fused.py and tests/test_torch_sa_fused.py hold to
JAX's bf16 kernels) within chip_smoke.py phase 18's limits, with the plain
f32 version on the same inputs outside them. The wrappers' routing of the
bf16 mode to the new entries is checked with a stand-in library.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bf16_kernels.py -q
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from open3dsot_tpu_torch.ops import _build
from open3dsot_tpu_torch.ops import chain_fused as cf
from open3dsot_tpu_torch.ops import sa_fused as saf
from open3dsot_tpu_torch.ops.grouping import group_points
from open3dsot_tpu_torch.ops.neighbors import ball_query

BF = torch.bfloat16
# chip_smoke.py phase 18's limits of a bf16 kernel against its plain bf16
# version: max |k - p| <= 2^-6 max|p|, mean |k - p| <= 2^-14 max|p|
MAX_REL, MEAN_REL = 2.0 ** -6, 2.0 ** -14


def _r(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF).float()


def _sum(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w with bf16 operands, the whole K summed before one rounding to
    f32 (the tensor cores' f32 accumulators over 64-input k-blocks)."""
    return (_r(h).double() @ _r(w).double()).float()


def _layers(widths, rng):
    return [(torch.from_numpy((rng.standard_normal((k, c)) * (2.0 / k) ** 0.5).astype(np.float32)),
             torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32)))
            for k, c in zip(widths[:-1], widths[1:])]


def _within(got, want, f32) -> None:
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= MAX_REL * scale and err.mean().item() <= MEAN_REL * scale, \
        (err.max().item() / scale, err.mean().item() / scale)
    ctl = (f32.float() - want.float()).abs()
    assert ctl.max().item() > MAX_REL * scale or ctl.mean().item() > MEAN_REL * scale, \
        "the f32 control is inside the bf16 limits"


# --- K4/K5 ------------------------------------------------------------------------

def _k4_emulated(xyz, feats, new, idx, folded, radius, normalize_xyz, use_xyz):
    """sa_fused_bf16.cu's arithmetic: h1 = bf16(relu(bf16(A)[idx] + ct)) as
    the gather forms it, h2 = bf16(relu(h1 W2 + b2)), each layer-3 chunk
    staged as bf16(relu(h2 W3 + b3)), the max over K of those bf16 values."""
    (w1, b1), (w2, b2), (w3, b3) = folded
    a, ct = saf.a_form(xyz, None if feats is None else feats.float(), new, w1, b1,
                       inv_r=1.0 / radius if normalize_xyz else 1.0, use_xyz=use_xyz)
    h1 = _r(torch.relu(group_points(_r(a), idx) + ct[:, :, None, :]))
    h2 = _r(torch.relu(_sum(h1, w2) + b2))
    return _r(torch.relu(_sum(h2, w3) + b3)).amax(dim=2).to(BF)


# the shipped widths' shapes, widths not multiples of 8, and widths where the
# kernel's tiles stop fitting in shared memory (its fallback plans)
@pytest.mark.parametrize("widths,k", [((16, 16, 24), 8), ((64, 64, 128), 16), ((24, 36, 68), 20),
                                      ((640, 640, 640), 64), ((8, 1376, 68), 64)])
def test_k4_bf16_emulation_within_bf16_limits_of_plain(widths, k):
    rng = np.random.default_rng(40 + k)
    B, N, S, C = 2, 160, 37, 21
    xyz = torch.from_numpy(rng.uniform(0, 1, (B, N, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).relu().to(BF)
    new = xyz[:, :S].contiguous()
    layers = _layers((3 + C,) + widths, rng)
    folded = saf.FoldedSA(layers, dtype=BF)
    kw = dict(radius=0.3, normalize_xyz=False, use_xyz=True)
    idx = ball_query(0.3, k, xyz, new)
    want = saf.sa_eval_plain(xyz, feats, new, idx, folded, dtype=BF, **kw)
    got = _k4_emulated(xyz, feats, new, idx, folded, **kw)
    assert got.dtype == BF and got.shape == (B, S, widths[-1])
    _within(got, want, saf.sa_eval_plain(xyz, feats, new, idx, saf.FoldedSA(layers), **kw))


def test_earlier_sa_plan_reference_matches_its_shared_memory():
    """chip_smoke.py's reference for which SA shapes the earlier bf16 K4 planned
    (the plan sweep holds the new plan to every one): 640/640/640 and
    768/768/768 at K = 64 fit (201664 and 226736 bytes with 4 and 3 chunk
    stages), 832 does not; C1 had to be a multiple of 8; at C1 = 8, K = 64
    the widest C2 was 1376."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fits = smoke.earlier_sa_bf16_fits
    assert fits(64, 640, 640) and fits(64, 768, 768) and not fits(64, 832, 832)
    assert not fits(64, 36, 36) and fits(64, 40, 36)
    assert max(c for c in range(4, 2049, 4) if fits(64, 8, c)) == 1376


# --- K1/K2 ------------------------------------------------------------------------

def _k1_emulated(x, chain, tap_at):
    """chain_fused_bf16.cu's K1: the input rounded as it is loaded, each layer
    bf16 operands and a whole-K f32 sum, + b, ReLU; the tap and the pool from
    the f32 value, the next layer's input its bf16 rounding."""
    h, tap = _r(x), None
    for i, (w, b) in enumerate(chain.layers):
        y = torch.relu(_sum(h, w) + b)
        tap = y if i == tap_at else tap
        h = _r(y)
    return tap, y.amax(dim=1)


def _k2_emulated(tap, pooled, chain):
    """K2: g = bf16(pooled) bf16(W_pool) + b'_0 (pool_bias_kernel, f32 sums),
    relu(bf16(tap) W_tap + g) per point, the chain, the plain head (f32)."""
    (w0, b0), s = chain.layers[0], chain.split
    g = _sum(pooled, w0[s:]) + b0
    h = _r(torch.relu(_sum(tap, w0[:s]) + g[:, None, :]))
    for w, b in chain.layers[1:-1]:
        h = _r(torch.relu(_sum(h, w) + b))
    w, b = chain.layers[-1]
    return _sum(h, w) + b


# M2's chains at small widths: seg mlp1 with its tap, the mini PointNet, and
# the seg head on the seg mlp1's tap and pool
SEG1, MINI = (14, 32, 32, 64, 256), (13, 32, 64, 128, 256)
SEG2 = (32 + 256, 128, 64, 32, 32, 11)


@pytest.mark.parametrize("n", [300, 2 * 64])
def test_k1_k2_bf16_emulation_within_bf16_limits_of_plain(n):
    rng = np.random.default_rng(50 + n)
    layers1, layers2, layersm = _layers(SEG1, rng), _layers(SEG2, rng), _layers(MINI, rng)
    c1, c2, cm = (cf.FoldedChain(layers1, dtype=BF), cf.FoldedChain(layers2, split=32, dtype=BF),
                  cf.FoldedChain(layersm, dtype=BF))
    f1, f2, fm = (cf.FoldedChain(layers1), cf.FoldedChain(layers2, split=32),
                  cf.FoldedChain(layersm))
    x = torch.from_numpy(rng.standard_normal((3, n, 14)).astype(np.float32))
    xm = torch.from_numpy(rng.standard_normal((3, n, 13)).astype(np.float32))
    tap, pooled = _k1_emulated(x, c1, 0)
    p_tap, p_pool = cf.pointnet_encoder_plain(x, c1, 0)
    f_tap, f_pool = cf.pointnet_encoder_plain(x, f1, 0)
    _within(tap, p_tap, f_tap)
    _within(pooled, p_pool, f_pool)
    _, m_pool = _k1_emulated(xm, cm, None)
    _within(m_pool, cf.pointnet_encoder_plain(xm, cm)[1], cf.pointnet_encoder_plain(xm, fm)[1])
    logits = _k2_emulated(p_tap, p_pool, c2)
    want = cf.seg_head_plain(p_tap, p_pool, c2)
    _within(logits, want, cf.seg_head_plain(p_tap, p_pool, f2))
    agree = (logits[..., :2].argmax(-1) == want[..., :2].argmax(-1)).float().mean().item()
    assert agree > 0.99, agree


# --- the wrappers route the bf16 mode to the new entries ---------------------------

class _Lib:
    """A stand-in for a built library: records each entry's call, returns 0."""

    def __init__(self, name):
        self.name, self.calls = name, []
        for fn in _build.SIGNATURES[name]:
            setattr(self, fn, self._entry(fn))

    def _entry(self, fn):
        def call(*args):
            self.calls.append((fn, args))
            return 0
        call.__name__ = fn
        return call


@pytest.fixture
def stand_in(monkeypatch):
    libs = {}

    def load_library(name):
        libs.setdefault(name, SimpleNamespace(lib=_Lib(name)))
        return libs[name]

    monkeypatch.setattr(_build, "load_library", load_library)
    monkeypatch.setattr(saf, "stream_of", lambda t: 0)
    monkeypatch.setattr(cf, "stream_of", lambda t: 0)
    return libs


@pytest.mark.parametrize("bf16", [True, False])
def test_wrappers_launch_the_entries_of_their_mode(stand_in, bf16):
    """K4 and K1/K2 in the bf16 mode call sa_fused_bf16 / chain_fused_bf16's
    entries with as many arguments as their signatures (no gather, no mode
    flag) and the f32 A rows; the 3xTF32 mode its own library's."""
    rng = np.random.default_rng(60)
    dtype = BF if bf16 else None
    xyz = torch.from_numpy(rng.uniform(0, 1, (2, 64, 3)).astype(np.float32))
    new = xyz[:, :16].contiguous()
    folded = saf.FoldedSA(_layers((3, 16, 16, 24), rng), dtype=dtype)
    saf._launch(xyz, None, new, None, folded, saf.pack_sa(folded, dtype), radius=0.3,
                normalize_xyz=False, use_xyz=True, K=8, gather=-1, bf16=bf16)
    chain = cf.FoldedChain(_layers((14, 32, 64), rng), dtype=dtype)
    x = torch.from_numpy(rng.standard_normal((2, 50, 14)).astype(np.float32))
    cf._k1_cuda(x, chain.packed, chain.weights, chain.biases, chain.packed_widths, 0, bf16)
    head = cf.FoldedChain(_layers((32 + 64, 32, 11), rng), split=32, dtype=dtype)
    cf._k2_cuda(torch.zeros(2, 50, 32), torch.zeros(2, 64), head.packed, head.w_pool,
                head.weights, head.biases, head.packed_widths, bf16)
    sa, ch = ("sa_fused_bf16", "chain_fused_bf16") if bf16 else ("sa_fused", "chain_fused")
    assert set(stand_in) == {sa, ch}
    for name in (sa, ch):
        for fn, args in stand_in[name].lib.calls:
            sig = _build.SIGNATURES[name][fn]
            assert len(args) == len(sig[0] if isinstance(sig, tuple) else sig), fn
    assert [fn for fn, _ in stand_in[ch].lib.calls] == (
        ["chain_fused_bf16_workspace", "chain_fused_k1_bf16", "chain_fused_bf16_workspace",
         "chain_fused_k2_bf16"] if bf16 else
        ["chain_fused_workspace", "chain_fused_k1", "chain_fused_workspace", "chain_fused_k2"])


def test_bf16_mode_takes_no_gather_form():
    rng = np.random.default_rng(61)
    xyz = torch.from_numpy(rng.uniform(0, 1, (2, 64, 3)).astype(np.float32))
    folded = saf.FoldedSA(_layers((3, 16, 16, 24), rng), dtype=BF)
    with pytest.raises(ValueError, match="one gather form"):
        saf.fused_sa_apply(xyz, None, xyz[:, :16].contiguous(), None, folded, nsample=8,
                           radius=0.3, normalize_xyz=False, use_xyz=True, gather="ldg")


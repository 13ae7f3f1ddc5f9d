"""The port's fused SA (ops/sa_fused.py, kernels K4/K5) and SetAbstraction
against the JAX package, at the small widths of tests/test_sa_fused.py
(B 2, N 64, S 16, K 8).

On the CPU the wrapper runs its plain version `sa_eval_plain`; it is held
against the JAX fused kernel (Pallas, interpret mode on CPU) and the
unfused flax SetAbstraction at atol 1e-4, the tolerance of
tests/test_sa_fused.py: f32 throughout, the BN fold and the A-form
reassociate. The CUDA kernels are held to the plain version on the card by
chip_smoke.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from open3dsot_tpu.models.pointnet import SetAbstraction as JSA
from open3dsot_tpu.ops import ball_query as j_ball_query
from open3dsot_tpu.ops.sa_fused import a_form as j_a_form
from open3dsot_tpu.ops.sa_fused import fold_dense_bn as j_fold
from open3dsot_tpu.ops.sa_fused import fused_sa_apply as j_fused_sa_apply
from open3dsot_tpu_torch.models.pointnet import SetAbstraction
from open3dsot_tpu_torch.ops import sa_fused
from open3dsot_tpu_torch.ops.neighbors import ball_query
from tests._torch_port import load_into, randomize, t

ATOL = 1e-4
B, N, S, K, C = 2, 64, 16, 8, 12
MLP = [16, 16, 24]


def _setup(seed, with_features=True, normalize_xyz=False, n=N, s=S, k=K, mlp=MLP,
           radius=0.8, use_fps=False):
    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((B, n, 3)).astype(np.float32)
    feats = rng.standard_normal((B, n, C)).astype(np.float32) if with_features else None
    kw = dict(mlp=mlp, radius=radius, nsample=k, use_fps=use_fps, normalize_xyz=normalize_xyz)
    jsa = JSA(**kw)
    v = randomize(jsa.init(jax.random.PRNGKey(0), xyz, feats, s, train=False), rng)
    port = load_into(SetAbstraction(C if with_features else 0, mlp, radius, k, use_fps=use_fps,
                                    normalize_xyz=normalize_xyz), v)
    return xyz, feats, jsa, v, port


def _mlp(v):
    return v["params"]["mlp_shared"], v["batch_stats"]["mlp_shared"]


@pytest.mark.parametrize("with_features", [False, True])
@pytest.mark.parametrize("normalize_xyz", [False, True])
def test_plain_matches_jax_kernel(with_features, normalize_xyz):
    xyz, feats, _, v, port = _setup(0, with_features, normalize_xyz)
    new_xyz = xyz[:, :S]
    kw = dict(radius=0.8, normalize_xyz=normalize_xyz, use_xyz=True)
    want = j_fused_sa_apply(xyz, feats, new_xyz, None, *_mlp(v), nsample=K, interpret=True, **kw)
    f = None if feats is None else t(feats)
    got = sa_fused.fused_sa_apply(t(xyz), f, t(new_xyz), None, port.folded_chains(),
                                  nsample=K, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    plain = sa_fused.sa_eval_plain(t(xyz), f, t(new_xyz), None, port.folded_chains(),
                                   nsample=K, **kw)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_ragged_centroid_count_matches_jax_kernel():
    """S = 11: no tile divides it (the kernel masks the last tile)."""
    xyz, feats, _, v, port = _setup(1, n=48, s=11, k=4, mlp=[8, 8, 8], radius=1.5)
    new_xyz = xyz[:, :11]
    kw = dict(radius=1.5, normalize_xyz=False, use_xyz=True)
    want = j_fused_sa_apply(xyz, feats, new_xyz, None, *_mlp(v), nsample=4, interpret=True, **kw)
    got = sa_fused.fused_sa_apply(t(xyz), t(feats), t(new_xyz), None, port.folded_chains(),
                                  nsample=4, **kw)
    assert got.shape == (B, 11, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_idx_mode_matches_bq_mode_and_jax_idx_kernel():
    xyz, feats, _, v, port = _setup(4)
    new_xyz = xyz[:, :S]
    kw = dict(radius=0.8, normalize_xyz=False, use_xyz=True)
    idx = ball_query(0.8, K, t(xyz), t(new_xyz))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_ball_query(0.8, K, xyz, new_xyz)))
    folded = port.folded_chains()
    by_idx = sa_fused.fused_sa_apply(t(xyz), t(feats), t(new_xyz), idx, folded, **kw)
    by_bq = sa_fused.fused_sa_apply(t(xyz), t(feats), t(new_xyz), None, folded, nsample=K, **kw)
    np.testing.assert_array_equal(by_idx.numpy(), by_bq.numpy())
    want = j_fused_sa_apply(xyz, feats, new_xyz, idx.numpy(), *_mlp(v), interpret=True, **kw)
    np.testing.assert_allclose(by_idx.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("use_xyz", [True, False])
def test_a_form_matches_jax(use_xyz):
    xyz, feats, _, v, port = _setup(5)
    w1, b1 = port.folded_chains()[0]
    jw1, jb1 = j_fold(v["params"]["mlp_shared"]["layer0"], v["batch_stats"]["mlp_shared"]["layer0"])
    np.testing.assert_allclose(w1.numpy(), np.asarray(jw1), rtol=1e-6, atol=1e-6)
    if not use_xyz:  # layer 1 then reads the features only
        w1, jw1 = w1[3:], np.asarray(jw1)[3:]
    a, ct = sa_fused.a_form(t(xyz), t(feats), t(xyz[:, :S]), w1, b1, inv_r=1.25, use_xyz=use_xyz)
    ja, jct = j_a_form(xyz, feats, xyz[:, :S], jw1, jb1, inv_r=1.25, use_xyz=use_xyz)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(jct), atol=ATOL)


@pytest.mark.parametrize("fused_eval", [True, False])
@pytest.mark.parametrize("with_features,use_fps", [(True, False), (False, True)])
def test_set_abstraction_matches_unfused_flax(fused_eval, with_features, use_fps):
    xyz, feats, jsa, v, port = _setup(2, with_features, use_fps=use_fps)
    port.fused_eval = fused_eval
    want_xyz, want, want_idx = jsa.apply(v, xyz, feats, S, train=False)
    with torch.no_grad():
        got_xyz, got, got_idx = port(t(xyz), None if feats is None else t(feats), S)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(want_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_checks_and_counts():
    xyz, feats, _, _, port = _setup(6)
    folded = port.folded_chains()
    kw = dict(radius=0.8, normalize_xyz=False, use_xyz=True)
    sa_fused.reset_launch_counts()
    sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded, nsample=K, **kw)
    assert (sa_fused.fused_sa_apply.launches, sa_fused.fused_sa_apply.idx_launches) == (0, 0)
    with pytest.raises(ValueError, match="nsample"):
        sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded, **kw)
    with pytest.raises(ValueError, match="3 folded layers"):
        sa_fused.fused_sa_apply(t(xyz), t(feats), t(xyz[:, :S]), None, folded[:2], nsample=K, **kw)
    with pytest.raises(ValueError):
        sa_fused.fused_sa_apply(t(xyz).to("meta"), None, t(xyz[:, :S]).to("meta"), None,
                                folded, nsample=K, **kw)
    port.train()
    with pytest.raises(NotImplementedError):
        port(t(xyz), t(feats), S)

"""The port's whole M2TrackNet eval forward against the flax one, with the
JAX side's fused chain both off and on (same weights, same inputs). The
weights are weights.random_variables: He-normal Dense kernels and
non-trivial BatchNorm statistics, made with numpy from a seed in the JAX
tree's shape.

Tolerance atol 5e-4 on every output key, as tests/test_chain_fused.py uses
for fused-vs-unfused M2: the BN fold reassociates in f32, and the boxes
pass through the pooled max and two argmax gates.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from open3dsot_tpu.config import make_config
from open3dsot_tpu.models import get_model as jax_get_model
from open3dsot_tpu_torch.config import make_config as port_make_config
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.models.layers import set_compute_dtype
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

ATOL = 5e-4


def _cfg(pss, **kw):
    return dict(dict(net_model="m2track", box_aware=True, point_sample_size=pss,
                     degrees=False, use_z=True, limit_box=False, motion_threshold=0.15), **kw)


def _compare(pss, batch_size, jax_fused, seed, port_fused=True, **kw):
    rng = np.random.default_rng(seed)
    jm = jax_get_model("m2track")(make_config(_cfg(pss, fused_chain=jax_fused, **kw)))
    port = get_model("m2track")(port_make_config(_cfg(pss, **kw)), device="cpu",
                                fused_eval=port_fused)
    variables = random_variables(port.net, seed)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = {
        "points": rng.standard_normal((batch_size, 2 * pss, 5)).astype(np.float32),
        "candidate_bc": np.abs(rng.standard_normal((batch_size, 2 * pss, 9))).astype(np.float32),
    }
    want = jm.apply(variables, batch, train=False)
    got = port.apply(batch)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("jax_fused", [False, True])
def test_m2_forward_matches_flax(jax_fused):
    _compare(pss=32, batch_size=2, jax_fused=jax_fused, seed=0)


@pytest.mark.parametrize("jax_fused", [False, True])
def test_m2_plain_forward_matches_flax(jax_fused):
    """fused_eval=False: the plain layer stack the kernels are held against."""
    _compare(pss=32, batch_size=2, jax_fused=jax_fused, seed=1, port_fused=False)


@pytest.mark.parametrize("flags", [dict(box_aware=False),
                                   dict(use_motion_cls=False, use_second_stage=False,
                                        use_prev_refinement=False)])
def test_m2_forward_matches_flax_other_heads(flags):
    _compare(pss=32, batch_size=2, jax_fused=False, seed=2, **flags)


def test_m2_forward_full_width_b1():
    """point_sample_size 1024 (N = 2048), the main path's width."""
    _compare(pss=1024, batch_size=1, jax_fused=False, seed=3)


def test_dummy_batch_runs():
    port = get_model("m2track")(port_make_config(_cfg(16)), device="cpu")
    out = port.apply(port.dummy_batch(3))
    assert out["estimation_boxes"].shape == (3, 4)
    assert out["seg_logits"].shape == (3, 32, 2)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_bf16_is_refused():
    """`bf16: true` (JAX m2track.py:266) is no longer refused: the port's
    forward computes in bf16, f32 out, and its seg logits (K1/K2 in their bf16
    mode) match the flax model's with fused_chain on within 2^-5 of their
    largest at any point and 2^-8 of it on average, and its seg mask on > 97%
    of points (tests/test_bf16.py's rule). Both round at the same places, but
    the f32 sums run in another order; at M2's widths (sums over up to 1088
    inputs, nine layers) that moves some activations across a bf16 rounding
    boundary, and each such step spreads through the layers after it:
    measured 2^-6.9 of the largest logit at most, 2^-9.3 on average. The
    control: the same net in f32 sits 2^-7.1 from JAX bf16 on average,
    outside the limits.
    tests/test_torch_bf16.py holds the boxes. What remains refused under bf16
    is online serving."""
    from open3dsot_tpu_torch.tracking.online import make_online_tracker

    pcfg = port_make_config(_cfg(16, bf16=True))
    port = get_model("m2track")(pcfg, device="cpu")
    variables = random_variables(port.net, 4)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    rng = np.random.default_rng(4)
    batch = {"points": rng.standard_normal((2, 32, 5)).astype(np.float32),
             "candidate_bc": np.abs(rng.standard_normal((2, 32, 9))).astype(np.float32)}
    want = jax_get_model("m2track")(make_config(_cfg(16, bf16=True, fused_chain=True))).apply(
        variables, batch, train=False)
    got = port.apply(batch)
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in got.values())
    w = np.asarray(want["seg_logits"], np.float32)
    scale = np.abs(w).max()

    def within(logits):
        err = np.abs(logits.numpy() - w)
        return err.max() <= 2.0 ** -5 * scale and err.mean() <= 2.0 ** -8 * scale

    assert within(got["seg_logits"])
    assert (got["seg_logits"].numpy().argmax(-1) == w.argmax(-1)).mean() > 0.97
    set_compute_dtype(port.net, None)
    assert not within(port.apply(batch)["seg_logits"])  # the control: f32 is outside
    set_compute_dtype(port.net, torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, section 2, bf16 item 4"):
        make_online_tracker(port, pcfg, max_streams=2, max_points=64)

"""The port's BAT and P2B eval forwards against the flax ones, with the JAX
side's fused SA kernel off and on (interpret mode on CPU), on the same
weights and inputs. The weights are weights.random_variables (He-normal
Dense kernels, non-trivial BatchNorm statistics, made with numpy from a
seed in the JAX tree's shape); the JAX forward is jitted (an eager flax
forward compiles op by op and takes many times longer).

Tolerance atol 5e-4 on every output key, as tests/test_torch_m2track.py:
the BN fold and the A-form reassociate in f32, and the boxes pass through
three SA layers, the xcorr and the vote aggregation. `sample_idxs` (FPS)
are equal.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from open3dsot_tpu.config import load_config
from open3dsot_tpu.models import get_model as jax_get_model
from open3dsot_tpu_torch.config import load_config as port_load_config
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax

ATOL = 5e-4
SYNTHETIC = {"bat": "cfgs/BAT_synthetic.yaml", "p2b": "cfgs/P2B_synthetic.yaml"}


def _batch(name, cfg, batch_size, seed):
    rng = np.random.default_rng(seed)
    batch = {
        "template_points": rng.standard_normal((batch_size, cfg.template_size, 3)).astype(np.float32),
        "search_points": rng.standard_normal((batch_size, cfg.search_size, 3)).astype(np.float32),
    }
    if name == "bat":
        batch["points2cc_dist_t"] = np.abs(
            rng.standard_normal((batch_size, cfg.template_size, 9))).astype(np.float32)
    return batch


def _compare(name, cfg_path, batch_size, jax_fused, seed, port_fused=True, **over):
    over = dict(over, dataset="synthetic")
    pcfg = port_load_config(cfg_path, over)
    jm = jax_get_model(name)(load_config(cfg_path, dict(over, fused_sa=jax_fused)))
    port = get_model(name)(pcfg, device="cpu", fused_eval=port_fused)
    variables = random_variables(port.net, seed)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = _batch(name, pcfg, batch_size, seed)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)
    got = port.apply(batch)
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        if k == "sample_idxs":
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        else:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32),
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("jax_fused", [False, True])
@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_forward_matches_flax(name, jax_fused):
    _compare(name, SYNTHETIC[name], batch_size=2, jax_fused=jax_fused, seed=0)


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_plain_forward_matches_flax(name):
    """fused_eval=False: the plain forward the kernels are held against."""
    _compare(name, SYNTHETIC[name], batch_size=2, jax_fused=False, seed=1, port_fused=False)


def test_bat_forward_other_flags_matches_flax():
    _compare("bat", SYNTHETIC["bat"], batch_size=2, jax_fused=False, seed=2, use_search_bc=True,
             use_search_feature=True, normalize_xyz=True)


def test_bat_forward_full_width_b1():
    """cfgs/BAT_Car.yaml: template 512, search 1024, every channel 256."""
    _compare("bat", "cfgs/BAT_Car.yaml", batch_size=1, jax_fused=False, seed=3)


def _flat_keys(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat_keys(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_state_dict_keys_match_the_flax_tree(name):
    """Every flax leaf has its tensor in the port, of the same shape, and no more."""
    cfg = dict(dataset="synthetic")
    jm = jax_get_model(name)(load_config(SYNTHETIC[name], cfg))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jm.dummy_batch(1))
    fake = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = state_dict_from_jax(fake)
    port = get_model(name)(port_load_config(SYNTHETIC[name], cfg), device="cpu")
    got = port.net.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k


@pytest.mark.parametrize("name", ["bat", "p2b"])
def test_dummy_batch_runs(name):
    port = get_model(name)(port_load_config(SYNTHETIC[name], dict(dataset="synthetic")),
                           device="cpu")
    out = port.apply(port.dummy_batch(2))
    cfg = port.config
    assert out["estimation_boxes"].shape == (2, cfg.num_proposal, 5)
    assert out["estimation_cla"].shape == (2, cfg.search_size // 8)
    assert out["sample_idxs"].shape == (2, cfg.search_size // 2)
    assert all(torch.isfinite(v).all() for v in out.values())

"""The weight bridge (open3dsot_tpu_torch/weights.py): JAX init -> numpy ->
state_dict_from_jax -> load_state_dict(strict=True), every tensor equal."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from open3dsot_tpu.config import make_config
from open3dsot_tpu.models import get_model as jax_get_model
from open3dsot_tpu_torch.config import make_config as port_make_config
from open3dsot_tpu_torch.models import get_model
from open3dsot_tpu_torch.weights import random_variables, state_dict_from_jax
from tests._torch_port import to_numpy

_CFG = dict(net_model="m2track", point_sample_size=32, degrees=False, use_z=True,
            limit_box=False, motion_threshold=0.15)


def _pair(**kw):
    cfg = dict(_CFG, **kw)
    jm = jax_get_model("m2track")(make_config(cfg))
    variables = to_numpy(jm.init(jax.random.PRNGKey(0), jm.dummy_batch(2)))
    port = get_model("m2track")(port_make_config(cfg), device="cpu")
    return variables, port


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("box_aware", [True, False])
def test_jax_init_round_trip_is_exact(box_aware):
    variables, port = _pair(box_aware=box_aware)
    port.net.load_state_dict(state_dict_from_jax(variables), strict=True)
    sd = port.net.state_dict()
    seen = set()
    for path, a in _flat(variables["params"]):
        *mod, leaf = path
        name = ".".join(mod + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)])
        want = a.T if leaf == "kernel" else a
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)
        seen.add(name)
    for path, a in _flat(variables["batch_stats"]):
        *mod, leaf = path
        name = ".".join(mod + ["running_" + leaf])
        np.testing.assert_array_equal(sd[name].numpy(), a, err_msg=name)
        seen.add(name)
        assert int(sd[".".join(mod + ["num_batches_tracked"])]) == 0
    assert seen == {k for k in sd if not k.endswith("num_batches_tracked")}


def test_flax_names_in_the_port():
    _, port = _pair(box_aware=True)
    keys = set(port.net.state_dict())
    for k in ("seg_pointnet.mlp1_0.layer0.dense.weight",
              "seg_pointnet.mlp1_0.layer0.bn.running_mean",
              "seg_pointnet.fc.weight",
              "mini_pointnet.per_point.layer3.dense.weight",
              "mini_pointnet2.hidden.layer1.bn.running_var",
              "motion_mlp.layer2.dense.bias"):
        assert k in keys, k
    assert "motion_mlp.layer2.bn.weight" not in keys  # final_plain: bare Dense


@pytest.mark.parametrize("box_aware", [True, False])
def test_random_variables_have_the_jax_tree_shape(box_aware):
    variables, port = _pair(box_aware=box_aware)
    rnd = random_variables(port.net, seed=3)
    for col in ("params", "batch_stats"):
        want = {p: a.shape for p, a in _flat(variables[col])}
        got = {p: a.shape for p, a in _flat(rnd[col])}
        assert got == want
    port.net.load_state_dict(state_dict_from_jax(rnd), strict=True)


def test_random_variables_follow_the_seed():
    _, port = _pair(box_aware=True)
    a = dict(_flat(random_variables(port.net, seed=1)["params"]))
    b = dict(_flat(random_variables(port.net, seed=1)["params"]))
    c = dict(_flat(random_variables(port.net, seed=2)["params"]))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a)
    for v in a.values():
        assert v.dtype == np.float32 and np.all(np.isfinite(v))
    assert all(isinstance(x, torch.Tensor) for x in state_dict_from_jax(
        random_variables(port.net, seed=1)).values())

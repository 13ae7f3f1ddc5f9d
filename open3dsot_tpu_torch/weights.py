"""Weights between the JAX package's variable tree and the port's modules.

The port's modules carry the flax module names (`seg_pointnet.mlp1_0.layer0
.dense`, `...bn`, `motion_mlp.layer{i}`), so the map is by name, and the
only transform is the Dense kernel (in, out) -> torch Linear weight
(out, in). Leaves map as:

    params/.../dense/kernel    -> .../dense.weight (transposed)
    params/.../{dense,fc}/bias -> .../bias
    params/.../bn/scale        -> .../bn.weight
    params/.../bn/bias         -> .../bn.bias
    batch_stats/.../bn/mean    -> .../bn.running_mean
    batch_stats/.../bn/var     -> .../bn.running_var

and each BatchNorm gets `num_batches_tracked` = 0, which torch keeps and
flax does not. The tree holds numpy arrays: a caller with JAX converts with
`jax.tree_util.tree_map(np.asarray, variables)`.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict or flax FrozenDict
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} tree of numpy arrays -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _flatten(variables["params"]):
        *mod, leaf = path
        a = np.asarray(a, np.float32)
        if leaf == "kernel":
            a = a.T
        sd[".".join(mod + [_PARAM_LEAF[leaf]])] = torch.from_numpy(np.array(a, order="C"))
    for path, a in _flatten(variables.get("batch_stats", {})):
        *mod, leaf = path
        sd[".".join(mod + [_STAT_LEAF[leaf]])] = torch.from_numpy(np.asarray(a, np.float32).copy())
        sd[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0, dtype=torch.long)
    return sd


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def variables_of(net: nn.Module) -> dict:
    """The port's weights as the JAX package's `{'params', 'batch_stats'}`
    numpy tree (float32): the inverse of `state_dict_from_jax`, which drops
    only `num_batches_tracked`."""
    params, stats = {}, {}

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy().copy()

    for name, mod in net.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, nn.Linear):
            _put(params, path + ["kernel"], np.ascontiguousarray(leaf(mod.weight).T))
            _put(params, path + ["bias"], leaf(mod.bias))
        elif isinstance(mod, nn.BatchNorm1d):
            _put(params, path + ["scale"], leaf(mod.weight))
            _put(params, path + ["bias"], leaf(mod.bias))
            _put(stats, path + ["mean"], leaf(mod.running_mean))
            _put(stats, path + ["var"], leaf(mod.running_var))
    return {"params": params, "batch_stats": stats}


def random_variables(net: nn.Module, seed: int) -> dict:
    """Random eval weights in the JAX tree's shape, made with numpy from `seed`.

    Dense kernels are He-normal (fan in), biases and BatchNorm affine terms
    small normals, running variances in [0.5, 1.5]: every BatchNorm folds to
    something other than the identity.
    """
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, mod in net.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, nn.Linear):
            fan_in, fan_out = mod.in_features, mod.out_features
            _put(params, path + ["kernel"],
                 (rng.standard_normal((fan_in, fan_out)) * np.sqrt(2.0 / fan_in)).astype(np.float32))
            _put(params, path + ["bias"], (rng.standard_normal(fan_out) * 0.05).astype(np.float32))
        elif isinstance(mod, nn.BatchNorm1d):
            c = mod.num_features
            _put(params, path + ["scale"], (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32))
            _put(params, path + ["bias"], (0.1 * rng.standard_normal(c)).astype(np.float32))
            _put(stats, path + ["mean"], (0.1 * rng.standard_normal(c)).astype(np.float32))
            _put(stats, path + ["var"], rng.uniform(0.5, 1.5, c).astype(np.float32))
    return {"params": params, "batch_stats": stats}

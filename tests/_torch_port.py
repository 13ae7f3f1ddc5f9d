"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and the port, as numpy arrays.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from open3dsot_tpu_torch.weights import state_dict_from_jax

# six xdist workers share the host
torch.set_num_threads(1)


def to_numpy(variables) -> dict:
    return jax.tree_util.tree_map(np.asarray, variables)


def randomize(variables, rng) -> dict:
    """Perturb a flax init so that every BatchNorm folds to a non-identity
    (the same recipe as tests/test_chain_fused.py)."""
    def rand(x):
        return x + np.asarray(rng.standard_normal(x.shape), x.dtype) * 0.3

    v = to_numpy(variables)
    return {
        "params": jax.tree_util.tree_map(rand, v["params"]),
        "batch_stats": jax.tree_util.tree_map(lambda x: np.abs(rand(x)) + 0.5, v["batch_stats"]),
    }


def load_into(module: torch.nn.Module, variables) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

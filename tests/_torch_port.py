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


# The bf16 mode of a kernel or module against JAX's, relative to max|jax|:
# at most one bf16 step (2^-8) at any element, for a rounding boundary
# crossed by another f32 sum order, and at most 2^-15 on average. The port
# and JAX round the same operands, so they are equal or a few such steps
# apart (measured: at most 5e-8 on average). The f32 mode on the same
# inputs sits 2^-13.1 to 2^-9.2 away on average (measured): every test that
# holds a bf16 result to these limits also holds the f32 mode outside them.
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -8, 2.0 ** -15


def bf16_errors(got, want) -> tuple:
    """(max, mean) of |got - want| over max|want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err, scale = np.abs(got - want), np.abs(want).max()
    return float(err.max() / scale), float(err.mean() / scale)


def assert_close_bf16(got, want) -> None:
    worst, mean = bf16_errors(got, want)
    assert worst <= BF16_MAX_REL and mean <= BF16_MEAN_REL, (worst, mean)


def assert_f32_fails_bf16(f32, want) -> None:
    """The control: an f32 result is outside the bf16 limits, so a path
    that quietly computed in f32 would fail `assert_close_bf16`."""
    worst, mean = bf16_errors(f32, want)
    assert worst > BF16_MAX_REL or mean > BF16_MEAN_REL, (worst, mean)

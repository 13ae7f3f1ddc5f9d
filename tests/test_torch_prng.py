"""The port's threefry PRNG (open3dsot_tpu_torch/utils/prng.py) against
jax.random, bit for bit: keys, fold_in and float32 uniform draws, at the
seeds and counters the scan trackers use (PRNGKey(1) for the 'all'
reservoir, PRNGKey(2) for the limit-box redraw, folded with a step count).
A wrong bit layout still gives draws that pass for U(lo, hi), so only an
exact comparison catches it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open3dsot_tpu_torch.utils import prng

AGES = [0, 1, 7, 2 ** 20, 2 ** 31 - 1]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _key_words(key) -> list:
    return [int(v) for v in np.asarray(jax.random.key_data(key)).ravel()]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prng_key_matches_jax(seed):
    assert list(prng.prng_key(seed)) == _key_words(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_in_and_uniform_match_jax(seed):
    data = torch.tensor(AGES, dtype=torch.int32)
    k0, k1 = prng.fold_in(prng.prng_key(seed), data)
    pairs = [[int(a), int(b)] for a, b in zip(k0, k1)]
    uniform11 = prng.uniform((k0, k1), (2,), -1.0, 1.0)
    uniform01 = prng.uniform((k0, k1), (37,))
    assert uniform11.shape == (5, 2) and uniform01.shape == (5, 37)
    assert uniform11.dtype == uniform01.dtype == torch.float32
    for i, age in enumerate(AGES):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), age)
        assert pairs[i] == _key_words(key)
        np.testing.assert_array_equal(
            _bits(uniform11[i]), _bits(jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)))
        np.testing.assert_array_equal(_bits(uniform01[i]), _bits(jax.random.uniform(key, (37,))))
    assert float(uniform11.min()) >= -1.0 and float(uniform11.max()) < 1.0


def test_batched_draws_match_jax_vmap():
    """A (B,) age vector, as the scan steps fold it (jax.vmap on the JAX side)."""
    ages = np.array([3, 0, 3, 12, 2 ** 31 - 1], np.int32)
    want = jax.vmap(lambda a: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(1), a), (128,)))(jnp.asarray(ages))
    got = prng.uniform(prng.fold_in(prng.prng_key(1), torch.from_numpy(ages)), (128,))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got[0]), _bits(got[2]))  # equal ages, equal draws


def test_unfolded_key_and_shapes_match_jax():
    """A key straight from PRNGKey, a 2-d shape and another range."""
    want = jax.random.uniform(jax.random.PRNGKey(2), (3, 4), minval=-0.3, maxval=0.7)
    got = prng.uniform(prng.prng_key(2), (3, 4), -0.3, 0.7)
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_prng_key_refuses_a_seed_out_of_range():
    with pytest.raises(ValueError):
        prng.prng_key(-1)
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 32)

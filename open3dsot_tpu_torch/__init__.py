"""open3dsot_tpu_torch: the PyTorch + CUDA port of open3dsot_tpu.

The JAX package (`open3dsot_tpu`) stays the reference; this package mirrors
its layout and module names so each module has an obvious counterpart.
Importing it pulls in neither jax nor flax, and has no side effects.

The numpy host modules (config, geometry, data, utils.metrics) are copies of
the JAX package's, with import paths rewritten: `open3dsot_tpu/__init__.py`
imports jax, so they cannot be shared. tests/test_torch_host_copies.py holds
each copy to its original.
"""

__version__ = "0.1.0"

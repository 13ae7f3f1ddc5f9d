"""The port's ops. Importing the package registers the kernels' operators
(torch.library.custom_op) K1/K2 (chain_fused), K3 (sampling) and K4
(sa_fused), which a program exported by tracking/serving_export.py calls."""

from open3dsot_tpu_torch.ops import chain_fused, sa_fused, sampling  # noqa: F401

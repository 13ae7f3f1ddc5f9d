"""Multi-device runs of the port (parallel/distributed.py), the counterpart
of `open3dsot_tpu/parallel/`."""

"""Probes on the card, ports of the JAX package's Pallas probes:

  gather       P1, scripts/probe_gather.py: the row-gather forms a fused SA
               kernel could use, exact against `A[idx]` and timed at K4's
               gather shapes (csrc/gather_probe.cu);
  gather_bf16  P2, scripts/probe_pallas_int8.py: an exact gather of bf16
               rows widened to f32 (the same .cu).
  fps_floor    K3's skeleton floors: FPS's serial step skeleton alone, in
               K3's design before its redesign (v1) and now (v2), each on
               its block (csrc/fps_floor.cu), no port of a Pallas kernel.

No model path runs them. The gathers run as `python -m
open3dsot_tpu_torch.probes.<name>` on a machine with a CUDA device; on CPU tensors the wrappers run their
plain versions, as the kernel wrappers under ops/ do.
"""

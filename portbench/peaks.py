"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit), the yardstick of every share of a roofline or a
peak in this benchmark."""

F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 494.7e12  # TF32 on the tensor cores
BF16_FLOPS = 989e12
BYTES_PER_S = 3.35e12  # HBM3
# The fastest float32-accurate rate: three TF32 products a multiply-add
# (3xTF32), as the port's K1/K2, K4 and K6 compute.
F32_ACCURATE_FLOPS = TF32_FLOPS / 3


def bound_s(nbytes: float, flops: float, peak: float = F32_FLOPS) -> float:
    """The least time this much work takes: the larger of its bytes over
    the memory's rate and its operations over `peak`."""
    return max(nbytes / BYTES_PER_S, flops / peak)


def tc_bound_s(nbytes: float, flops: float) -> float:
    """The bound of a 3xTF32 kernel: three TF32 products a multiply-add."""
    return bound_s(nbytes, 3 * flops, TF32_FLOPS)

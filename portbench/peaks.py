"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick every roofline share
divides by."""

HBM_BYTES_PER_S = 3.35e12        # device memory bandwidth
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
FP64_OPS_PER_S = 34e12           # float64 outside the tensor cores
FP64_MMA_OPS_PER_S = 67e12       # float64 on the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes over the bandwidth or
    float32 operations over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A share of the roofline is stated
against these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12  # 80 GB HBM3
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(flops: float, nbytes: float) -> float:
    """The least time any kernel could take for this work: the larger of
    its operations at the f32 peak and its bytes at the HBM peak."""
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit).  Frozen copy of chip_smoke.py's
F32_FLOP_PER_S and HBM_BYTES_PER_S (commit
26809b4dee3683ec1871bc5d1e1a6fa56c4992c9): the port computes in float32
outside the tensor cores (TF32 is off), so that is its compute peak."""

F32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip needs for `flops` and `nbytes`."""
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)

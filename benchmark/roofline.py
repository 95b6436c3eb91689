"""The card's published peaks and a launch's least time.

NVIDIA H100 SXM (data sheet, at its 700 W limit): 3.35 TB/s of HBM3 and
67 TFLOP/s of FP32 outside the tensor cores. A launch's least time is the
larger of its bytes over the memory rate and its FP32 operations over the
FP32 rate; a roofline share is the least time of a kernel's launches
over the device time they took, which cannot pass 100% unless the bytes or
operations are counted too high or the time leaves out part of the work.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def least_s(n_bytes: float, n_flops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS)


def share_pct(least: float, device_s: float):
    """100 * least / device time, or None where nothing ran (a reader that
    finds nothing returns nothing)."""
    if least <= 0.0 or device_s <= 0.0:
        return None
    return 100.0 * least / device_s

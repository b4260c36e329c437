"""The whole self-play step's share of the H100's float32 peak: the FLOPs
that the window's leaf evaluations need (``work.forward_flops`` per board,
every search's roots and every simulation's leaves) over the untraced
window's wall time, against 67 TFLOP/s (float32 outside the tensor
cores: the program runs its matmuls with TF32 off), in %."""

from h100bench import peaks


def read(data):
    c = data["counts"]
    if not c.get("window_flops") or not c.get("window_s"):
        return None
    return c["window_flops"] / c["window_s"] / peaks.FP32_FLOPS * 100.0

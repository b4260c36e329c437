"""The whole BT4 self-play step's share of the H100's bf16 dense peak: the
FLOPs that the window's leaf evaluations need (``work_bt4.forward_flops``
per board, every search's roots and every simulation's leaves) over the
untraced window's wall time, against 989 TFLOP/s, in %.  (The bf16 trunk
runs on the tensor cores, so ``mfu.selfplay``'s float32 peak does not
apply.)"""

from h100bench import peaks


def read(data):
    c = data["counts"]
    if not c.get("window_flops") or not c.get("window_s"):
        return None
    return c["window_flops"] / c["window_s"] / peaks.BF16_FLOPS * 100.0

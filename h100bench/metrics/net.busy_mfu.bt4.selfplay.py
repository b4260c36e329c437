"""The traced BT4 self-play slice's leaf evaluations against the bf16
dense peak while the device was busy: the FLOPs of the boards and tokens
the program's evaluator counted (``_bt4.slice_flops``) over the slice's
``busy_s``, against 989 TFLOP/s, in %: the kernels' efficiency apart from
the device's idle time."""

from h100bench import peaks
from h100bench.metrics import _bt4


def read(data):
    flops, busy = _bt4.slice_flops(data), data["trace"]["busy_s"]
    if flops is None or not busy:
        return None
    return flops / busy / peaks.BF16_FLOPS * 100.0

"""Share of the traced BT4 self-play slice's busy device time in GEMM
kernels (``_bt4.GEMM``)."""

from h100bench.metrics import _bt4


def read(data):
    return _bt4.busy_share(data, _bt4.is_gemm)

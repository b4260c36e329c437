"""Share of the traced train chunks' window in which no device operation
ran."""

from h100bench.metrics import _read as R


def read(data):
    return R.idle_share(data)

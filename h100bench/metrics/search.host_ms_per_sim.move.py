"""Host milliseconds inside the search's four spans per simulation of the
traced B=1 requests."""

from h100bench.metrics import _read as R


def read(data):
    return R.span_ms_per_sim(data, R.SEARCH_SPANS)

"""Host milliseconds inside the ``mcts.evaluate`` span per serial
simulation of the traced self-play slice."""

from h100bench.metrics import _read as R


def read(data):
    return R.span_ms_per_sim(data, ("mcts.evaluate",))

"""Host milliseconds inside the ``mcts.store`` span (the child's rotation,
terminal flag and state stored into the tree) per serial simulation of
the traced self-play slice."""

from h100bench.metrics import _read as R


def read(data):
    return R.span_ms_per_sim(data, ("mcts.store",))

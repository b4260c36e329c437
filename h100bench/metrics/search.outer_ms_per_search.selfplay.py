"""Host milliseconds per search call of the traced self-play slice outside
its simulation loop: the spans ``mcts.root`` (tree, root evaluation,
noise, root row, the host sync) and ``mcts.result`` over the search calls
(the program's ``mcts.searches``)."""

from h100bench.metrics import _counters as C


def read(data):
    return C.span_ms_per(data, ("mcts.root", "mcts.result"), "mcts.searches")

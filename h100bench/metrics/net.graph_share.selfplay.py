"""Share of the traced self-play slice's leaf evaluations that replayed a
CUDA graph of the net (``_graphs.graph_share``)."""

from h100bench.metrics import _graphs as G


def read(data):
    return G.graph_share(data)

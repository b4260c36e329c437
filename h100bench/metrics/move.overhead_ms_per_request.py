"""Host milliseconds per B=1 request of the traced slice outside the four
spans that ``search.host_ms_per_sim.move`` reads: ``MCTSPlayer.play``'s
``player.upload`` and ``player.answer``, and the search's ``mcts.root``,
``mcts.store`` and ``mcts.result``, over the requests (the program's
``player.requests``)."""

from h100bench.metrics import _counters as C

SPANS = ("player.upload", "player.answer", "mcts.root", "mcts.store",
         "mcts.result")


def read(data):
    return C.span_ms_per(data, SPANS, "player.requests")

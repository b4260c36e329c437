"""Host milliseconds of the actor's own work per ply of the traced
self-play slice: the spans ``selfplay.split``, ``selfplay.move`` and
``selfplay.host`` (everything of ``run_games`` outside its search calls)
over the plies played (the program's ``selfplay.plies``)."""

from h100bench.metrics import _counters as C

SPANS = ("selfplay.split", "selfplay.move", "selfplay.host")


def read(data):
    return C.span_ms_per(data, SPANS, "selfplay.plies")

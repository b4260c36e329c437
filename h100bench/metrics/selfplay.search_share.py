"""Share of the traced self-play window that the host spent inside the
search's four spans (the rest is the actor's per-move work)."""

from h100bench.metrics import _read as R


def read(data):
    return R.search_share(data)

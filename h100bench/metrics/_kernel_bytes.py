"""The least bytes that the search's descent and backup kernels move over
the traced slice, from the program's counters (the slice's boards x
simulations, path cells, live path levels and child installs), and the
kernels' shares of their rooflines.  The expressions are
``chip_smoke.py``'s per launch (``_descent_times``, ``_entry_work``),
summed over the launches; the stats are float32 in every cell."""

from __future__ import annotations

from h100bench import core, peaks, trace
from h100bench.metrics import _counters

ACTIONS = 409
STATS_BYTES = 4


def descent_bytes(levels: int, board_sims: int, path_cells: int,
                  actions: int = ACTIONS, e: int = STATS_BYTES) -> int:
    """Per level visited, the three edge lanes of the node's row, three
    node scalars and the child pointer read; per board, the four int64
    outputs, the depth and the three int32 path arrays over the buffer's
    width written."""
    return (levels * (3 * actions + 4) * e + board_sims * (4 * 8 + 4)
            + path_cells * 3 * 4)


def backup_bytes(levels: int, installs: int, board_sims: int, players: int,
                 actions: int = ACTIONS, e: int = STATS_BYTES) -> int:
    """Per board, the scalars, ``value_vec``, ``term_vec``, ``pvalid_new``
    and the slot read; the three path arrays at live levels, parent and
    action where a child is installed; and every stats element that
    receives a term read and written once: four per live level (the
    edge's and the node's visits and values; a path never revisits a
    node), the child pointer, and the slot row's prior lane, flag,
    rotation, value and terminal vector (the slot is on no path)."""
    per_board = 4 + 8 + 1 + 1 + 8 + 4 + 2 * 4 * players + 4 * actions + 4
    touched = 4 * levels + installs + board_sims * (actions + 3 + players)
    return (board_sims * per_board + levels * 12 + installs * 16
            + touched * 2 * e)


def roofline(data, kernel: str, nbytes: int | None) -> float | None:
    """``nbytes`` at 3.35 TB/s over the device time of the kernels whose
    name holds ``kernel``, in %; one launch per serial simulation, and
    where the trace kept fewer records than launches, the bytes scaled to
    the records kept."""
    secs, n = trace.kernel_time(data["trace"], kernel)
    launches = data["counts"].get("sims")
    if nbytes is None or not n or not launches:
        return None
    return nbytes * n / launches / peaks.HBM_BYTES_PER_S / secs * 100.0


def slice_counts(data, *names):
    """The program's counters ``names`` of the slice, or None where it
    counted none of one."""
    c = _counters.counters(data)
    if not all(c.get(n) for n in names):
        return None
    return [c[n] for n in names]


def players(data) -> int:
    return int(core.config(data["cell"]["config"])["num_players"])

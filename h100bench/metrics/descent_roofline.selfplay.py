"""The descent kernel's share of its roofline in the traced self-play
slice: the least bytes its launches move (``_kernel_bytes.descent_bytes``
at the slice's live path levels, boards x simulations and path cells, the
program's counters) at 3.35 TB/s, over ``descent_kernel``'s device time in
the trace, in %."""

from h100bench.metrics import _kernel_bytes as K


def read(data):
    c = K.slice_counts(data, "mcts.path_levels", "mcts.board_sims",
                       "mcts.path_cells")
    return K.roofline(data, "descent_kernel",
                      None if c is None else K.descent_bytes(*c))

"""The backup kernel's share of its roofline in the traced self-play
slice: the least bytes its launches move (``_kernel_bytes.backup_bytes``
at the slice's live path levels, child installs and boards x
simulations, the program's counters) at 3.35 TB/s, over
``fused_backup_entry``'s device time in the trace, in %."""

from h100bench.metrics import _kernel_bytes as K


def read(data):
    c = K.slice_counts(data, "mcts.path_levels", "mcts.installs",
                       "mcts.board_sims")
    nbytes = None if c is None else K.backup_bytes(*c, K.players(data))
    return K.roofline(data, "fused_backup_entry", nbytes)

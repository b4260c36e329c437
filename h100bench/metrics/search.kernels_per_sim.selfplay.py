"""Device kernels launched in the traced self-play slice, per serial
simulation (one descent, step, evaluation and backup of every board)."""

from h100bench.metrics import _read as R


def read(data):
    return R.kernels_per_sim(data)

"""Device kernels launched in the traced B=1 requests, per simulation."""

from h100bench.metrics import _read as R


def read(data):
    return R.kernels_per_sim(data)

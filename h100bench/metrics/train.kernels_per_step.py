"""Device kernels launched in the traced train chunks, per train step."""


def read(data):
    steps = data["counts"].get("steps")
    return data["trace"]["kernels"] / steps if steps else None

"""The env-step kernel's share of its roofline in the traced self-play
slice: the bytes its launches must move (``work.env_step_bytes`` at each
launch's boards) at 3.35 TB/s, over the kernel's device time in the trace,
in %.  Its operations are integer compares and adds, for which the table
of peaks has no rate, so the bytes bound it.  Where the trace kept fewer
records than launches, the bytes are scaled to the records kept."""

from h100bench import peaks, trace


def read(data):
    c = data["counts"]
    secs, n = trace.kernel_time(data["trace"], "env_step_kernel")
    if not n or not c.get("env_step_launches"):
        return None
    nbytes = c["env_step_bytes"] * n / c["env_step_launches"]
    return nbytes / peaks.HBM_BYTES_PER_S / secs * 100.0

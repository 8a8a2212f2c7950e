"""Share of the traced bursts' host window in which no kernel, copy or set ran
on the device (torch.profiler; the union of device intervals), in %."""

UNIT = "%"


def read(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""GPU kernels in the traced bursts' trace per frame rendered (torch.profiler:
every kernel of the replayed graphs and around them)."""

UNIT = "kernels/frame"


def read(r):
    t = r.trace
    if t is None or not t.frames or not t.kernels:
        return None
    return len(t.kernels) / t.frames

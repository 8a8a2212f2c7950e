"""Raster and shade of the frame, replayed: the full frame less the binning
prefix, device ms per frame.  Only the sum is read: the raster and shade
deltas alone move ~0.2 ms between them from call to call."""

UNIT = "ms"


def read(r):
    _, cumulative = r.stages()
    full, binned = cumulative["full"]["graph_device"], cumulative["bin"]["graph_device"]
    return None if full is None or binned is None else full - binned

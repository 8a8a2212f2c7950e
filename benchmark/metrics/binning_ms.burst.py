"""Binning of the frame, replayed: the stage breakdown's binning delta (the
binning prefix less the vertex prefix), device ms per frame."""

UNIT = "ms"


def read(r):
    deltas, _ = r.stages()
    return deltas["bin"]["graph_device"]

"""The vertex stage of the frame, replayed as a CUDA graph: the program's
stage breakdown's vertex prefix (both passes' matrix stacks and
triangle_setup), device ms per frame by CUDA events."""

UNIT = "ms"


def read(r):
    deltas, _ = r.stages()
    return deltas["vertex"]["graph_device"]

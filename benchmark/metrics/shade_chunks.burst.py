"""Chunk bodies of the strip shade a replayed burst frame runs: the
program's covered count, stamped in the frame graph, under the chunk rule
(frame.shade_chunks), the mean over the frames of a traced stretch of the
mix (program_trace)."""

import statistics

from benchmark import program_trace

UNIT = "chunks/frame"


def read(r):
    got = [f["chunks"] for f in program_trace.frames(r, "orbit-burst") if f["chunks"] is not None]
    return statistics.mean(got) if got else None

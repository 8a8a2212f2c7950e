"""Device ms of binning's step binning.sort (torch.sort of the keys; both
passes summed in a two-pass frame) inside the replayed burst frame: the
program's stage stamps (utils/timing.py mark, %globaltimer in the frame
graph; the step runs from the stamp before it to the mark binning.sort in
ops/binning.py), the median over the frames of a traced stretch of the mix
(program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "binning.sort")

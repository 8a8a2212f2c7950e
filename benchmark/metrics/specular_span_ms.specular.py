"""Device ms of the specular shade (the three map samples, the normal's
transform, the reflection, the pow and the blend, over the strip shade's
chunk bodies that ran) inside the replayed burst frame: the program's stage
stamps (utils/timing.py marks `shade` -> `specular` around
shaders.shade_specular, %globaltimer in the frame graph), the median over
the frames of a traced stretch of the mix (program_trace)."""

from benchmark import program_trace

UNIT = "ms"


def read(r):
    return program_trace.stage_ms(r, "orbit-burst", "specular")

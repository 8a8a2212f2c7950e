"""The specular shade's share of its roofline: the least time of a frame's
shade at its covered pixels (roofline_specular: the pixels the program
stamps in the frame graph) over the frame's specular stage (its `specular`
stamps), the median over the frames of a traced stretch of the burst mix
(program_trace), in %."""

import statistics

from benchmark import program_trace, roofline_specular

UNIT = "%"


def read(r):
    w, h = r.config["width"], r.config["height"]
    shares = [100.0 * roofline_specular.least_seconds(w, h, f["pixels"]) / (f["stages"]["specular"] / 1e3)
              for f in program_trace.frames(r, "orbit-burst")
              if f.get("pixels") is not None and f["stages"].get("specular")]
    return statistics.median(shares) if shares else None

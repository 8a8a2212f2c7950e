"""The interactive frame's fetch: Scene.get_frame_buffer() after an explicit
synchronize (host clock), the median over the traced run's span frames, in ms."""

import statistics

UNIT = "ms"


def read(r):
    spans = r.spans.get("blit")
    return 1e3 * statistics.median(spans) if spans else None

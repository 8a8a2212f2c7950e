"""Host issue of the interactive frame: Scene.render()'s call to return (host
clock), the median over the traced run's span frames, in ms."""

import statistics

UNIT = "ms"


def read(r):
    spans = r.spans.get("issue")
    return 1e3 * statistics.median(spans) if spans else None

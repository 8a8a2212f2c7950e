"""Device activity from a torch.profiler trace, over the host's window.

Frozen from ``chip_smoke.trace_kernels`` with its two faults repaired:
busy time is the length of the UNION of the device's kernel, copy and set
intervals (a sum counts overlapping streams twice), and the window is the
host's own, the ``bench.window`` range the harness records around the
traced work (the span from the first device event to the last leaves out
the idle gaps at both ends).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """What a traced window holds.  Times in seconds."""

    window_s: float
    busy_s: float
    kernels: list          # (name, seconds) of every kernel inside the window
    device_ops: list       # [name, seconds] of the 10 device ops that took most time
    idle_gaps: list        # [host activity, seconds] of the 10 longest idle gaps
    frames: int = 0        # frames the traced work rendered


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, frames=0):
    """Trace of chrome-trace `events` (µs) clipped to the WINDOW range, or
    None when the trace has no such range or no device activity in it."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    w0 = marks[0]["ts"]
    w1 = w0 + marks[0]["dur"]
    dev = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if t > s:
                dev.append((s, t, e))
    if not dev:
        return None
    merged = union([(s, t) for s, t, _ in dev])
    busy = sum(t - s for s, t in merged)
    by_name = {}
    for s, t, e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in spans if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
    return Trace(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy / 1e6,
        kernels=[(e["name"], (t - s) / 1e6) for s, t, e in dev if e.get("cat") == "kernel"],
        device_ops=[[name, us / 1e6] for name, us in top],
        idle_gaps=[[_host_activity(host, (a + b) / 2), (b - a) / 1e6] for a, b in gaps],
        frames=frames,
    )


def per_frame_seconds(trace, pattern):
    """Seconds per traced frame of the kernels whose names match `pattern`,
    or None when the trace has none of them."""
    if trace is None or not trace.frames:
        return None
    secs = [s for name, s in trace.kernels if pattern.search(name)]
    return sum(secs) / trace.frames if secs else None


def _host_activity(host, t):
    """The innermost host range covering time t, or "host" (Python between calls)."""
    best = None
    for e in host:
        if e["ts"] <= t <= e["ts"] + e["dur"] and (best is None or e["dur"] < best["dur"]):
            best = e
    return "host" if best is None else best["name"]


def profile(run, device):
    """Chrome-trace events of run() under torch.profiler (host and CUDA
    activity), run() inside the WINDOW range and closed by a synchronize.
    The trace file goes to a temporary directory (TMPDIR) and is removed."""
    import torch

    torch.cuda.synchronize(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                out = run()
                torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, out

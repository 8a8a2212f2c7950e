"""The tracer's cost on a benchmark cell: windows of the cell's loop with the
program's tracer (tiny_renderer_tpu_torch.utils.timing) off and on, in
turns, in one process, and the loop's host spans after each window (the
frame loop: Scene.render's issue and the fetch, medians of 200 frames).

    python scripts/torch_trace_cost.py --workload diablo-shadow.orbit-burst \\
        [--seconds 10] [--rounds 3] [--seed N]

Set-up as a benchmark run makes it (benchmark/harness.py: the scene, the
loop's capture and warm-up); then `rounds` rounds of one window with the
tracer off and one with it on, their order alternating.  Turning the tracer
on captures the frame graph with its stage marks, so one loop step with
the tracer on runs before the first window that has it on.  One JSON line
per window on stderr (the cell's end-to-end metrics, the frames the tracer
drained, spans and frames dropped), the last line on stdout: each side's
medians, and the card's name and power limit.  Needs a CUDA device.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2147500777)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness, orbit
    from tiny_renderer_tpu_torch.ops import raster_cuda
    from tiny_renderer_tpu_torch.pipelines import graphs
    from tiny_renderer_tpu_torch.utils import timing

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = "cuda:0"
    cell = harness.find_cell(args.workload, ROOT)
    raster_cuda.build()
    raster_cuda.build(source=graphs.IF_SOURCE)
    scene, _, _ = harness.build_scene(cell.config, args.seed, dev)
    loop = harness.loop_module(cell.traffic["loop"]).Loop(scene, cell.traffic, args.seed)
    for _ in range(cell.traffic["warmup_steps"]):
        loop.step()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.traffic.get("warmup_seconds", 0.0):
        loop.step()
    timing.enable()  # builds the mark kernel; one traced step captures the traced graph
    loop.step()
    loop.sync()
    timing.snapshot()
    timing.disable()
    sides = {"off": [], "on": []}
    for k in range(args.rounds):
        for side in (("off", "on") if k % 2 == 0 else ("on", "off")):
            if side == "on":
                timing.enable()
            loop.sync()
            _, e2e = loop.window(args.seconds, orbit.Reservoir(1, args.seed))
            loop.sync()
            # The loop's host spans (the frame loop: each frame's issue and fetch).
            e2e.update({f"{name}_ms": 1e3 * statistics.median(v) for name, v in loop.spans().items()})
            snap = timing.snapshot()
            timing.disable()
            sides[side].append(e2e)
            print(json.dumps({"round": k, "tracer": side, **e2e, "frames_drained": len(snap["frames"]),
                              "dropped": snap["dropped"]}), file=sys.stderr, flush=True)
    medians = {side: {m: statistics.median(w[m] for w in ws) for m in ws[0]} for side, ws in sides.items()}
    print(json.dumps({"workload": cell.name, "seconds": args.seconds, "rounds": args.rounds, **medians,
                      "device": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set the limit of the comparison that decides `correct`.

    python3 benchmark/control.py --workload <cell> --seconds 3 --seeds 11 12 13 ...

For each seed, in one process: a run of the cell as run.py makes it (a
shorter window), whose worst sampled-frame mismatch against the reference
is the program's reading (the lower end), and the control's reading at the
same poses: the reference put in the program's place, computed in
bfloat16, the precision below the configuration's float32, against the
reference (the upper end).  One JSON line per seed on stdout.  Not run by
the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload, ROOT)
    # The readings do not depend on the card's pace: a short warm-up.
    cell.traffic["warmup_seconds"] = min(cell.traffic["warmup_seconds"], 3.0)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        keep = {}
        log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
        r = harness.run(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(), log, keep=keep)
        line = {"workload": cell.name, "seed": seed, "correct": r["correct"],
                "attempted": r["attempted"], "program_mismatch_pct": r["compared"]["mismatch_pct"]["value"],
                "control_bf16_mismatch_pct": harness.control_reading(
                    cell, keep["sample"], keep["mesh"], keep["maps"], "cuda:0", torch.bfloat16)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

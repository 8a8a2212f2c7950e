"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic mix
and metrics are found by name (BENCHMARK.json and the files under this
folder; see harness.py).  Needs an NVIDIA GPU: without one, or with fewer
than the cell asks for, it exits with code 2 and prints no result.  It
exits with code 3, and prints no result, when JAX or the JAX package was
loaded.  Standard error gets the set-up's parts and, as its last lines,
each number compared with the reference beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    # The program and its library, imported before the clock's "import" part ends.
    import torch
    import tiny_renderer_tpu_torch  # noqa: F401

    torch.set_num_threads(1)  # one process, few threads: the host's pace is steadier

    from benchmark import harness

    cell = harness.find_cell(args.workload, ROOT)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, log)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

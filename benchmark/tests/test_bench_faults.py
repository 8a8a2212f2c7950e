"""A run whose timed path is broken underneath comes out not correct: the
harness's run (benchmark/tests/drive_run.py, the look for a GPU skipped),
once for each fault the cells can have, on the CPU at a small size and, on
the GPU, at the cell's own size.  The cells have no exchange between chips
(one chip each)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

RUN = Path(__file__).resolve().parent / "drive_run.py"

FAULTS = [
    ("diablo-shadow.orbit-burst", "stale_burst"),     # a step returns its state unchanged
    ("diablo-shadow.interactive", "stale_frame"),
    ("diablo-shadow.orbit-burst", "half_burst"),      # half of the batch left out
    ("diablo-shadow.orbit-burst", "altered_burst"),   # an answer altered where it is produced
    ("diablo-shadow.interactive", "altered_frame"),
]
# The shadow-map compare skipped (every fragment lit): it changes pixels near
# the sphere's terminator only, so it shows with the cell's own mesh and not
# with the small size's coarse sphere.
SHADOW = [("diablo-shadow.orbit-burst", "no_shadow_compare"),
          ("diablo-shadow.interactive", "no_shadow_compare")]


def run(cell, fault=None, *extra):
    args = [sys.executable, str(RUN), cell, *extra] + (["--fault", fault] if fault else [])
    out = subprocess.run(args, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def not_correct(r):
    return (not r["correct"] and r["failed"] > 0
            and r["compared"]["mismatch_pct"]["value"] > r["compared"]["mismatch_pct"]["limit"])


@pytest.mark.parametrize("cell,fault", [
    ("diablo-shadow.orbit-burst", None),
    ("diablo-shadow.interactive", None),
])
def test_sound_run_is_correct(cell, fault):
    r = run(cell, fault)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    assert not_correct(run(cell, fault))


def test_shadow_fault_is_not_correct():
    """At 200 x 200 with the cell's own sphere, on the CPU: a burst's eight
    frames (the interactive loop renders one frame in such a window here,
    and one pose may show too little; the GPU test below runs both cells)."""
    assert not_correct(run(*SHADOW[0], "--size", "mid", "--seconds", "3", "--seed", "2147483613"))


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", FAULTS + SHADOW)
def test_fault_at_cell_size(card, cell, fault):
    """On the GPU at the cell's own size and loop (a 3 s window): the
    shadow-compare fault on three seeds, each other fault on one."""
    seeds = (2147483921, 2147483922, 2147483923) if fault == "no_shadow_compare" else (2147483924,)
    for seed in seeds:
        r = run(cell, fault, "--size", "cell", "--device", card, "--seconds", "3", "--seed", str(seed))
        print(cell, fault, seed, "mismatch_pct", r["compared"]["mismatch_pct"]["value"])
        assert not_correct(r), (seed, r["compared"])

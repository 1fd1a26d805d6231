"""The control of the comparison (check.py): the plain reference put in
the program's place, sound and with one guarantee broken, at a cell's
own size.

    python3 mcbench/control.py --workload NAME --seeds N [N ...]

For each seed it makes the cell's sample as a run does, then compares
with the truth (1) the records of the reference itself, which must read
0 on every number, and (2) the control: the reference with the
configuration's first guarantee broken, every read counted once, by
leaving mate 2 of every pair out (a single-end shortcut that would halve
the host leg's work), which must fail at least one limit. Prints one
JSON line a seed. Runs on the host alone; the benchmark's runs never
call it."""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from mcbench import check, harness  # noqa: E402
from mcbench.reference import pileup  # noqa: E402


def readings(root: str, workload: str, seed: int) -> dict:
    cell = harness.find_cell(root, workload)
    ref = harness.genome(cell.config)
    gvcf = "-gvcf" in cell.traffic.get("cli_flags", [])
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as d:
        s = harness.make_sample(cell.config, cell.traffic, seed, ref, d)
    truth = pileup.pileup(s.territory, s.mutant, s.reads)
    nor = (pileup.clean_positions(truth, int(cell.traffic.get(
        "nor_sample", 0)), harness.sub_seed(seed, 3)) if gvcf else None)
    sound = check.compare(check.reference_records(truth), truth, gvcf, nor)
    broken = pileup.pileup(s.territory, s.mutant, s.reads, drop_mate=1)
    control = check.compare(check.reference_records(broken), truth, gvcf,
                            nor)
    limits = cell.traffic["limits"]
    kept = lambda nums: {k: v for k, v in nums.items() if k in limits}
    return dict(workload=workload, seed=seed, reference=sound,
                reference_passes=check.verdict(kept(sound), limits),
                control=control,
                control_fails=not check.verdict(kept(control), limits))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mcbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--root", default=harness.ROOT)
    a = p.parse_args(argv)
    ok = True
    for seed in a.seeds:
        r = readings(a.root, a.workload, seed)
        print(json.dumps(r), flush=True)
        ok &= r["reference_passes"] and r["control_fails"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

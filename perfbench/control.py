"""Readings that set the limits of ``correct``: for each seed, one short
run of a cell through the harness (the program's widest ``logit_gap``
against the reference, the lower reading) and the control's (the
reference in bfloat16 in the program's place, the upper reading).  The
benchmark's own runs do not run it.

    python3 perfbench/control.py --workload <cell> --seconds 2 \\
        --seeds 11 12 13 ...

Prints one JSON line a seed and a last summary line.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    cell = harness.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.cards:
        harness.log(f"{args.workload} needs {cell.cards} CUDA card(s)")
        return 2
    rows = []
    for seed in args.seeds:
        res = harness.system(cell).run_cell(cell, seed, args.seconds, False,
                               time.perf_counter(), control=True)
        row = {"seed": seed, "correct": res["correct"],
               "attempted": res["attempted"],
               "logit_gap": res["checks"]["logit_gap"]["value"],
               "unanswered": res["checks"]["unanswered"]["value"],
               "control_gap": res["control_gap"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "lower": max(r["logit_gap"] for r in rows),
        "upper": min(r["control_gap"] for r in rows),
        "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Find an open-loop cell's knee: the highest offered rate the port
sustains without a growing backlog.  One run through the harness a rate;
the cell's rate is then written into its traffic file by hand.  The
benchmark's own runs do not run it.

    python3 perfbench/sweep.py --workload <cell> --seconds 8 \\
        --seeds 7 8 --rates 80 100 120 ...

Prints one JSON line a rate and seed: offered and answered requests a second, the
latency's median and 95th percentile, and how late the requests of the
first and of the last quarter were sent (a backlog that grows makes the
last quarter later).
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
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    for rate in args.rates:
        for seed in args.seeds:
            sweep(args.workload, rate, seed, args.seconds)
    return 0


def sweep(workload: str, rate: float, seed: int, seconds: float) -> None:
    from perfbench import harness, loadgen
    cell = harness.load(workload)
    cell.mix["rate_per_s"] = rate
    runs = []
    res = harness.system(cell).run_cell(cell, seed, seconds, False,
                                        time.perf_counter(), runs=runs)
    run = runs[0]
    reqs = run.requests
    q = max(1, len(reqs) // 4)
    ms = [r.latency_s * 1e3 for r in reqs if r.answered]
    late = lambda rs: loadgen.percentile(  # noqa: E731
        [r.late_s * 1e3 for r in rs], 95)
    print(json.dumps({
        "rate": rate, "seed": seed, "offered": len(reqs),
        "correct": res["correct"],
        "answered_per_s": sum(r.answered for r in reqs) / run.window_s,
        "images_per_s": run.images(reqs) / run.window_s,
        "p50_ms": loadgen.percentile(ms, 50),
        "p95_ms": loadgen.percentile(ms, 95),
        "late_p95_ms_first": late(reqs[:q]),
        "late_p95_ms_last": late(reqs[-q:])}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

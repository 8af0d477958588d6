"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit.
The last lines of standard error repeat the checks.  Without as many CUDA
cards as the cell asks for, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.

Run it from the root of a checkout: it serves the port from ``src/``,
whose kernels build into ``src/repro_torch/kernels/_build/`` on the first
run and are found there by the next ones.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: Top-level module names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} &
                  set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def plain(v):
    """A number JSON can carry: a float that is not finite as a string."""
    return v if not isinstance(v, float) or math.isfinite(v) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    marks = [("arguments", time.perf_counter())]
    import torch
    marks.append(("import torch", time.perf_counter()))
    from perfbench import harness
    cell = harness.load(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.cards:
        harness.log(f"{args.workload} needs {cell.cards} CUDA card(s); "
                    f"this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    marks.append(("the cell and its cards", time.perf_counter()))
    system = harness.system(cell)
    marks.append(("the system and the port's modules", time.perf_counter()))
    harness.log("set-up, imports: " + ", ".join(
        f"{name} {t - t0:.3f} s" for (name, t), t0 in
        zip(marks, [T_START] + [t for _, t in marks])))
    result = system.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             T_START)
    harness.log(f"cards: {card_line()}")
    bad = loaded_forbidden()
    if bad:
        harness.log(f"loaded, and must not be: {', '.join(bad)}")
        return 3
    for m in result["metrics"].values():
        m["value"] = plain(m["value"])
    for c in result["checks"].values():
        c["value"] = plain(c["value"])
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

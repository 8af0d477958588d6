"""The CNN serving system: one run of a cell through the port's
``ServingEngine`` (configuration ``"system": "cnn_serving"``).

Set-up draws the weights and a pool of images on the card from the seed,
builds the engine and captures the buckets the mix uses; the window runs
the mix (``perfbench/loadgen.py``); ``--trace 1`` adds a traced stretch
(``perfbench/tracing.py``); then every answer is checked against the plain
reference the configuration names (``"reference": "cnn"``:
``perfbench/reference/cnn.py``) and each metric's reader reads the run.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from perfbench import harness, loadgen, peaks, program, tracing
from perfbench.harness import Cell, log, reader
from repro_torch.exec import executor

#: The numbers ``correct`` compares, each with its limit (PERF.md gives
#: the readings they were set from).  The served logits must equal the
#: reference's bit for bit, and every request must be answered.
LIMITS = {"logit_gap": 0.0, "unanswered": 0}


@dataclasses.dataclass
class Run:
    """What the readers read: the window's requests and counters, the
    traced stretch, and the network's GEMMs."""
    cell: Cell
    setup_s: float                       # process start to the window
    requests: List[loadgen.Request]      # the measured window's
    window_s: float
    counters: Dict[str, int]             # ServingEngine.stats() deltas
    gemms: List[peaks.Gemm]              # one image, the layers' own work
    buckets: tuple
    trace: Optional[tracing.Trace] = None
    traced: List[loadgen.Request] = dataclasses.field(default_factory=list)

    @property
    def cards(self) -> int:
        return self.cell.cards

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket(self, n: int) -> int:
        return next(b for b in self.buckets if b >= n)

    def images(self, reqs) -> int:
        return sum(r.size for r in reqs if r.answered)

    def forwards(self, reqs) -> int:
        return sum(-(-r.size // self.max_batch) for r in reqs)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             in_hw: Optional[int] = None,
             fault: Optional[Callable] = None, control: bool = False,
             runs: Optional[list] = None) -> dict:
    """Run ``cell`` once and return its result (without the guards that
    ``run.py`` applies).  ``device="cpu"``, a smaller ``in_hw`` and a
    ``fault`` planted in the engine are for the tests; ``control`` adds
    the control's reading (``control_gap``, see ``check``); ``runs``
    receives the ``Run`` the readers read."""
    config, mix = cell.config, cell.mix
    hw = in_hw or config["input"]["hw"]
    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(cell.cards)]
    else:
        devices = [torch.device(device)] * cell.cards
    home = devices[0]

    # -- set-up: weights, image pool, engine, the buckets the mix uses --
    marks = [("imports", time.perf_counter())]
    for d in devices:
        if d.type == "cuda":
            torch.cuda.init()
            torch.empty(1, device=d)
    _sync(devices)
    marks.append(("CUDA context", time.perf_counter()))
    gen = torch.Generator(device=home).manual_seed(seed)
    params = program.weights(config, hw, gen)
    pool = program.images(config, hw, loadgen.pool_images(mix), gen)
    comps = loadgen.compositions(mix)
    views = [pool[s:s + n] for n, s in comps]
    _sync(devices)
    marks.append(("weights and images", time.perf_counter()))
    eng = program.engine(config, params, hw, mix["max_batch"], home,
                         devices if cell.cards > 1 else None)
    marks.append(("engine and plans", time.perf_counter()))
    if fault is not None:
        fault(eng)
    warm = {}
    for c, (n, _) in enumerate(comps):
        warm.setdefault(next(b for b in eng.buckets if b >= n), c)
    for c in warm.values():
        for _ in range(2):
            eng.infer(views[c])
    _sync(devices)
    marks.append((f"buckets {sorted(warm)} captured", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {t - t0:.3f} s" for (name, t), t0 in
        zip(marks, [t_start] + [t for _, t in marks])))

    spans = [False]

    def send(req: loadgen.Request) -> None:
        with record_function(tracing.REQUEST) if spans[0] else nullcontext():
            out = eng.infer(views[req.comp])
            req.logits = out.to("cpu")

    # -- the measured window ---------------------------------------------
    before = eng.stats()
    t_window = time.perf_counter()
    reqs, w0, w1 = loadgen.run(mix, seed, seconds, send)
    after = eng.stats()
    counters = {k: after[k] - before[k] for k in
                ("padded_slots", "executed_slots")}
    run = Run(cell, t_window - t_start, reqs, w1 - w0, counters,
              [(g.c, g.k, g.d, g.count) for g in program.gemms(config, hw)],
              tuple(eng.buckets))
    log(f"window: {len(reqs)} requests, {run.images(reqs)} images in "
        f"{run.window_s:.6f} s")
    if runs is not None:
        runs.append(run)

    # -- the traced stretch ------------------------------------------------
    traced: List[loadgen.Request] = []
    if trace and device == "cuda":
        spans[0] = True
        for _ in range(3):
            (got, _, _), tr = tracing.traced(
                lambda: loadgen.run(mix, seed, mix["trace_seconds"], send,
                                    first=len(reqs) + len(traced)),
                [d.index for d in devices])
            traced += got
            if tr is not None:
                run.trace, run.traced = tr, got
                break
            log("the profiler saw no device operation; tracing again")
        spans[0] = False
    memory_peak = (max(torch.cuda.max_memory_allocated(d) for d in devices)
                   if device == "cuda" else 0)

    # -- the check: every answer against the reference -------------------
    del eng
    executor.clear_compile_cache()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = check(config, params, views, reqs + traced, control)

    # -- the result --------------------------------------------------------
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(home) if device == "cuda"
                    else device),
           "count": cell.cards, "memory_peak_bytes": memory_peak}
    result = {"correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
              "attempted": len(reqs) + len(traced),
              "failed": sum(not r.answered for r in reqs + traced),
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.mean_busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    if control:
        result["control_gap"] = checks["control_gap"]
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]}
                        for k in LIMITS}
    errors = [r.error for r in reqs + traced if r.error]
    if errors:
        log(f"{len(errors)} requests raised; the first:\n{errors[0]}")
    return result


def check(config: dict, params: Dict[str, torch.Tensor], views,
          reqs: List[loadgen.Request], control: bool = False
          ) -> Dict[str, float]:
    """Every answered request's logits against the plain reference's (the
    module the configuration names) for
    its image set (one reference forward a set), and the count of requests
    never answered.  With ``control``, also the control's reading: the
    reference computed in bfloat16, the precision below the float32 the
    configuration states, put in the program's place (its widest
    ``logit_gap`` over the same image sets)."""
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference = harness.reference(config)
    try:
        used = sorted({r.comp for r in reqs if r.answered})
        want = {c: w.cpu() for c, w in zip(
            used, reference.forwards(config, params,
                                     [views[c] for c in used]))}
        if control:
            low = reference.forwards(config, params,
                                     [views[c] for c in used],
                                     torch.bfloat16)
            ctrl = max(reference.logit_gap(w.cpu(), want[c])
                       for c, w in zip(used, low))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
    gaps = [reference.logit_gap(r.logits, want[r.comp])
            for r in reqs if r.answered]
    gap = (math.nan if any(math.isnan(g) for g in gaps)
           else max(gaps, default=0.0))
    out = {"logit_gap": gap,
           "unanswered": sum(not r.answered for r in reqs)}
    if control:
        out["control_gap"] = ctrl
    return out


"""The port's own spans (``repro_torch.runtime.trace``) in a run's traced
stretch, grouped by the served request they sit under.

The port records spans only while a profiler session is open, so only in
the traced stretch.  Spans are kept where they lie inside the stretch's
requests (``run.traced``: from the first send to the last answer), so a
stretch that was traced again is counted once.  Where the port has no
recorder, or recorded nothing there, there is nothing to read.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from perfbench import loadgen

#: The root span of a served request (``ServingEngine.infer``).
ROOT = "serving.infer"


def requests(run) -> List[Dict[str, float]]:
    """One row a served request of the traced stretch: every span name
    under it -> its summed seconds, ``ROOT`` -> the request's own, and
    the root's attributes (``images``, ``chunks``).  Empty where there is
    nothing to read."""
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return []
    sent = [r.sent for r in run.traced if not math.isnan(r.sent)]
    done = [r.done for r in run.traced if not math.isnan(r.done)]
    if not sent or not done:
        return []
    lo, hi = min(sent) * 1e9, max(done) * 1e9
    inside = [s for s in trace.spans() if lo <= s.start_ns and s.end_ns <= hi]
    rows = {s.request: {ROOT: (s.end_ns - s.start_ns) * 1e-9, **s.attrs}
            for s in inside if s.name == ROOT}
    for s in inside:
        row = rows.get(s.request)
        if s.name != ROOT and row is not None:
            row[s.name] = row.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
    return list(rows.values())


def p95_ms(run, name: str) -> Optional[float]:
    """The 95th percentile over the stretch's requests of each one's
    summed ``name`` spans, in ms; None where no request has one."""
    rows = requests(run)
    if not any(name in r for r in rows):
        return None
    return loadgen.percentile([1e3 * r.get(name, 0.0) for r in rows], 95)


def per_forward_ms(run, name: str, less: str = "") -> Optional[float]:
    """The stretch's summed ``name`` spans, less its ``less`` spans, over
    its forwards (a request's ``chunks``), in ms; None where no request
    has a ``name`` span."""
    rows = requests(run)
    if not any(name in r for r in rows):
        return None
    seconds = sum(r.get(name, 0.0) - r.get(less, 0.0) for r in rows)
    return 1e3 * seconds / sum(r["chunks"] for r in rows)

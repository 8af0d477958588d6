"""The load generator: reads a traffic mix's parameters and drives a
``send`` callable with them through the mix's arrival process.

A mix (``perfbench/traffic/<mix>.json``) names:

* ``loop``: its arrival process, ``perfbench/loops/<loop>.py``, found by
  name: ``closed`` (one client sends its next request when the last one
  has come back) or ``open`` (Poisson arrivals at ``rate_per_s``, sent
  whether or not earlier ones have come back, from a pool of ``senders``
  threads);
* ``sizes``: the images a request may carry;
* ``variants``: how many distinct image sets each size has.  Request
  images are views into one pool of ``variants * max(sizes)`` images made
  at set-up, so the window copies nothing from the host; the check
  compares every request against the reference of its image set;
* the loop's own parameters (``rate_per_s``, ``senders``: see its file);
* ``max_batch``: the engine's largest bucket (the cards are the cell's
  ``chips``);
* ``trace_seconds``: the length of the traced stretch of a ``--trace 1``
  run.
"""
from __future__ import annotations

import dataclasses
import math
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

from perfbench import harness

#: How long past the end of the schedule a run waits for answers.
GRACE_S = 60.0


@dataclasses.dataclass
class Request:
    """One request: its image set, when it was due, sent and answered."""
    index: int
    comp: int                 # index into compositions()
    size: int
    due: float
    sent: float = math.nan
    done: float = math.nan
    logits: object = None     # the answer, on the host
    error: Optional[str] = None

    @property
    def answered(self) -> bool:
        return self.logits is not None

    @property
    def latency_s(self) -> float:
        return self.done - self.due

    @property
    def late_s(self) -> float:
        return self.sent - self.due


def compositions(mix: dict) -> List[Tuple[int, int]]:
    """Every image set a request may carry: (size, first pool image)."""
    top = max(mix["sizes"])
    return [(n, v * top) for v in range(mix["variants"])
            for n in mix["sizes"]]


def pool_images(mix: dict) -> int:
    return mix["variants"] * max(mix["sizes"])


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, interpolated
    linearly between the two nearest ranks."""
    v = sorted(values)
    if not v:
        return math.nan
    at = (len(v) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


Send = Callable[[Request], None]


def deliver(send: Send, req: Request) -> None:
    """Send ``req`` and time it; a request that raises is counted as
    unanswered."""
    req.sent = time.perf_counter()
    try:
        send(req)
    except Exception:      # a request that fails is counted, the run goes on
        req.error = traceback.format_exc()
    req.done = time.perf_counter()


def run(mix: dict, seed: int, seconds: float, send: Send, first: int = 0):
    """The mix's loop (``perfbench/loops/<loop>.py``) for ``seconds``:
    (requests, window start, window end) on ``time.perf_counter``'s
    clock."""
    return harness.loop(mix["loop"]).run(mix, seed, seconds, send, first)

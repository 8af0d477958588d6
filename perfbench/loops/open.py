"""Open loop: Poisson arrivals at the mix's ``rate_per_s``, each request
carrying an image set drawn uniformly from the mix's, sent on its due
time from a pool of ``senders`` threads whether or not earlier requests
have come back.  Each request is timed from when it was due."""
from __future__ import annotations

import math
import random
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Tuple

from perfbench.loadgen import (GRACE_S, Request, Send, compositions,
                               deliver)


def schedule(mix: dict, seed: int, seconds: float
             ) -> List[Tuple[float, int]]:
    """(due offset in s, image set) of every arrival in ``seconds``: gaps
    drawn from the exponential distribution at ``rate_per_s``, image sets
    uniformly, both from the seed."""
    rng = random.Random(seed)
    rate, comps = mix["rate_per_s"], len(compositions(mix))
    out: List[Tuple[float, int]] = []
    t = rng.expovariate(rate)
    while t < seconds:
        out.append((t, rng.randrange(comps)))
        t += rng.expovariate(rate)
    return out


def run(mix: dict, seed: int, seconds: float, send: Send,
        first: int = 0) -> Tuple[List[Request], float, float]:
    """The seed's schedule sent from ``senders`` threads.  Waits at most
    ``GRACE_S`` past the schedule's end for the last answers; the window
    ends at the last answer."""
    comps = compositions(mix)
    plan = schedule(mix, seed, seconds)
    reqs = [Request(first + i, c, comps[c][0], math.nan)
            for i, (_, c) in enumerate(plan)]
    pool = ThreadPoolExecutor(max_workers=mix["senders"],
                              thread_name_prefix="perfbench-sender")
    futures = []
    pending = True
    t0 = time.perf_counter()
    try:
        for req, (offset, _) in zip(reqs, plan):
            req.due = t0 + offset
            while True:
                left = req.due - time.perf_counter()
                if left <= 0:
                    break
                time.sleep(left)
            futures.append(pool.submit(deliver, send, req))
        _, pending = wait(futures, timeout=max(
            0.0, t0 + seconds + GRACE_S - time.perf_counter()))
    finally:
        # Every sender has ended unless an answer never came.
        pool.shutdown(wait=not pending, cancel_futures=True)
    end = max([r.done for r in reqs if r.answered] or [time.perf_counter()])
    return reqs, t0, end

"""Closed loop: one client sends its next request when the last one has
come back, cycling through every image set of the mix in an order
shuffled by the seed.  Each request is due when it is sent."""
from __future__ import annotations

import random
import time
from typing import List, Tuple

from perfbench.loadgen import Request, Send, compositions, deliver


def cycle(mix: dict, seed: int) -> List[int]:
    """The order of image sets: every one once, shuffled by the seed,
    then again."""
    order = list(range(len(compositions(mix))))
    random.Random(seed).shuffle(order)
    return order


def run(mix: dict, seed: int, seconds: float, send: Send,
        first: int = 0) -> Tuple[List[Request], float, float]:
    """Back to back until ``seconds`` have passed.  Returns the requests
    and the window (from the first send to the last answer)."""
    order = cycle(mix, seed)
    comps = compositions(mix)
    reqs: List[Request] = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        c = order[len(reqs) % len(order)]
        req = Request(first + len(reqs), c, comps[c][0], time.perf_counter())
        deliver(send, req)
        reqs.append(req)
    return reqs, t0, time.perf_counter()

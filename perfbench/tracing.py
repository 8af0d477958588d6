"""``torch.profiler`` over a traced stretch of a run, reduced to what the
per-layer readers and the result's ``breakdown`` need.

The stretch runs inside one annotation (``SPAN``), which gives its length
on the trace's clock.  Device operations are the profiler's kernel,
memcpy and memset records on the cell's cards (a copy captured in a CUDA
graph runs as a copy kernel or as a memcpy, so both count); a stretch between two of
them on a card is an idle gap, labelled by the shortest host event (a
PyTorch op, a CUDA runtime call or one of the harness's annotations) that
was running at its midpoint.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

OURS = "perfbench."
SPAN = OURS + "traced"
REQUEST = OURS + "request"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TAOM = "taom_gemm"
TOP = 10
NAME_CHARS = 96


@dataclasses.dataclass
class Trace:
    window_s: float                  # the annotated stretch
    busy_s: Dict[int, float]         # per card: time with a device op
    ops: Dict[str, List[float]]      # name -> [count, seconds over cards]
    launches: int                    # device operation records, all cards
    gaps: Dict[str, float]           # idle seconds over cards by host label

    @property
    def cards(self) -> int:
        return len(self.busy_s)

    @property
    def mean_busy_s(self) -> float:
        return sum(self.busy_s.values()) / max(self.cards, 1)

    def seconds(self, pick: Callable[[str], bool]) -> float:
        return sum(s for name, (_, s) in self.ops.items() if pick(name))

    @property
    def taom_s(self) -> float:
        return self.seconds(lambda name: TAOM in name)

    @property
    def other_s(self) -> float:
        return self.seconds(lambda name: TAOM not in name)

    def breakdown(self) -> dict:
        per = max(self.cards, 1)
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s / per] for n, (_, s) in ops],
                "idle_gaps": [[n[:NAME_CHARS], s / per] for n, s in gaps]}


def _kind(e) -> str:
    get = getattr(e, "activity_type", None)
    return get().lower() if get is not None else ""


def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _label(gaps: List[Tuple[int, int, int]], host) -> Dict[int, str]:
    """For each (midpoint, start, end) gap, the shortest host event that
    covers its midpoint (a sweep over midpoints in order)."""
    host = sorted(host, key=lambda h: h[0])
    heap: list = []
    labels: Dict[int, str] = {}
    i = 0
    for mid, s, e in sorted(gaps):
        while i < len(host) and host[i][0] <= mid:
            hs, he, name = host[i]
            heapq.heappush(heap, (he - hs, he, name))
            i += 1
        # Midpoints only grow, so an event that ended before this one is
        # dead for the rest: the top that is left is the shortest live one.
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        labels[mid] = heap[0][2] if heap else "no host event"
    return labels


def reduce(events, cards: Sequence[int]) -> Optional[Trace]:
    """The trace of one stretch, or None when the profiler saw no device
    operation in it."""
    span = [e for e in events if e.name() == SPAN
            and e.device_type() == DeviceType.CPU]
    if not span:
        return None
    s0, s1 = span[0].start_ns(), span[0].start_ns() + span[0].duration_ns()
    per_card: Dict[int, List[Tuple[int, int]]] = {c: [] for c in cards}
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    host = []
    for e in events:
        kind = _kind(e)
        if e.device_type() == DeviceType.CUDA:
            # The harness's own annotations are mirrored on the device's
            # timeline; they are no device operation.
            if (kind and kind not in DEVICE_KINDS) or \
                    e.name().startswith(OURS):
                continue
            c = e.device_index()
            if c not in per_card:
                continue
            start, dur = e.start_ns(), e.duration_ns()
            per_card[c].append((start, start + dur))
            row = ops[e.name()]
            row[0] += 1
            row[1] += dur * 1e-9
        elif e.name() != SPAN and (not kind or kind in HOST_KINDS):
            start = e.start_ns()
            host.append((start, start + e.duration_ns(), e.name()))
    if not ops:
        return None
    busy, gaps = {}, []
    for c, spans in per_card.items():
        merged = [(max(s, s0), min(e, s1)) for s, e in _merge(spans)
                  if e > s0 and s < s1]
        busy[c] = sum(e - s for s, e in merged) * 1e-9
        edges = [s0] + [x for se in merged for x in se] + [s1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append(((a + b) // 2, a, b))
    labels = _label(gaps, host)
    by_label: Dict[str, float] = defaultdict(float)
    for mid, a, b in gaps:
        by_label[labels[mid]] += (b - a) * 1e-9
    return Trace(window_s=(s1 - s0) * 1e-9, busy_s=busy, ops=dict(ops),
                 launches=sum(int(n) for n, _ in ops.values()),
                 gaps=dict(by_label))


def traced(fn: Callable[[], object], cards: Sequence[int]):
    """Run ``fn`` under the profiler: (its result, the Trace or None).  The
    device is synchronized before the stretch closes, so every operation
    that ``fn`` started is in it."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            out = fn()
            for c in cards:
                torch.cuda.synchronize(c)
    return out, reduce(prof.profiler.kineto_results.events(), cards)

"""Spans of the port's serving path, recorded only while a
``torch.profiler`` session is active.

A span is a named stretch of host time on one thread: its start and end
on ``time.perf_counter_ns()``'s clock, its own id, its parent's (the
innermost span open on the same thread), the request id of the
``serving.infer`` span it sits under, and the root's integer attributes
(``images``, ``chunks``).  Spans are kept in memory, the newest
``MAX_SPANS``; ``spans()`` returns them and ``clear()`` empties the
buffer.  Nothing is written to disk.

**One rule turns spans on:** a profiler session is running
(``torch.autograd.profiler._is_profiler_enabled``, which PyTorch sets
for the whole process while ``torch.profiler.profile`` is open).  There
is no switch.  With no session, a span site makes one call that returns a
shared no-op context: it allocates nothing and takes no lock.  While on,
each span also enters the profiler under its name
prefixed ``repro_torch.``, so it sits in the profiler's event stream, on
the clock of the device's records.  It enters as a function-scope record
(a ``cpu_op``), not through ``record_function``: the profiler mirrors a
``record_function`` range onto the device's timeline as a
``gpu_user_annotation`` as long as the kernels it launched, which a
device-trace reduction may count as a device operation (a graph replay's
range covers the whole forward).  The profiler records host events only
on the thread that opened it: spans on other threads (a pool of sender
threads) reach ``spans()`` but not its events.

The spans (``exec/serving.py``, ``exec/executor.py``):

* ``serving.infer`` — ``ServingEngine.infer``, the root: one request id;
  ``serving.pad`` — a chunk's zero padding (when it pads);
  ``serving.scatter``,
  ``serving.gather`` — the data-parallel bucket's chunks to the entries'
  cards and the logits back; ``serving.sync`` — the device-wide
  synchronize that ends a blocking request;
* ``executor.graph_wait`` — a captured forward's table and bucket locks,
  from entry until its graph's lock is held (not a capture);
  ``executor.copy_in``, ``executor.replay``, ``executor.clone_out`` —
  under that lock; ``executor.exchange`` — one batch |max| reduction and
  its scale copies between two GEMM segments of the data-parallel
  forward (``ShardedForward._lockstep``, eager or replaying graphs).

Operator's use: open a profiler session around the requests, then read
the spans (group them by ``request``)::

    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.infer(images)
    for s in trace.spans():
        print(s.request, s.name, (s.end_ns - s.start_ns) / 1e6, "ms")
    prof.export_chrome_trace("serving.json")  # the same spans, named
                                               # repro_torch.<span>
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Span", "MAX_SPANS", "PREFIX", "span", "request", "spans",
           "clear"]

#: The profiler's name of a span is its own under this prefix.
PREFIX = "repro_torch."
#: Spans kept in memory, the newest.
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    attrs: Dict[str, int]


class _Off:
    """The shared context of a span site while no session is open."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, kind, value, tb) -> bool:
        return False


_OFF = _Off()
_NO_ATTRS: Dict[str, int] = {}
_buffer: "deque[Span]" = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()


class _Open:
    """One span while it is open on its thread."""

    __slots__ = ("name", "attrs", "root", "id", "parent", "request",
                 "outer", "start", "fn")

    def __init__(self, name: str, attrs: Dict[str, int], root: bool):
        self.name, self.attrs, self.root = name, attrs, root

    def __enter__(self) -> "_Open":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.request = None
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.outer = _local.request
        if self.root:
            _local.request = next(_requests)
        self.request = _local.request
        stack.append(self.id)
        self.fn = _RecordFunctionFast(PREFIX + self.name)
        self.fn.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        _local.stack.pop()
        _local.request = self.outer
        _buffer.append(Span(self.name, self.start, end, self.id,
                            self.parent, self.request, self.attrs))
        return False


def span(name: str):
    """A context that records span ``name`` while a profiler session is
    open, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, _NO_ATTRS, False)


def request(name: str, images: int, chunks: int):
    """``span`` for the root of a served request: it draws a new request
    id, which every span opened under it on this thread carries."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, {"images": images, "chunks": chunks}, True)


def spans() -> List[Span]:
    """The recorded spans, oldest first (each is appended as it closes)."""
    return list(_buffer)


def clear() -> None:
    _buffer.clear()

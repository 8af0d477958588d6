"""The CUDA-graph capture routines for the port's compiled paths: the CNN
forward (``exec.executor.CompiledForward``, and a graph a segment for each
shard of ``ShardedForward``) and the LM decode step
(``launch.serve.DecodeGraph``), the port's counterparts of ``jax.jit``.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

import torch

T = TypeVar("T")

# Captures run one at a time in the process: a capture must not see
# another thread's work on its stream.
_CAPTURE_LOCK = threading.Lock()


def capture(fn: Callable[[], T], device: torch.device,
            warm: Optional[Callable[[], object]] = None
            ) -> Tuple["torch.cuda.CUDAGraph", T]:
    """Capture ``fn()`` in a CUDA graph on ``device``; returns the graph
    and what ``fn`` returned inside the capture (the graph's static
    outputs, which each replay rewrites).

    ``warm()`` (``fn`` by default) runs eagerly on a side stream first, so
    first-use costs (a kernel's build, library handles, lazy module loads)
    never happen inside the capture; then ``fn`` is captured on that
    stream.  Captures take a process-wide lock and run in thread-local
    error mode, so another thread's CUDA calls neither break a capture nor
    fail because of it.  Each graph gets its own memory pool.  Unlike
    ``torch.cuda.graph``, this leaves the allocator's cache as it is: the
    eager work after a capture (a prefill, another request) does not pay
    ``cudaMalloc`` again.  A capture that fails raises.
    """
    return capture_all([fn], device, warm or fn)[0]


def capture_all(fns: Sequence[Callable[[], T]], device: torch.device,
                warm: Optional[Callable[[], object]] = None
                ) -> List[Tuple["torch.cuda.CUDAGraph", T]]:
    """Capture each of ``fns`` in turn into a graph of its own, as
    ``capture`` does, on one side stream and in one memory pool: the
    graphs are to be replayed in this order, each reading what the ones
    before it left in the pool.  ``warm()``, if given, runs first."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    pool = torch.cuda.graph_pool_handle()
    captured = []
    with torch.cuda.stream(side):
        if warm is not None:
            warm()
        with _CAPTURE_LOCK:
            for fn in fns:
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
                captured.append((graph, out))
    current.wait_stream(side)
    return captured

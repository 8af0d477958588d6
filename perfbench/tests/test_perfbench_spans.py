"""The readers of the port's own spans (``perfbench/program_spans.py`` and
the four metrics that use it) on synthetic span lists, and on the card:
the program's annotations leave the device trace's operation count as it
is."""
import contextlib
import sys
import types

import pytest
import torch

from perfbench import harness, loadgen, program_spans, tracing
from repro_torch.runtime import trace
from repro_torch.runtime.trace import Span

MS = 1_000_000          # ns


class _Spans:
    """Builds a span list: requests of the port, each a root and its
    children, on one ns clock."""

    def __init__(self):
        self.spans, self.ids = [], 0

    def request(self, rid, start, children, images=8, chunks=1,
                length=None):
        """``children``: (name, start offset, length) in ns."""
        end = start + (length if length is not None else
                       max((o + n for _, o, n in children), default=0) + 1)
        self.ids += 1
        root = self.ids
        for name, off, n in children:
            self.ids += 1
            self.spans.append(Span(name, start + off, start + off + n,
                                   self.ids, root, rid, {}))
        self.spans.append(Span(program_spans.ROOT, start, end, root, None,
                               rid, {"images": images, "chunks": chunks}))
        return end


def _run(sent_ns, done_ns):
    req = loadgen.Request(0, 0, 8, sent_ns * 1e-9, sent_ns * 1e-9,
                          done_ns * 1e-9)
    return types.SimpleNamespace(traced=[req])


@pytest.fixture
def spans(monkeypatch):
    made = _Spans()
    monkeypatch.setattr(trace, "spans", lambda: list(made.spans))
    return made


def test_p95_is_over_requests_of_summed_spans(spans):
    """Twenty requests, each with two waits of i ms and 1 ms: the p95 of
    the sums (i + 1), not of single spans; a request with none reads 0."""
    t = 10 * MS
    for i in range(20):
        t = spans.request(i, t, [("executor.graph_wait", 0, i * MS),
                                 ("executor.graph_wait", i * MS, MS),
                                 ("serving.sync", (i + 1) * MS, 2 * MS)])
    t = spans.request(20, t, [("serving.sync", 0, 2 * MS)])
    run = _run(10 * MS, t)
    sums = [float(i + 1) for i in range(20)] + [0.0]
    got = harness.reader("graph_wait_ms_p95")(run)
    assert got == pytest.approx(loadgen.percentile(sums, 95))
    single = loadgen.percentile([float(i) for i in range(20)] + [1.0] * 20,
                                95)
    assert got != pytest.approx(single)
    assert harness.reader("sync_wait_ms_p95")(run) == pytest.approx(2.0)


def test_only_the_traced_requests_interval_counts(spans):
    """An earlier stretch that was traced again (before the first send)
    and spans after the last answer are left out."""
    spans.request(1, 0, [("serving.sync", 0, 500 * MS)])
    t = spans.request(2, 1000 * MS, [("serving.sync", 0, 3 * MS)])
    spans.request(3, t + MS, [("serving.sync", 0, 700 * MS)])
    run = _run(1000 * MS, t)
    assert harness.reader("sync_wait_ms_p95")(run) == pytest.approx(3.0)
    assert program_spans.requests(run) == [
        {program_spans.ROOT: pytest.approx(3 * MS * 1e-9 + 1e-9),
         "serving.sync": pytest.approx(3e-3), "images": 8, "chunks": 1}]


def test_per_forward_readers_divide_by_the_chunks(spans):
    """Two requests of 2 and 1 forwards: 9 ms of infer less 3 of sync,
    and 3 exchanges of 1 ms, over 3 forwards."""
    t = spans.request(1, 0, [("executor.exchange", 0, MS),
                             ("executor.exchange", MS, MS),
                             ("serving.sync", 2 * MS, 2 * MS)],
                      chunks=2, length=6 * MS)
    t = spans.request(2, t, [("executor.exchange", 0, MS),
                             ("serving.sync", MS, MS)], length=3 * MS)
    run = _run(0, t)
    assert harness.reader("host_ms_per_forward")(run) == pytest.approx(2.0)
    assert harness.reader("exchange_ms_per_forward")(run) == \
        pytest.approx(1.0)


@pytest.mark.parametrize("case", ["no spans", "no traced requests",
                                  "no such span", "no recorder"])
def test_nothing_to_read_is_none(spans, monkeypatch, case):
    t = 0
    if case != "no spans":
        t = spans.request(1, 0, [("serving.sync", 0, MS)])
    run = _run(0, max(t, MS))
    if case == "no traced requests":
        run.traced = []
    if case == "no recorder":          # a port without the span recorder
        monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
        monkeypatch.delattr(sys.modules["repro_torch.runtime"], "trace")
    names = ["graph_wait_ms_p95", "exchange_ms_per_forward"]
    if case != "no such span":
        names += ["sync_wait_ms_p95", "host_ms_per_forward"]
    for name in names:
        assert harness.reader(name)(run) is None, name


@pytest.mark.gpu
def test_program_spans_leave_the_device_operations_as_they_are(
        monkeypatch):
    """``tracing.traced`` over the same requests counts the same device
    operations with the program's spans on as with them off (the parent's
    program): their mirrored ``gpu_user_annotation`` records are no device
    operation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.perf_model import AcceleratorConfig
    from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
    from repro_torch.exec import PlanCache, ServingEngine
    from repro_torch.models.zoo_cnn import ZOO
    cuda = torch.device("cuda")
    model = ZOO["resnet_mini"]
    params = model.init_params(torch.Generator().manual_seed(0), device=cuda)
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    engine = ServingEngine(params, acc, cfg, lowering=model.graph,
                           in_hw=model.in_hw, max_batch=8,
                           plan_cache=PlanCache(), device=cuda)
    engine.warmup()
    gen = torch.Generator(device=cuda).manual_seed(3)
    xs = [torch.randn(n, *model.in_hw, model.in_ch, device=cuda,
                      generator=gen) for n in (1, 3, 8, 5, 8, 2)]

    def serve():
        for x in xs:
            engine.infer(x)

    def launches(spans_on):
        off = contextlib.nullcontext()
        with monkeypatch.context() as m:
            if not spans_on:
                m.setattr(trace, "span", lambda name: off)
                m.setattr(trace, "request", lambda name, i, c: off)
            trace.clear()
            _, tr = tracing.traced(serve, [0])
        return tr, trace.spans()

    counts = {}
    for spans_on in (False, True, False, True):
        tr, got = launches(spans_on)
        assert tr is not None and bool(got) == spans_on
        assert not any(name.startswith(trace.PREFIX) for name in tr.ops)
        counts.setdefault(spans_on, []).append(tr.launches)
        if spans_on:
            names = {s.name for s in got}
            assert {"serving.infer", "executor.graph_wait",
                    "executor.replay", "serving.sync"} <= names
    off, on = max(counts[False]), max(counts[True])
    assert abs(on - off) <= 0.01 * off, counts

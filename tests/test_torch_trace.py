"""The span recorder (``repro_torch.runtime.trace``) on a CPU
``ServingEngine``: spans only under a profiler session, nested under one
request id a request, one id a thread's request, the profiler's own
host record of each span, one ``executor.exchange`` a GEMM node a
forward on the data-parallel path; and ``stats()["sustained_ips"]`` over
the wall time with a request in flight."""
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.perf_model import AcceleratorConfig
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import PlanCache, ServingEngine
from repro_torch.models.zoo_cnn import ZOO
from repro_torch.runtime import trace


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while these small forwards run beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.clear()
    yield
    torch.set_num_threads(threads)
    trace.clear()


def _engine(max_batch=4, **kw):
    model = ZOO["small_cnn"]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=acc.n,
                         noise_enabled=False)
    engine = ServingEngine(params, acc, cfg, lowering=model.graph,
                           in_hw=model.in_hw, max_batch=max_batch,
                           device="cpu", plan_cache=PlanCache(), **kw)
    engine.warmup()
    return model, engine


def _images(model, n, seed=1):
    return torch.randn((n, *model.in_hw, model.in_ch),
                       generator=torch.Generator().manual_seed(seed))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_no_spans():
    model, engine = _engine()
    for n in (1, 3, 6):
        engine.infer(_images(model, n))
    assert trace.spans() == []


@pytest.mark.parametrize("n,counts", [
    (3, {"serving.pad": 1, "serving.validate": 1}),
    (4, {"serving.validate": 1}),
    (7, {"serving.pad": 1, "serving.validate": 2}),   # chunks of 4 and 3
])
def test_one_request_spans_under_one_request_id(n, counts):
    model, engine = _engine()
    x = _images(model, n)
    with _cpu_profile() as prof:
        engine.infer(x)
    got = trace.spans()
    root, = [s for s in got if s.name == "serving.infer"]
    assert root.parent is None and root.request is not None
    assert root.attrs == {"images": n, "chunks": -(-n // 4)}
    want = dict(counts, **{"serving.infer": 1, "serving.sync": 1})
    assert {name: sum(s.name == name for s in got) for name in want} == want
    assert len(got) == sum(want.values())
    for s in got:
        assert s.request == root.request
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        if s is not root:
            assert s.parent == root.id
    host = {e.name() for e in prof.profiler.kineto_results.events()
            if e.activity_type() == "cpu_op"
            and e.device_type() == torch.autograd.DeviceType.CPU}
    assert {trace.PREFIX + name for name in want} <= host


def test_threads_carry_their_own_request_ids():
    """More sender threads than cores, switching often: every request
    gets an id of its own, every span its parent's id, and no request is
    left in flight."""
    model, engine = _engine()
    n_threads = (os.cpu_count() or 4) + 1
    xs = [_images(model, i % 4 + 1, seed=i) for i in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def send(x):
        barrier.wait()
        for _ in range(2):
            engine.infer(x)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=send, args=(x,)) for x in xs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    got = trace.spans()
    roots = [s for s in got if s.name == "serving.infer"]
    assert len(roots) == 2 * n_threads
    assert len({s.request for s in roots}) == 2 * n_threads
    assert sorted(s.attrs["images"] for s in roots) == sorted(
        2 * [x.shape[0] for x in xs])
    by_id = {s.id: s for s in got}
    for s in got:
        if s.parent is not None:
            parent = by_id[s.parent]
            assert s.request == parent.request
            assert parent.start_ns <= s.start_ns <= s.end_ns <= \
                parent.end_ns
    assert engine._in_flight == 0
    assert engine.stats()["requests"] == 2 * n_threads


@pytest.mark.parametrize("n_dev,n,forwards", [(2, 4, 1), (2, 8, 2),
                                              (4, 4, 1)])
def test_data_parallel_one_exchange_per_gemm_node(n_dev, n, forwards):
    model, engine = _engine(data_parallel=True, devices=["cpu"] * n_dev)
    assert engine.data_parallel
    with _cpu_profile():
        engine.infer(_images(model, n))
    got = trace.spans()
    root, = [s for s in got if s.name == "serving.infer"]
    count = {name: sum(s.name == name for s in got)
             for name in ("executor.exchange", "serving.scatter",
                          "serving.gather")}
    assert count == {"executor.exchange":
                     len(model.graph.gemm_nodes) * forwards,
                     "serving.scatter": forwards,
                     "serving.gather": forwards}
    assert all(s.request == root.request for s in got)


def test_sustained_ips_counts_overlapping_requests_once(monkeypatch):
    """Four requests in flight together: images over the wall time with
    one in flight, not over the sum of their durations (which would read
    about four times lower)."""
    model, engine = _engine()
    sync = engine._sync

    def slow_sync():
        sync()
        time.sleep(0.05)

    monkeypatch.setattr(engine, "_sync", slow_sync)
    x = _images(model, 2)
    barrier = threading.Barrier(4)

    def send():
        barrier.wait()
        engine.infer(x)

    threads = [threading.Thread(target=send) for _ in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    wall = time.perf_counter() - t0
    s = engine.stats()
    assert s["requests"] == 4 and s["images"] == 8
    assert s["sustained_ips"] >= 8 / wall
    summed = s["latency_mean_s"] * 4
    assert s["sustained_ips"] > 2 * 8 / summed
    # a request that raises leaves no request in flight
    with pytest.raises(Exception):
        engine.infer(torch.zeros((1, *model.in_hw, model.in_ch + 1)))
    assert engine._in_flight == 0
    assert engine.stats()["requests"] == 4

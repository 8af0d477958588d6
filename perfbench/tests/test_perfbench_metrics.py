"""The metric arithmetic, the load generator, and one short run of cell 1
on the card."""
import json
import math
import subprocess
import sys
import threading
import time

import pytest
import torch

from perfbench import harness, loadgen, peaks, tracing


def test_depthwise_bound_counts_the_layers_own_work():
    """A depthwise layer is C instances of (M, k*k, 1): its k*k*C weights
    and k*k*C*M multiply-adds, not the block-diagonal GEMM's."""
    m, c = 112 * 112, 96
    ops = peaks.gemm_ops(m, 9, 1, c)
    nbytes = peaks.gemm_bytes(m, 9, 1, c)
    assert ops == 2 * m * 9 * c
    assert nbytes == 4 * (m * 9 + 9 + m) * c
    assert peaks.gemm_bound_s(m, 9, 1, c) == max(
        ops / peaks.INT8_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
    block_diag = peaks.gemm_ops(m, 9 * c, c, 1)
    assert block_diag == c * ops
    # the classifier's one row an image scales with the images
    assert peaks.forward_bound_s([(1, 2048, 1000, 1)], 64) == \
        peaks.gemm_bound_s(64, 2048, 1000, 1)


def test_tail_is_over_all_requests():
    """The 95th percentile of every latency, not a median of per-chunk
    tails: 100 requests of 1 ms and 10 of 100 ms."""
    lat = [1.0] * 100 + [100.0] * 10
    assert loadgen.percentile(lat, 95) == 100.0
    chunks = [lat[i:i + 10] for i in range(0, 110, 10)]
    median_of_chunks = sorted(loadgen.percentile(c, 95) for c in chunks)[5]
    assert median_of_chunks == 1.0
    assert loadgen.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert loadgen.percentile(list(range(101)), 95) == 95.0


def test_open_loop_schedule_is_the_seeds_poisson_process():
    """The same seed gives the same arrivals, another seed others; the
    arrivals are a Poisson process at the mix's rate: their count, the
    gaps' mean and spread, and counts a second spread as a Poisson count
    does (variance over mean near 1; smoothed arrivals read far under)."""
    mix = {"sizes": [1, 2, 3, 4, 5, 6, 7, 8], "variants": 4,
           "rate_per_s": 400, "loop": "open"}
    schedule = harness.loop("open").schedule
    a = schedule(mix, 2 ** 40 + 7, 15)
    assert a == schedule(mix, 2 ** 40 + 7, 15)
    b = schedule(mix, 2 ** 40 + 8, 15)
    assert a != b
    for plan in (a, b):
        n = len(plan)
        assert abs(n - 6000) < 5 * math.sqrt(6000)
        assert all(0 < t0 < t1 < 15 for (t0, _), (t1, _)
                   in zip(plan, plan[1:]))
        gaps = [t1 - t0 for (t0, _), (t1, _) in zip(plan, plan[1:])]
        mean = sum(gaps) / len(gaps)
        sd = math.sqrt(sum((g - mean) ** 2 for g in gaps) / len(gaps))
        assert mean == pytest.approx(1 / 400, rel=0.05)
        assert sd / mean == pytest.approx(1.0, abs=0.05)
        per_s = [0] * 15
        for t, _ in plan:
            per_s[int(t)] += 1
        m = sum(per_s) / 15
        var = sum((c - m) ** 2 for c in per_s) / 14
        assert 0.3 < var / m < 2.5
        sets = [c for _, c in plan]
        assert set(sets) == set(range(len(loadgen.compositions(mix))))


def test_lateness_and_latency_from_the_due_time():
    """A request sent late is timed from when it was due: a sender that
    is busy makes the next request late, and its latency holds the wait."""
    mix = {"loop": "open", "sizes": [1], "variants": 1, "rate_per_s": 100,
           "senders": 1}

    def send(req):
        time.sleep(0.05)
        req.logits = torch.zeros(1)

    reqs, t0, t1 = loadgen.run(mix, 5, 0.5, send)
    plan = harness.loop("open").schedule(mix, 5, 0.5)
    assert len(reqs) == len(plan) >= 35 and all(r.answered for r in reqs)
    assert [r.due - t0 for r in reqs] == pytest.approx([t for t, _ in plan])
    assert not any(t.name.startswith("perfbench-sender")
                   for t in threading.enumerate())
    for r in reqs:
        assert r.late_s >= 0 and r.latency_s >= r.done - r.sent
        assert math.isclose(r.latency_s, r.late_s + (r.done - r.sent))
    # one sender at 0.05 s a request falls behind a 100/s schedule
    assert reqs[-1].late_s > 1.0
    assert t1 >= reqs[-1].done


def test_closed_loop_cycles_every_image_set():
    mix = {"loop": "closed", "sizes": [2], "variants": 3}
    seen = []

    def send(req):
        seen.append(req.comp)
        req.logits = torch.zeros(2)
        time.sleep(0.01)

    reqs, t0, t1 = loadgen.run(mix, 9, 0.2, send)
    assert len(reqs) >= 6 and sorted(seen[:3]) == [0, 1, 2]
    assert seen[3:6] == seen[:3]


class _Event:
    """A stand-in for the profiler's event record."""

    def __init__(self, name, kind, dev, start, dur, index=0):
        self._v = (name, kind, dev, start, dur, index)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def device_index(self):
        return self._v[5]


def test_trace_reduction():
    from torch.autograd import DeviceType
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ev = [_Event(tracing.SPAN, "user_annotation", cpu, 0, 1000),
          _Event(tracing.SPAN, "gpu_user_annotation", gpu, 0, 1000),
          _Event(tracing.REQUEST, "kernel", gpu, 0, 900),
          _Event("void taom_gemm_int8_kernel<1>", "kernel", gpu, 100, 200),
          _Event("im2col_cat", "kernel", gpu, 250, 100),
          _Event("Memcpy DtoD", "gpu_memcpy", gpu, 600, 100),
          _Event("cudaGraphLaunch", "cuda_runtime", cpu, 360, 200),
          _Event("aten::copy_", "cpu_op", cpu, 300, 500)]
    tr = tracing.reduce(ev, [0])
    approx = pytest.approx
    assert tr.window_s == approx(1000e-9)
    assert tr.busy_s == {0: approx(350e-9)}
    assert tr.launches == 3
    assert tr.taom_s == approx(200e-9) and tr.other_s == approx(200e-9)
    # gaps: [0,100) and [700,1000) under no host event, [350,600) under
    # the graph launch (shorter than the copy around it)
    assert tr.gaps == {"cudaGraphLaunch": approx(250e-9),
                       "no host event": approx(400e-9)}
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["void taom_gemm_int8_kernel<1>",
                                   approx(200e-9)]
    assert tracing.reduce(ev[:2], [0]) is None


@pytest.mark.gpu
def test_cell1_runs_on_the_card():
    """Cell 1 for 3 seconds through run.py: correct, and every end-to-end
    metric of the cell in the result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "resnet50-heana4.offline-b64", "--seed", str(2 ** 32 + 3),
         "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"images_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu"

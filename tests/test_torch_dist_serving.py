"""Data-parallel serving on the CPU: ``ServingEngine(data_parallel=True,
devices=["cpu", "cpu"])`` (a repeated entry: two replicas on one device)
against the one-device engine, and the serving_engine example's §4.

The data-parallel logits must be BITWISE equal to the one-device
engine's for every bucket (the reference's claim for its GSPMD path): a
bucket is split over the entries and the shards share each layer's
quantize scale (``executor.ShardedForward``).  A shard served alone —
its own scale — differs, which is what the shared scale is for."""
import importlib.util
import os

import pytest
import torch

from repro_torch.core.perf_model import AcceleratorConfig
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import ServingEngine, report, trace_count
from repro_torch.models.zoo_cnn import ZOO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while these small forwards run: the suite runs
    beside other workers, and PyTorch's pool of one thread a core then
    spends its time waiting for cores, not computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engines(backend, n_dev=2, net="resnet_mini", max_batch=8):
    zoo = ZOO[net]
    params = zoo.init_params(torch.Generator().manual_seed(0), device="cpu")
    acc = AcceleratorConfig.equal_area(backend.value, Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=backend, bits=6, dpe_size=acc.n,
                         noise_enabled=False)
    kw = dict(lowering=zoo.graph, in_hw=zoo.in_hw, max_batch=max_batch,
              device="cpu")
    one = ServingEngine(params, acc, cfg, **kw)
    dp = ServingEngine(params, acc, cfg, data_parallel=True,
                       devices=["cpu"] * n_dev, plan_cache=one.plan_cache,
                       **kw)
    return zoo, one, dp


@pytest.mark.parametrize("backend,n_dev", [(Backend.HEANA, 2),
                                           (Backend.MAW, 2),
                                           (Backend.HEANA, 4)])
def test_data_parallel_logits_bit_equal_every_bucket(backend, n_dev):
    zoo, one, dp = _engines(backend, n_dev)
    assert dp.data_parallel and dp.devices == [torch.device("cpu")] * n_dev
    dp.warmup()
    one.warmup()
    traces = trace_count()
    gen = torch.Generator().manual_seed(1)
    for n in (1, 2, 3, 4, 7, 8, 19):      # every bucket, a chunked request
        x = torch.randn((n, *zoo.in_hw, zoo.in_ch), generator=gen)
        assert torch.equal(dp.infer(x), one.infer(x)), n
    assert trace_count() == traces
    assert dp.stats()["retraces_since_warmup"] == 0
    # the shards share each layer's scale: a shard served alone differs
    x = torch.randn((8, *zoo.in_hw, zoo.in_ch), generator=gen)
    x[: 8 // n_dev] *= 0.25
    whole = one.infer(x)
    assert torch.equal(dp.infer(x), whole)
    assert not torch.equal(one.infer(x[: 8 // n_dev]), whole[: 8 // n_dev])


def test_data_parallel_with_noise_raises():
    zoo = ZOO["small_cnn"]
    params = zoo.init_params(torch.Generator().manual_seed(0), device="cpu")
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    noisy = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                           noise_enabled=True)
    for devices in (["cpu", "cpu"], ["cpu"]):
        with pytest.raises(ValueError, match="noise_enabled=False"):
            ServingEngine(params, acc, noisy, lowering=zoo.graph,
                          in_hw=zoo.in_hw, max_batch=2, device="cpu",
                          data_parallel=True, devices=devices)


def test_data_parallel_needs_more_than_one_entry():
    zoo = ZOO["small_cnn"]
    params = zoo.init_params(torch.Generator().manual_seed(0), device="cpu")
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    kw = dict(lowering=zoo.graph, in_hw=zoo.in_hw, max_batch=2,
              device="cpu", data_parallel=True)
    for devices in (None, ["cpu"]):
        eng = ServingEngine(params, acc, cfg, devices=devices, **kw)
        assert eng.data_parallel is False
        assert eng.devices == [torch.device("cpu")]
        assert eng.stats()["n_devices"] == 1
        assert eng.stats()["data_parallel"] is False


def test_data_parallel_stats_and_report():
    zoo, one, dp = _engines(Backend.HEANA, 2, net="small_cnn", max_batch=4)
    dp.warmup()
    x = torch.randn((3, *zoo.in_hw, zoo.in_ch),
                    generator=torch.Generator().manual_seed(2))
    dp.infer(x)
    s = dp.stats()
    assert (s["data_parallel"], s["n_devices"]) == (True, 2)
    assert (s["requests"], s["images"], s["padded_slots"]) == (1, 3, 1)
    assert s["retraces_since_warmup"] == 0
    rec = report.serving_summary("small_cnn", 4, s, 1.0, 1.0)
    assert (rec["data_parallel"], rec["n_devices"]) == (True, 2)
    s1 = one.stats()
    assert (s1["data_parallel"], s1["n_devices"]) == (False, 1)


def test_serving_engine_example_runs_data_parallel_section(capsys):
    spec = importlib.util.spec_from_file_location(
        "serving_engine_dp", os.path.join(ROOT, "examples_torch",
                                          "serving_engine.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--devices", "cpu,cpu"])
    printed = capsys.readouterr().out
    assert "data-parallel over 2 devices: logits bitwise equal to " \
        "single-device = True" in printed
    assert "data-parallel skipped" not in printed
    assert out["n_devices"] == 2 and out["data_parallel_equal"] is True

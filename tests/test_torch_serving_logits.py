"""The serving engine's logits-only forward (``executor.compiled_logits``)
on the CPU: its memoized wrapper is never ``compiled_forward``'s, the
engine's served logits equal ``execute_cnn``'s bit for bit, the engine
computes no fingerprints (``executor.FINGERPRINT_CALLS``), and
``execute_cnn``'s fingerprints are still the mean |activation| of each
GEMM node."""
import pytest
import torch

from repro_torch.core.perf_model import AcceleratorConfig
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import (PlanCache, ServingEngine, compiled_forward,
                              compiled_logits, execute_cnn, plan_for_network)
from repro_torch.exec import executor
from repro_torch.models.zoo_cnn import ZOO

ACC = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
CFG = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                     noise_enabled=False)
MODEL = ZOO["resnet_mini"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread while these small forwards run beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    return MODEL.init_params(torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def engine(params):
    eng = ServingEngine(params, ACC, CFG, lowering=MODEL.graph,
                        in_hw=MODEL.in_hw, max_batch=8, device="cpu",
                        plan_cache=PlanCache())
    eng.warmup()
    return eng


def _images(n: int, seed: int) -> torch.Tensor:
    return torch.randn(n, *MODEL.in_hw, MODEL.in_ch,
                       generator=torch.Generator().manual_seed(seed))


def test_logits_wrapper_is_memoized_apart_from_compiled_forward(params):
    plan = plan_for_network(params, ACC, batch=4, in_hw=MODEL.in_hw,
                            lowering=MODEL.graph, cache=PlanCache())
    plan2 = plan_for_network(params, ACC, batch=4, in_hw=MODEL.in_hw,
                             lowering=MODEL.graph, cache=PlanCache())
    fn = compiled_logits(plan, CFG, MODEL.graph)
    assert compiled_logits(plan2, CFG, MODEL.graph) is fn
    assert compiled_logits(plan, CFG, MODEL.graph, "ref") is not fn
    for collect in (False, True):
        assert compiled_forward(plan, CFG, MODEL.graph,
                                collect_activations=collect) is not fn
    assert compiled_logits(plan, CFG, MODEL.graph) is fn
    x = _images(4, 1)
    logits = fn(params, x)
    assert isinstance(logits, torch.Tensor)
    assert torch.equal(logits, compiled_forward(plan, CFG, MODEL.graph)(
        params, x)[0])


@pytest.mark.parametrize("n,bucket", [(1, 1), (3, 4), (8, 8)])
def test_served_logits_equal_execute_cnn(engine, params, n, bucket):
    """Bucket 1, batch 3 zero-padded into bucket 4, and bucket 8: the
    engine's rows are ``execute_cnn``'s logits of the padded batch on
    the bucket's plan, bit for bit."""
    x = _images(n, 10 + n)
    got = engine.infer(x)
    padded = torch.cat([x, x.new_zeros((bucket - n,) + tuple(x.shape[1:]))])
    want = execute_cnn(params, padded, engine.plans[bucket], CFG,
                       lowering=MODEL.graph, device="cpu").logits[:n]
    assert got.shape == (n, MODEL.num_classes)
    assert torch.equal(got, want)
    assert want.abs().max() > 0


@pytest.mark.parametrize("compiled", [False, True])
def test_engine_computes_no_fingerprints(params, compiled):
    """An engine's warm-up and requests leave ``FINGERPRINT_CALLS`` where
    it was; each ``execute_cnn`` adds one (on the CPU the compiled
    wrapper runs the eager body too)."""
    before = executor.FINGERPRINT_CALLS
    eng = ServingEngine(params, ACC, CFG, lowering=MODEL.graph,
                        in_hw=MODEL.in_hw, max_batch=4, device="cpu",
                        plan_cache=PlanCache())
    eng.warmup()
    for n in (1, 3, 4, 6):
        eng.infer(_images(n, 20 + n))
    assert executor.FINGERPRINT_CALLS == before
    x = _images(2, 30)
    for i in range(1, 3):
        execute_cnn(params, x, eng.plans[2], CFG, lowering=MODEL.graph,
                    device="cpu", compiled=compiled)
        assert executor.FINGERPRINT_CALLS == before + i


@pytest.mark.parametrize("compiled", [False, True])
def test_fingerprints_are_the_mean_abs_activation(params, compiled):
    plan = plan_for_network(params, ACC, batch=2, in_hw=MODEL.in_hw,
                            lowering=MODEL.graph, cache=PlanCache())
    res = execute_cnn(params, _images(2, 40), plan, CFG,
                      lowering=MODEL.graph, device="cpu",
                      collect_activations=True, compiled=compiled)
    assert len(res.activations) == len(MODEL.graph.gemm_nodes)
    assert res.fingerprints.shape == (len(res.activations),)
    want = torch.stack([a.abs().sum() * (1.0 / a.numel())
                        for a in res.activations])
    assert torch.equal(res.fingerprints, want)
    mean = torch.stack([a.abs().double().mean() for a in res.activations])
    torch.testing.assert_close(res.fingerprints.double(), mean,
                               rtol=1e-5, atol=0.0)
    assert [t.out_mean_abs for t in res.traces] == want.tolist()

"""Port conformance for the slice as a whole: execute_cnn and ServingEngine
on resnet_mini (here) and small_cnn (test_torch_slice_small.py), on the
CPU, against the reference package.

Params come from the reference's own ``init_params`` (carried across with
``params_from_jax``) and images from a seeded numpy generator.  The
reference side is its eager path (``reference_forward`` and the executor
with ``compiled=False``), never its compiled one or its golden JSONs.

Tolerance: every GEMM activation up to the first reduction whose order can
differ between XLA and PyTorch — resnet_mini's global average pool — is
bit-equal.  After it (resnet_mini's fc layer and logits) a reordered mean
can move the fc input by an ULP, which can move the quantize scale and tip
an ADC rounding: the logits may differ by at most one ADC step of the fc
layer in logit units, step * sx * sw[d].  The mean-|activation|
fingerprints are f32 sums of n terms taken in a different order: relative
tolerance 2 * n * 2^-24, the bound of the two summations' errors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jexec
from repro.core import perf_model as jpm
from repro.core.types import Backend as JBackend
from repro.core.types import Dataflow as JDataflow
from repro.core.types import PhotonicConfig as JConfig
from repro.models.zoo_cnn import ZOO as JZOO

from repro_torch.core import perf_model as tpm
from repro_torch.core.taom import quantize
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import (PlanCache, ServingEngine, execute_cnn,
                              plan_for_network, reference_forward)
from repro_torch.kernels.ops import photonic_matmul
from repro_torch.kernels.taom_gemm import _adc_constants, calibrated_adc_fs
from repro_torch.models import lowering as lw
from repro_torch.models.lowering import params_from_jax
from repro_torch.models.zoo_cnn import ZOO

JACC = jpm.AcceleratorConfig.equal_area("heana", JDataflow.OS, 1.0)
TACC = tpm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
JCFG = JConfig(backend=JBackend.HEANA, bits=6, dpe_size=83,
               noise_enabled=False)
TCFG = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                      noise_enabled=False)
BATCH = 3


def _reference_run(name: str) -> dict:
    """One network run once through the reference's eager executor."""
    jmodel, model = JZOO[name], ZOO[name]
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(
        (BATCH, *model.in_hw, model.in_ch)).astype(np.float32)
    jplan = jexec.plan_for_network(jparams, JACC, batch=BATCH,
                                   in_hw=model.in_hw, lowering=jmodel.graph,
                                   cache=jexec.PlanCache())
    jres = jexec.execute_cnn(jparams, jnp.asarray(x), jplan, JCFG,
                             impl="ref", lowering=jmodel.graph,
                             collect_activations=True, compiled=False)
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    return {
        "name": name, "model": model, "jmodel": jmodel, "jparams": jparams,
        "params": params, "x": x,
        "jlogits": np.asarray(jres.logits),
        "jacts": [np.asarray(a) for a in jres.activations],
        "jfp": np.asarray(jres.fingerprints),
    }


def _first_reduction(model) -> int:
    """Index of the first GEMM node fed (directly or not) by a global
    pool — from there on results may differ by reduction order."""
    seen_global = False
    for node in model.graph.nodes:
        if node.op == "pool" and node.pool == "global":
            seen_global = True
        if node.op in ("conv", "depthwise_conv", "fc") and seen_global:
            return [n.name for n in model.graph.gemm_nodes].index(node.name)
    return len(model.graph.gemm_nodes)


def _fc_lsb(net) -> np.ndarray:
    """One ADC step of the fc layer in logit units, per output column."""
    graph = net["model"].graph
    vals = lw.graph_forward(
        net["params"], torch.from_numpy(net["x"]), graph,
        lambda a, w, i, node: photonic_matmul(a, w, TCFG, impl="ref"))
    fc_input = vals[graph.node("fc").inputs[0]].reshape(BATCH, -1)
    w = net["params"]["fc"]
    _, sx = quantize(fc_input, TCFG.bits)
    _, sw = quantize(w, TCFG.bits, axis=0)
    step, _, _ = _adc_constants(TCFG.adc_bits,
                                calibrated_adc_fs(w.shape[0], TCFG))
    return (np.float64(step) * sx.double() * sw.double()).numpy()[0]


def _check_logits(net, got: np.ndarray) -> None:
    want = net["jlogits"]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    if _first_reduction(net["model"]) == len(net["model"].graph.gemm_nodes):
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= _fc_lsb(net))


class SliceSuite:
    """The slice checks for one network (``NAME``); subclassed per network
    by the test classes, one file each so each file stays short."""
    NAME = ""

    @pytest.fixture(scope="class")
    def net(self):
        return _reference_run(self.NAME)

    def test_execute_cnn_per_layer_activations(self, net):
        model = net["model"]
        plan = plan_for_network(net["params"], TACC, batch=BATCH,
                                in_hw=model.in_hw, lowering=model.graph,
                                cache=PlanCache())
        res = execute_cnn(net["params"], net["x"], plan, TCFG, impl="ref",
                          lowering=model.graph, collect_activations=True,
                          device="cpu")
        acts = [a.numpy() for a in res.activations]
        cut = _first_reduction(model)
        assert len(acts) == len(net["jacts"]) == len(model.graph.gemm_nodes)
        for i, (got, want) in enumerate(zip(acts, net["jacts"])):
            if i < cut:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"GEMM layer {i}")
        _check_logits(net, res.logits.numpy())
        # f32 sums of n non-negative terms in two different orders: each is
        # within (n-1)*2^-24 of the exact sum, relatively.
        sizes = np.array([a.size for a in acts], np.float64)
        rel = np.abs(res.fingerprints.numpy().astype(np.float64) / net["jfp"]
                     - 1.0)
        assert np.all(rel <= 2.0 * sizes * 2.0 ** -24)
        traces = res.traces
        assert [t.name for t in traces] == [n.name for n in
                                            model.graph.gemm_nodes]
        assert res.executed_energy_j > 0.0


    def test_reference_forward_and_executor_agree(self, net):
        model = net["model"]
        ref = reference_forward(net["params"], net["x"], TCFG,
                                lowering=model.graph, device="cpu").numpy()
        jref = np.asarray(jexec.reference_forward(
            net["jparams"], jnp.asarray(net["x"]), JCFG,
            lowering=net["jmodel"].graph))
        np.testing.assert_array_equal(jref, net["jlogits"])
        plan = plan_for_network(net["params"], TACC, batch=BATCH,
                                in_hw=model.in_hw, lowering=model.graph,
                                cache=PlanCache())
        res = execute_cnn(net["params"], net["x"], plan, TCFG,
                          lowering=model.graph, device="cpu")
        np.testing.assert_array_equal(res.logits.numpy(), ref)
        _check_logits(net, ref)


    def test_serving_engine_pads_and_matches(self, net):
        model = net["model"]
        engine = ServingEngine(net["params"], TACC, TCFG, lowering=model.graph,
                               in_hw=model.in_hw, max_batch=4, device="cpu",
                               plan_cache=PlanCache())
        cold = engine.warmup()
        assert sorted(cold) == [1, 2, 4]
        got = engine.infer(net["x"]).numpy()              # 3 -> bucket 4
        plan = plan_for_network(net["params"], TACC, batch=BATCH,
                                in_hw=model.in_hw, lowering=model.graph,
                                cache=PlanCache())
        res = execute_cnn(net["params"], net["x"], plan, TCFG,
                          lowering=model.graph, device="cpu")
        np.testing.assert_array_equal(got, res.logits.numpy())
        _check_logits(net, got)
        one = engine.infer_one(net["x"][0]).numpy()
        assert one.shape == (model.num_classes,)
        stats = engine.stats()
        assert stats["requests"] == 2 and stats["images"] == 4
        assert stats["batches"] == 2 and stats["padded_slots"] == 1
        assert stats["modeled_j_per_image"] > 0.0
        assert stats["warmed_up"] and stats["device"] == "cpu"
        assert stats["retraces_since_warmup"] == 0     # CPU: no captures
        assert stats["compile_cache"]["entries"] > 0


    def test_serving_engine_matches_reference_engine(self, net):
        """Against the reference's ServingEngine on the same request stream:
        the modeled energy accounting is equal (same plans), and for small_cnn
        — whose compiled reference forward equals its eager one — so are
        the logits.  resnet_mini's compiled reference drifts from its own
        eager oracle by an ULP, so its logits are held to the eager path
        above."""
        model, jmodel = net["model"], net["jmodel"]
        jengine = jexec.ServingEngine(net["jparams"], JACC, JCFG,
                                      lowering=jmodel.graph, in_hw=model.in_hw,
                                      max_batch=2, impl="ref",
                                      plan_cache=jexec.PlanCache())
        engine = ServingEngine(net["params"], TACC, TCFG, lowering=model.graph,
                               in_hw=model.in_hw, max_batch=2, device="cpu",
                               plan_cache=PlanCache())
        got = engine.infer(net["x"]).numpy()              # chunks 2 + 1
        jstats_keys = ("requests", "images", "batches", "padded_slots",
                       "executed_slots", "modeled_energy_j",
                       "modeled_j_per_image", "modeled_sustained_w")
        if net["name"] == "small_cnn":
            want = np.asarray(jengine.infer(jnp.asarray(net["x"])))
            np.testing.assert_array_equal(got, want)
            jstats, stats = jengine.stats(), engine.stats()
            for key in jstats_keys:
                assert stats[key] == jstats[key], key
        for b in engine.buckets:
            te, jte = engine._bucket_energy[b], jengine._bucket_energy[b]
            assert (te.batch, te.latency_s, te.per_layer_j) == \
                (jte.batch, jte.latency_s, jte.per_layer_j)
            assert dataclasses.asdict(te.breakdown) == \
                dataclasses.asdict(jte.breakdown)
        # chunking: 3 images at max_batch 2 = a 2-image run + a 1-image run
        parts = []
        for lo, hi in ((0, 2), (2, 3)):
            plan = plan_for_network(net["params"], TACC, batch=hi - lo,
                                    in_hw=model.in_hw, lowering=model.graph,
                                    cache=PlanCache())
            parts.append(execute_cnn(net["params"], net["x"][lo:hi], plan,
                                     TCFG,
                                     lowering=model.graph,
                                     device="cpu").logits.numpy())
        np.testing.assert_array_equal(got, np.concatenate(parts))


    def test_noisy_execution_reproducible_from_seed(self, net):
        model = net["model"]
        cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                             noise_enabled=True)
        engine = ServingEngine(net["params"], TACC, cfg, lowering=model.graph,
                               in_hw=model.in_hw, max_batch=4, device="cpu",
                               plan_cache=PlanCache())
        with pytest.raises(ValueError, match="seed=None"):
            engine.infer(net["x"])
        a = engine.infer(net["x"], seed=7).numpy()
        b = engine.infer(net["x"], seed=7).numpy()
        c = engine.infer(net["x"], seed=8).numpy()
        assert np.all(np.isfinite(a))
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)


class TestResnetMini(SliceSuite):
    NAME = "resnet_mini"

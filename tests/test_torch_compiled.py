"""The port's compiled paths against the reference, on the CPU.

* the executor's compiled forward: ``lowering_fingerprint`` equal to the
  reference's, the wrapper memo (shared by equal plans, LRU-bounded,
  cleared by ``clear_compile_cache``), ``execute_cnn(compiled=True)``
  bit-equal to ``compiled=False`` (noise off and on) and held to the
  reference's eager oracle as ``test_torch_slice.py`` holds it;
* ``ServingEngine.stats()`` with the reference's keys;
* the reference's ``TestMicroBatcher`` cases (``tests/test_serving.py``),
  case for case, with a seed in place of a PRNG key;
* every ``exec.report`` function: JSON-equal dicts and identical markdown
  on the same plans and results;
* ``decode_fn`` with a 0-d tensor position: bit-equal to the int position
  (logits and every cache leaf), and within 1e-4 * max|reference| of the
  reference's ``decode_fn`` in float32 (both packages round at the same
  ops; float32 reductions sum in other orders), for mamba2, qwen2 and
  h2o-danube3 past its 16-token window.

On the CPU the compiled wrapper runs the eager body and captures nothing
(``trace_count`` stays put); the captured graphs are held on the card by
``tests/test_torch_gpu.py``.  Inputs are made from seeds with numpy.
"""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jexec
from repro import configs as jconfigs
from repro.core import hw as jhw
from repro.core import perf_model as jpm
from repro.core.types import Backend as JBackend
from repro.core.types import Dataflow as JDataflow
from repro.core.types import PhotonicConfig as JConfig
from repro.exec import report as jreport
from repro.models import cnn as jcnn
from repro.models import model_zoo as jzoo
from repro.models.zoo_cnn import ZOO as JZOO

import repro_torch.exec as texec
from repro_torch import configs as tconfigs
from repro_torch.core import hw as thw
from repro_torch.core import perf_model as tpm
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import MicroBatcher, PlanCache, ServingEngine
from repro_torch.exec import executor as tex
from repro_torch.exec import report as treport
from repro_torch.models import cnn as tcnn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.lowering import params_from_jax
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.models.zoo_cnn import ZOO

from test_torch_slice import _check_logits, _reference_run

TACC = tpm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
JACC = jpm.AcceleratorConfig.equal_area("heana", JDataflow.OS, 1.0)


def _cfg(noise: bool = False) -> PhotonicConfig:
    return PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                          noise_enabled=noise)


def _small(batch: int = 3):
    model = ZOO["small_cnn"]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    plan = texec.plan_for_network(params, TACC, batch=batch,
                                  in_hw=model.in_hw, lowering=model.graph,
                                  cache=PlanCache())
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (batch, *model.in_hw, model.in_ch)).astype(np.float32))
    return model, params, plan, x


# ---------------------------------------------------------------------------
# executor: fingerprint, memo, compiled == eager == reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(ZOO) + ["legacy_small_cnn"])
def test_lowering_fingerprint_equals_reference(name):
    if name == "legacy_small_cnn":
        want = jexec.lowering_fingerprint(jcnn.small_cnn_lowering())
        got = texec.lowering_fingerprint(tcnn.small_cnn_lowering())
    else:
        want = jexec.lowering_fingerprint(JZOO[name].graph)
        got = texec.lowering_fingerprint(ZOO[name].graph)
    assert got == want


def test_compiled_forward_memo_shares_wrapper_and_clears():
    model, params, plan, _ = _small()
    plan2 = texec.plan_for_network(params, TACC, batch=3, in_hw=model.in_hw,
                                   lowering=model.graph, cache=PlanCache())
    assert plan is not plan2
    fn = texec.compiled_forward(plan, _cfg(), model.graph)
    assert texec.compiled_forward(plan2, _cfg(), model.graph) is fn
    assert texec.compiled_forward(plan, _cfg(noise=True), model.graph) \
        is not fn
    assert texec.compile_cache_stats()["entries"] >= 2
    texec.clear_compile_cache()
    assert texec.compile_cache_stats()["entries"] == 0
    assert texec.compiled_forward(plan, _cfg(), model.graph) is not fn


def test_compiled_forward_memo_is_lru_bounded(monkeypatch):
    assert tex._FORWARD_CACHE_MAX == 256 == \
        jexec.compile_cache_stats()["max_entries"]
    model, params, plan, _ = _small()
    monkeypatch.setattr(tex, "_FORWARD_CACHE_MAX", 3)
    texec.clear_compile_cache()
    keys = [(impl, collect) for impl in ("auto", "kernel", "ref")
            for collect in (False, True)]
    fns = [texec.compiled_forward(plan, _cfg(), model.graph, impl, collect)
           for impl, collect in keys]
    assert texec.compile_cache_stats() == {"entries": 3, "max_entries": 3}
    # the three newest survive, the oldest were evicted
    assert texec.compiled_forward(plan, _cfg(), model.graph, *keys[-1]) \
        is fns[-1]
    assert texec.compiled_forward(plan, _cfg(), model.graph, *keys[0]) \
        is not fns[0]
    texec.clear_compile_cache()


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("name", ["small_cnn", "resnet_mini",
                                  "mobilenet_mini"])
def test_compiled_execute_equals_eager_and_captures_nothing(name, noise):
    model = ZOO[name]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    plan = texec.plan_for_network(params, TACC, batch=2, in_hw=model.in_hw,
                                  lowering=model.graph, cache=PlanCache())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, *model.in_hw, model.in_ch)).astype(np.float32))
    seed = 11 if noise else None
    before = texec.trace_count()
    runs = [texec.execute_cnn(params, x, plan, _cfg(noise), seed=seed,
                              lowering=model.graph, compiled=compiled,
                              collect_activations=True, device="cpu")
            for compiled in (True, False, True)]
    assert texec.trace_count() == before
    for res in runs[1:]:
        assert torch.equal(res.logits, runs[0].logits)
        assert torch.equal(res.fingerprints, runs[0].fingerprints)
        assert all(torch.equal(a, b) for a, b in
                   zip(res.activations, runs[0].activations))
    if noise:
        quiet = texec.execute_cnn(params, x, plan, _cfg(), lowering=model.graph,
                                  device="cpu")
        other = texec.execute_cnn(params, x, plan, _cfg(True), seed=12,
                                  lowering=model.graph, device="cpu")
        assert not torch.equal(quiet.logits, runs[0].logits)
        assert not torch.equal(other.logits, runs[0].logits)
    else:
        ref = texec.reference_forward(params, x, _cfg(),
                                      lowering=model.graph, device="cpu")
        assert torch.equal(runs[0].logits, ref)


@pytest.mark.parametrize("name", ["small_cnn", "resnet_mini"])
def test_compiled_execute_matches_reference_eager_oracle(name):
    net = _reference_run(name)
    model = net["model"]
    plan = texec.plan_for_network(net["params"], TACC, batch=3,
                                  in_hw=model.in_hw, lowering=model.graph,
                                  cache=PlanCache())
    res = texec.execute_cnn(net["params"], net["x"], plan, _cfg(),
                            impl="ref", lowering=model.graph, compiled=True,
                            device="cpu")
    _check_logits(net, res.logits.numpy())


def test_compiled_forward_requires_a_seed_with_noise():
    model, params, plan, x = _small()
    fn = texec.compiled_forward(plan, _cfg(noise=True), model.graph)
    with pytest.raises(ValueError, match="seed=None"):
        fn(params, x)
    logits, fps, acts = fn(params, x, 3)
    assert logits.shape == (3, 10) and fps.shape == (len(plan.layers),)
    assert acts == ()


@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.AMW])
@pytest.mark.parametrize("name", ["small_cnn", "mobilenet_mini"])
def test_noise_draws_equal_a_generator_per_layer(name, backend):
    """The forward with draw_noise's pre-drawn noise equals a walk in which
    every GEMM draws from its layer's generator inside photonic_matmul:
    the shapes (depthwise layers fused) and the draws are the same."""
    from repro_torch.core.photonic_gemm import fold_seed, generator_for
    from repro_torch.kernels.ops import photonic_matmul
    from repro_torch.models import lowering as lw
    model = ZOO[name]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    op = thw.OperatingPoint.equal_area(backend.value, Dataflow.OS, 1.0)
    plan = texec.plan_for_network(params, op, batch=2, in_hw=model.in_hw,
                                  lowering=model.graph, cache=PlanCache())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, *model.in_hw, model.in_ch)).astype(np.float32))
    cfg = op.kernel_config(noise_enabled=True)
    assert tex.draw_noise(5, plan, op.kernel_config(noise_enabled=False),
                          torch.device("cpu")) is None

    def mm(a, w, gi, node):
        lp = plan.layers[gi]
        return photonic_matmul(a, w, cfg, generator_for(fold_seed(5, gi),
                                                        "cpu"),
                               block_m=lp.tile.block_m,
                               block_d=lp.tile.block_d)

    want = lw.graph_forward(params, x, model.graph, mm)[
        model.graph.output.name]
    got = texec.execute_cnn(params, x, plan, cfg, seed=5, lowering=model.graph,
                            device="cpu")
    assert torch.equal(got.logits, want)


# ---------------------------------------------------------------------------
# serving: stats keys, engine-local retraces
# ---------------------------------------------------------------------------
def test_stats_have_the_reference_keys():
    jmodel = JZOO["small_cnn"]
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jcfg = JConfig(backend=JBackend.HEANA, bits=6, dpe_size=83,
                   noise_enabled=False)
    jengine = jexec.ServingEngine(jparams, JACC, jcfg, lowering=jmodel.graph,
                                  in_hw=jmodel.in_hw, max_batch=2,
                                  impl="ref", plan_cache=jexec.PlanCache())
    model, params, _, x = _small()
    engine = ServingEngine(params, TACC, _cfg(), lowering=model.graph,
                           in_hw=model.in_hw, max_batch=2, device="cpu",
                           plan_cache=PlanCache())
    assert engine.stats()["retraces_since_warmup"] is None
    for e in (jengine, engine):
        e.warmup()
    jengine.infer(jnp.asarray(x.numpy()))
    engine.infer(x)
    jstats, stats = jengine.stats(), engine.stats()
    assert set(jstats) <= set(stats)
    assert set(stats) - set(jstats) == {"device"}
    assert stats["retraces_since_warmup"] == 0
    assert set(stats["compile_cache"]) == set(jstats["compile_cache"])
    assert stats["compile_cache"]["entries"] > 0


# ---------------------------------------------------------------------------
# MicroBatcher: the reference's cases (tests/test_serving.py), ported
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def served():
    """One warmed-up small_cnn engine shared by the module."""
    model = ZOO["small_cnn"]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    engine = ServingEngine(params, TACC, _cfg(), lowering=model.graph,
                           in_hw=model.in_hw, max_batch=8, device="cpu",
                           plan_cache=PlanCache())
    engine.warmup()
    return params, engine


def _images(i: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(i).standard_normal(
        (n, 16, 16, 3)).astype(np.float32))


class TestMicroBatcher:
    def test_prefilled_batch_rows_match_batched_inference(self, served):
        _, engine = served
        imgs = [_images(700 + i, 1)[0] for i in range(8)]
        mb = MicroBatcher(engine, max_delay_s=0.05)
        futs = [mb.submit(im) for im in imgs]
        mb.start()
        outs = [f.result(timeout=120) for f in futs]
        mb.stop()
        ref = engine.infer(torch.stack(imgs))
        for i, out in enumerate(outs):
            assert torch.equal(out, ref[i])
        s = mb.stats()
        assert s["batches_formed"] == 1 and s["requests_batched"] == 8
        assert s["mean_fill"] == 8.0

    def test_concurrent_submitters_all_resolve(self, served):
        _, engine = served
        with MicroBatcher(engine, max_delay_s=0.005) as mb:
            futs = []
            lock = threading.Lock()

            def submitter(tid):
                for i in range(3):
                    f = mb.submit(_images(800 + 10 * tid + i, 1)[0])
                    with lock:
                        futs.append(f)

            threads = [threading.Thread(target=submitter, args=(t,))
                       for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            outs = [f.result(timeout=120) for f in futs]
        assert len(outs) == 12
        assert all(o.shape == (10,) for o in outs)

    def test_engine_errors_propagate_to_futures(self, served):
        _, engine = served
        with MicroBatcher(engine, max_delay_s=0.0) as mb:
            bad = mb.submit(torch.zeros((8, 8, 3)))      # wrong geometry
            with pytest.raises(ValueError, match="rows"):
                bad.result(timeout=120)
            good = mb.submit(_images(900, 1)[0])
            assert good.result(timeout=120).shape == (10,)

    def test_mixed_shape_batch_fails_futures_not_worker(self, served):
        _, engine = served
        mb = MicroBatcher(engine, max_delay_s=0.2)
        good_img = _images(910, 1)[0]
        f1 = mb.submit(good_img)
        f2 = mb.submit(torch.zeros((8, 8, 3)))          # stacks against 16x16
        mb.start()
        with pytest.raises(RuntimeError):
            f1.result(timeout=120)
        with pytest.raises(RuntimeError):
            f2.result(timeout=120)
        f3 = mb.submit(good_img)                         # worker still alive
        assert f3.result(timeout=120).shape == (10,)
        mb.stop()

    def test_submit_after_stop_raises(self, served):
        _, engine = served
        mb = MicroBatcher(engine).start()
        mb.stop()
        with pytest.raises(RuntimeError, match="stopped"):
            mb.submit(torch.zeros((16, 16, 3)))

    def test_noise_engine_requires_seed(self, served):
        params, _ = served
        model = ZOO["small_cnn"]
        engine = ServingEngine(params, TACC, _cfg(noise=True),
                               lowering=model.graph, in_hw=model.in_hw,
                               max_batch=2, device="cpu",
                               plan_cache=PlanCache())
        with pytest.raises(ValueError, match="seed"):
            MicroBatcher(engine)
        with MicroBatcher(engine, max_delay_s=0.05, seed=3) as mb:
            out = mb.submit(_images(920, 1)[0]).result(timeout=120)
        assert out.shape == (10,) and bool(torch.isfinite(out).all())

    def test_validates_image_rank(self, served):
        _, engine = served
        with MicroBatcher(engine) as mb:
            with pytest.raises(ValueError, match="H, W, C"):
                mb.submit(torch.zeros((1, 16, 16, 3)))


# ---------------------------------------------------------------------------
# report: the same plans and results through both packages
# ---------------------------------------------------------------------------
def _json(d) -> str:
    return json.dumps(d, sort_keys=True)


@pytest.fixture(scope="module")
def reported():
    """small_cnn planned at an OperatingPoint in both packages, run once
    through the reference's eager executor; the port's ExecutionResult
    carries the reference's fingerprints."""
    jop = jhw.OperatingPoint.equal_area("heana", JDataflow.OS, 1.0)
    top = thw.OperatingPoint.equal_area("heana", Dataflow.OS, 1.0)
    jmodel, model = JZOO["small_cnn"], ZOO["small_cnn"]
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    jplan = jexec.plan_for_network(jparams, jop, batch=2, in_hw=jmodel.in_hw,
                                   lowering=jmodel.graph,
                                   cache=jexec.PlanCache())
    tplan = texec.plan_for_network(params, top, batch=2, in_hw=model.in_hw,
                                   lowering=model.graph, cache=PlanCache())
    x = np.random.default_rng(3).standard_normal(
        (2, *model.in_hw, model.in_ch)).astype(np.float32)
    jres = jexec.execute_cnn(jparams, jnp.asarray(x), jplan,
                             jop.kernel_config(noise_enabled=False),
                             impl="ref",
                             lowering=jmodel.graph, compiled=False)
    tres = tex.ExecutionResult(
        logits=torch.from_numpy(np.array(jres.logits)), plan=tplan,
        fingerprints=torch.from_numpy(np.array(jres.fingerprints)))
    return {"jop": jop, "top": top, "jmodel": jmodel, "model": model,
            "jplan": jplan, "tplan": tplan, "jres": jres, "tres": tres}


@pytest.mark.parametrize("case", [
    "graph_summary", "plan_summary", "plan_table", "plan_table_rows",
    "plan_vs_fixed", "execution_summary", "throughput_summary",
    "serving_summary", "energy_summary", "render_report"])
def test_report_equals_reference(reported, case):
    r = reported

    def both(fn):
        return fn(jreport, r["jplan"], r["jres"], r["jop"], r["jmodel"],
                  JDataflow), fn(treport, r["tplan"], r["tres"], r["top"],
                                 r["model"], Dataflow)

    stats = {"latency_p50_s": 0.001, "latency_p99_s": 0.002,
             "padding_fraction": 0.25, "retraces_since_warmup": 0,
             "data_parallel": False, "n_devices": 1,
             "plan_cache": {"entries": 3}, "compile_cache": {"entries": 7}}
    cases = {
        "graph_summary": lambda m, plan, res, op, net, flow:
            m.graph_summary(net.graph, "small_cnn"),
        "plan_summary": lambda m, plan, res, op, net, flow:
            m.plan_summary(plan, "small_cnn"),
        "plan_table": lambda m, plan, res, op, net, flow: m.plan_table(plan),
        "plan_table_rows": lambda m, plan, res, op, net, flow:
            m.plan_table(plan, max_rows=2),
        "plan_vs_fixed": lambda m, plan, res, op, net, flow:
            m.plan_vs_fixed(plan, {flow.OS: 1.5, flow.IS: 2.5, flow.WS: 0.5}),
        "execution_summary": lambda m, plan, res, op, net, flow:
            m.execution_summary(res, "small_cnn", numerics={"bits": 4}),
        "throughput_summary": lambda m, plan, res, op, net, flow:
            m.throughput_summary("small_cnn", 2, 300.0, 30.0, plan.fps,
                                 extras={"device": "x"}),
        "serving_summary": lambda m, plan, res, op, net, flow:
            m.serving_summary("small_cnn", 8, stats, 400.0, 100.0,
                              extras={"requests": 5}),
        "energy_summary": lambda m, plan, res, op, net, flow:
            m.energy_summary("small_cnn", op, res.energy(), plan.result,
                             extras={"note": "n"}),
        "render_report": lambda m, plan, res, op, net, flow:
            m.render_report([m.plan_summary(plan, "small_cnn"),
                             m.plan_summary(plan, "again")]),
    }
    want, got = both(cases[case])
    if isinstance(want, str):
        assert got == want
    else:
        assert _json(got) == _json(want)


def test_save_summary_writes_where_told(reported, tmp_path):
    summary = treport.plan_summary(reported["tplan"], "small_cnn")
    path = treport.save_summary(summary, str(tmp_path / "t" / "d"), "s.json")
    jpath = jreport.save_summary(jreport.plan_summary(reported["jplan"],
                                                      "small_cnn"),
                                 str(tmp_path / "j"), "s.json")
    assert path == str(tmp_path / "t" / "d" / "s.json")
    assert open(path).read() == open(jpath).read()


# ---------------------------------------------------------------------------
# decode_fn with a 0-d tensor position
# ---------------------------------------------------------------------------
def _close(got, want, what):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-0.5b",
                                  "h2o-danube-3-4b"])
def test_decode_fn_tensor_index_equals_int_and_reference(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               dtype="float32")
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    # h2o-danube3's smoke window is 16: the prompt fills it and the decode
    # steps roll past it.
    b, s, steps = 2, 14, 4
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (b, s)) \
        .astype(np.int32)
    kw = {"ssm_impl": "pallas"} if jcfg.family == "ssm" else {}
    jl, js = jzoo.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                             jzoo.init_caches(jcfg, b, s + steps,
                                              jnp.float32), **kw)
    tl, ts = tzoo.prefill_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                             tcfg, tzoo.init_caches(tcfg, b, s + steps,
                                                    torch.float32,
                                                    device="cpu"))
    ts_int = tree_map(torch.clone, ts)
    for step in range(steps):
        tok = np.argmax(np.asarray(jl, np.float32)[:, -1], -1)[:, None] \
            .astype(np.int32)
        jl, js = jzoo.decode_fn(jp, jnp.asarray(tok), jnp.int32(s + step),
                                jcfg, js)
        tok_t = torch.from_numpy(tok).long()
        tl, ts = tzoo.decode_fn(tp, tok_t, torch.tensor(s + step), tcfg, ts)
        il, ts_int = tzoo.decode_fn(tp, tok_t, s + step, tcfg, ts_int)
        assert torch.equal(tl, il), step
        for (path, a), (_, c) in zip(tree_leaves(ts), tree_leaves(ts_int)):
            assert torch.equal(a, c), (step, path)
        _close(tl, jl, f"logits {step}")
        for (path, a), (jpath, w) in zip(tree_leaves(ts["layers"]),
                                         tree_leaves(js["layers"])):
            assert path == jpath
            if path[-1] == "pos":
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            else:
                _close(a, w, f"{path} {step}")

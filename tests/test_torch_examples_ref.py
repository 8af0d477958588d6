"""Five ``examples_torch`` scripts against the reference's scripts and
library on the same inputs, on the CPU, and ``chip_smoke.py``'s recorder
of kernel calls.

Each script runs through its ``main(argv)``; what it feeds the model is
carried across or recorded, so both packages see the same weights and
inputs.  LM comparisons run the smoke configs in float32 (both packages'
``get_config`` patched), so the tolerances below are float32 ones:

* ``photonic_qat``: the reference's ``run`` (its ``STEPS`` cut to 2, its
  batch and sequence to 2 x 16, the port's likewise) on the reference's
  initial params (``model_zoo.params_from_jax``) with detection noise off
  (both scripts' ``design_point`` patched): the exact and QAT runs' last
  train loss and 5-batch HEANA eval loss within 1e-5 of the reference's
  (float32 sums in another order, over two AdamW steps); the QAT steps'
  noise seeds 1000 + step, as the reference's keys ``PRNGKey(1000 + s)``.
* ``serve_lm``: the greedy tokens on the reference's params and prompts
  equal to ``repro.launch.serve.serve``'s, for qwen2-0.5b and
  mamba2-130m (the two architectures chip_smoke serves at full width).
* ``train_lm``: 4 steps on the reference's initial params: the first and
  last losses within 1e-5 of ``repro.launch.train.train``'s.
* ``serving_throughput`` and ``serving_engine``: every batch the script
  executes or serves (the port's own seeded weights and images, carried
  into the reference) bit-equal to the reference's oracle forward
  ``repro.exec.reference_forward`` (6-bit HEANA at N = 83, noise off:
  every partial sum is an integer below 2^24, so both sum exactly), and
  serving_throughput's plan (flows, tiles, modeled FPS) equal to the
  reference's ``plan_for_network``.
* ``chip_smoke.recorded_calls`` / ``hold_calls`` on the CPU: each distinct
  wrapper call recorded once and held against its plain version; a wrong
  output and a signature seen only inside a graph capture both fail.
"""
import dataclasses
import importlib
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.perf_model import AcceleratorConfig as JAcc
from repro.core.types import Backend as JBackend
from repro.core.types import Dataflow as JDataflow
from repro.core.types import PhotonicConfig as JConfig
from repro.exec import PlanCache as JPlanCache
from repro.exec import plan_for_network as jplan_for_network
from repro.exec import reference_forward as jreference_forward
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import model_zoo as jzoo
from repro.models.zoo_cnn import ZOO as JZOO

from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")
LOSS_RTOL = 1e-5


def port_example(name: str):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def load_path(name: str, path: str):
    """A script that is not in a package, as a module of its own name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_example(name: str):
    return load_path(f"reference_example_{name}",
                     os.path.join(ROOT, "examples", f"{name}.py"))


def _float32(get_config):
    return lambda arch, smoke=True: dataclasses.replace(
        get_config(arch, smoke=smoke), dtype="float32")


def _carry_reference_init(monkeypatch):
    """The port's ``init_params`` returns the reference's float32 draw for
    the same seed (``PRNGKey(seed)``), carried across."""
    def init_params(cfg, seed=0, device=None):
        jcfg = _float32(jconfigs.get_config)(cfg.name)
        jp = jzoo.init_params(jcfg, jax.random.PRNGKey(seed))
        return tzoo.params_from_jax(jax.tree.map(np.asarray, jp),
                                    device=device)
    monkeypatch.setattr(tzoo, "init_params", init_params)


def _close(got, want, what):
    assert abs(got - want) <= LOSS_RTOL * abs(want), (what, got, want)


# ---------------------------------------------------------------------------
# photonic_qat
# ---------------------------------------------------------------------------
def test_photonic_qat_matches_reference_run(monkeypatch):
    jqat, tqat = reference_example("photonic_qat"), port_example(
        "photonic_qat")
    for mod, get_config in ((jqat, jqat.get_config),
                            (tqat, tqat.get_config)):
        monkeypatch.setattr(mod, "get_config", _float32(get_config))
        monkeypatch.setattr(mod, "BATCH", 2)
        monkeypatch.setattr(mod, "SEQ", 16)
        real_dp = mod.design_point
        monkeypatch.setattr(mod, "design_point",
                            lambda *a, _dp=real_dp, **k: _dp(
                                *a, noise_enabled=False, **k))
    monkeypatch.setattr(jqat, "STEPS", 2)
    _carry_reference_init(monkeypatch)
    want = []
    real_run = jqat.run
    monkeypatch.setattr(jqat, "run", lambda *a, **k: want.append(
        real_run(*a, **k)) or want[-1])
    jqat.main()
    seeds = []
    real_step = tqat.train_step
    monkeypatch.setattr(tqat, "train_step", lambda p, s, b, c, ctx, a: (
        seeds.append(ctx.seed), real_step(p, s, b, c, ctx, a))[1])
    got = tqat.main(["--steps", "2", "--device", "cpu"])
    assert got["dpe_size"] == 83
    assert seeds == [None, None, 1000, 1001]
    for (tr, ev), (jtr, jev), what in zip((got["exact"], got["qat"]), want,
                                          ("exact", "qat")):
        _close(tr, jtr, f"{what} train loss")
        _close(ev, jev, f"{what} eval loss")


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_serve_lm_tokens_equal_reference(arch, monkeypatch):
    batch, prompt, gen = 2, 8, 4
    monkeypatch.setattr(jserve, "get_config",
                        _float32(jserve.get_config))
    want = np.asarray(jserve.serve(arch, True, batch, prompt, gen).tokens)
    monkeypatch.setattr(tserve, "get_config", _float32(tserve.get_config))
    _carry_reference_init(monkeypatch)
    real_request = tserve.request_batch
    monkeypatch.setattr(tserve, "request_batch", lambda cfg, p: real_request(
        cfg, torch.from_numpy(want[:, :prompt].copy()).long().to(p.device)))
    got = port_example("serve_lm").main(
        ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
         "--gen", str(gen), "--device", "cpu"])
    assert got["tokens"].shape == want.shape
    np.testing.assert_array_equal(got["tokens"][:, prompt:].numpy(),
                                  want[:, prompt:])


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
def test_train_lm_losses_match_reference_train(tmp_path, monkeypatch):
    monkeypatch.setattr(jtrain, "get_config", _float32(jtrain.get_config))
    want = jtrain.train(arch="mamba2-130m", smoke=True, steps=4, batch=4,
                        seq=32, lr=3e-4, ckpt_dir=str(tmp_path / "ref"),
                        ckpt_every=50, resume=True)
    monkeypatch.setattr(ttrain, "get_config", _float32(ttrain.get_config))
    _carry_reference_init(monkeypatch)
    got = port_example("train_lm").main(
        ["--smoke", "--steps", "4", "--batch", "4", "--seq", "32",
         "--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert got["steps"] == want.steps == 4
    _close(got["first_loss"], want.first_loss, "first loss")
    _close(got["final_loss"], want.final_loss, "final loss")


# ---------------------------------------------------------------------------
# serving_throughput, serving_engine
# ---------------------------------------------------------------------------
JCFG = JConfig(backend=JBackend.HEANA, bits=6, dpe_size=83,
               noise_enabled=False)


def _reference_logits(params, x, lowering=None):
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    fwd = jax.jit(lambda p, x: jreference_forward(p, x, JCFG,
                                                  lowering=lowering))
    return np.asarray(fwd(jp, jnp.asarray(x.numpy())))


def test_serving_throughput_equals_reference(monkeypatch):
    mod = port_example("serving_throughput")
    plans, runs = [], []
    real_plan, real_exec = mod.plan_for_network, mod.execute_cnn
    monkeypatch.setattr(mod, "plan_for_network", lambda *a, **k: (
        plans.append((a, real_plan(*a, **k))) or plans[-1][1]))
    monkeypatch.setattr(mod, "execute_cnn", lambda params, x, *a, **k: (
        runs.append((params, x, real_exec(params, x, *a, **k))) or
        runs[-1][2]))
    out = mod.main(["--device", "cpu"])
    assert out["retraces"] == 0 and len(plans) == 1
    (params, _acc), plan = plans[0]
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jplan = jplan_for_network(jp, JAcc.equal_area("heana", JDataflow.OS,
                                                  1.0),
                              batch=mod.BATCH, cache=JPlanCache())
    assert [p.dataflow.value for p in plan.layers] == [
        p.dataflow.value for p in jplan.layers]
    assert [(p.tile.block_m, p.tile.block_d) for p in plan.layers] == [
        (p.tile.block_m, p.tile.block_d) for p in jplan.layers]
    assert out["modeled_fps"] == jplan.fps
    assert len(runs) == mod.STREAM + 2
    for params, x, res in runs:
        np.testing.assert_array_equal(res.logits.numpy(),
                                      _reference_logits(params, x))


def test_serving_engine_serves_reference_logits(monkeypatch):
    mod = port_example("serving_engine")
    served = []

    class Recording(mod.ServingEngine):
        def __init__(self, params, *a, **k):
            super().__init__(params, *a, **k)
            self.recorded_params = params

        def infer(self, x, seed=None):
            logits = super().infer(x, seed=seed)
            served.append((self.recorded_params, x, logits))
            return logits

    monkeypatch.setattr(mod, "ServingEngine", Recording)
    out = mod.main(["--device", "cpu"])
    assert out["retraces"] == 0
    # the mixed-size requests, then the micro-batcher's coalesced batches
    assert len(served) > len(mod.REQUEST_SIZES)
    assert [x.shape[0] for _, x, _ in served[:len(mod.REQUEST_SIZES)]] == \
        list(mod.REQUEST_SIZES)
    assert sum(x.shape[0] for _, x, _ in
               served[len(mod.REQUEST_SIZES):]) == 12
    graph = JZOO[mod.NETWORK].graph
    for params, x, logits in served:
        np.testing.assert_array_equal(
            logits.numpy(), _reference_logits(params, x, lowering=graph))


# ---------------------------------------------------------------------------
# chip_smoke.py's recorder of kernel calls, and its routing helpers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    return load_path("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))


def _kernel_calls(seed: int = 0):
    """One call of each wrapper through ops (CPU tensors: the wrappers run
    their plain versions), the TAOM one twice."""
    from repro_torch.core.types import Backend, PhotonicConfig
    gen = torch.Generator().manual_seed(seed)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=8,
                         noise_enabled=False)
    x = torch.randn((5, 20), generator=gen)
    w = torch.randn((20, 3), generator=gen)
    ops.photonic_matmul(x, w, cfg, impl="kernel")
    ops.photonic_matmul(x + 1, w, cfg, impl="kernel")
    bh, l, p, s = 2, 16, 4, 8
    ops.ssd_scan(torch.randn((bh, l, p), generator=gen),
                 torch.rand((bh, l), generator=gen),
                 -torch.rand((bh,), generator=gen),
                 torch.randn((bh, l, s), generator=gen),
                 torch.randn((bh, l, s), generator=gen), chunk=8,
                 impl="kernel")
    q, k, v = (torch.randn((2, 9, 16), generator=gen) for _ in range(3))
    ops.flash_attention(q, k, v, causal=True, impl="kernel")


def test_chip_smoke_records_and_holds_each_distinct_kernel_call(smoke):
    from repro_torch.kernels import flash_attention, ssd_scan, taom_gemm
    real = (taom_gemm.taom_gemm_fused, ssd_scan.ssd_scan_chunked,
            flash_attention.flash_attention_fwd)
    with smoke.recorded_calls() as (calls, captured):
        _kernel_calls()
    assert (taom_gemm.taom_gemm_fused, ssd_scan.ssd_scan_chunked,
            flash_attention.flash_attention_fwd) == real
    assert not captured
    held = smoke.hold_calls("cpu", calls, captured)
    assert {name: row["signatures"] for name, row in held.items()} == {
        "taom_gemm_fused": 1, "ssd_scan_chunked": 1,
        "flash_attention_fwd": 1}
    assert all(row["max_abs_err"] == 0.0 for row in held.values())


def test_chip_smoke_hold_fails_on_a_wrong_output_or_a_captured_call(smoke):
    with smoke.recorded_calls() as (calls, captured):
        _kernel_calls()
    key = next(k for k in calls if k[0] == "ssd_scan_chunked")
    name, args, (y, state) = calls[key]
    calls[key] = (name, args, (y * (1 + 1e-3), state))
    with pytest.raises(AssertionError):
        smoke.hold_calls("cpu", calls, captured)
    calls[key] = (name, args, (y, state))
    smoke.hold_calls("cpu", calls, captured)
    with pytest.raises(AssertionError, match="captured only"):
        smoke.hold_calls("cpu", calls, captured | {("flash", "unseen")})


def test_chip_smoke_routing_helpers_count_a_served_prefill(smoke):
    cfg = tget_config("deepseek-v2-236b", smoke=True)
    params = tzoo.init_params(cfg, 0, "cpu")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 8)))
    real_route = tmoe.route
    with smoke.recorded_routes() as routes:
        tzoo.prefill_fn(params, {"tokens": prompts}, cfg,
                        tzoo.init_caches(cfg, 2, 8, getattr(torch, cfg.dtype),
                                         "cpu"))
    assert tmoe.route is real_route and routes
    stats = smoke.routing_stats(routes, cfg.moe)
    assert stats["tokens"] == 2 * 8 * len(routes)
    k = cfg.moe.experts_per_token
    want = 0
    for router_w, xf, _ in routes:
        probs = torch.sort(tmoe.router_probs(router_w, xf), -1,
                           descending=True).values
        want += int(((probs[:, k - 1] - probs[:, k]) <
                     smoke.NEAR_TIE * probs[:, k - 1]).sum())
    assert stats["near_ties"] == want
    assert 0 <= stats["dropped_slots"] <= stats["tokens"] * k

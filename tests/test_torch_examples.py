"""The small CNN and the ten ``examples_torch/`` scripts against the
reference, on the CPU.

* ``models.cnn.build_small_cnn``: the reference's shapes, each weight a
  standard-normal draw over sqrt(fan_in) (the sample std of w *
  sqrt(fan_in) within 0.15 of 1: at least 432 draws a tensor, whose
  sample std has a standard error under 0.035), seeded and on the device
  asked for.
* ``small_cnn_apply`` against ``repro.models.cnn.small_cnn_apply`` on the
  reference's params (``lowering.params_from_jax``) and seeded numpy
  images: exact matmul within 1e-5 of max|reference| (float32 sums in
  another order); the int8 (N = 83) and HEANA (N = 2) plain routes at 8
  bits, noise off, bit-equal — every GEMM's operands are integers and
  each layer's max |xq| @ |wq| stays below 2^24 (asserted), so every
  partial sum is exact in float32 whatever order either package sums in;
  MAW (N = 1) sums C = K ADC-rounded chunk values that are not integers,
  in chunk order where the reference uses ``jnp.sum``: each GEMM fed the
  reference's input is held to both sums' float32 error bound (ROADMAP
  D9).
* ``_table4``: one SGD step from the reference's initial params on the
  reference's first batch against the reference's ``train_model(steps=1)``
  within 1e-5 of max|reference| (gradients of float32 sums in another
  order); on the reference's data and trained params, the exact, int8 and
  noise-off HEANA/MAW accuracies equal the reference's (int8 and HEANA
  logits bit-equal as above); with noise on (HEANA, and MAW's (C, M, D)
  draw at a few images) every GEMM draws from a fresh generator seeded 7
  (as the reference passes one key to every GEMM), the run repeats bit
  for bit and its relative drift from noise off is within a factor 3 of
  the reference's (another sampler: held statistically).
* Each script's ``main(["--device", "cpu", ...])`` runs and returns its
  dict; the analytic numbers (quickstart's DPU sizes and ResNet50 rows,
  operating_point's derived points and its executed-vs-analytic energy,
  heana_cnn_inference's Fig-11 ratios, autoflow's plan mixes) equal the
  reference functions' results.
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table4_accuracy as jt4
from repro.core import hw as jhw
from repro.core import perf_model as jpm
from repro.core.photonic_gemm import design_point as jdesign_point
from repro.core.scalability import max_dpe_size as jmax_dpe_size
from repro.core.types import Backend as JBackend
from repro.core.types import Dataflow as JDataflow
from repro.core.types import PhotonicConfig as JConfig
from repro.exec import (PlanCache as JPlanCache, execute_cnn as jexecute,
                        plan_for_network as jplan_for_network,
                        schedule_cnn as jschedule_cnn)
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.models.zoo_cnn import ZOO as JZOO

from repro_torch.core.photonic_gemm import design_point
from repro_torch.core.taom import quantize
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.kernels import ops, taom_gemm
from repro_torch.models import cnn as tcnn
from repro_torch.models.lowering import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")
SCRIPTS = ("quickstart", "autoflow_inference", "serving_throughput",
           "serving_engine", "zoo_inference", "operating_point",
           "heana_cnn_inference", "serve_lm", "train_lm", "photonic_qat")
EXACT_LIMIT = 2.0 ** 24
N_IMAGES = 16


def example(name: str):
    """An ``examples_torch`` script as a module (its folder on the path,
    as when it runs as a script)."""
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


def _configs(noise: bool):
    """(reference, port) configs of the Table-4 photonic columns."""
    out = {"int8": (JConfig(backend=JBackend.INT_QUANT, bits=8,
                            noise_enabled=False),
                    PhotonicConfig(backend=Backend.INT_QUANT, bits=8,
                                   noise_enabled=False))}
    for name, jb, tb in (("heana", JBackend.HEANA, Backend.HEANA),
                         ("maw", JBackend.MAW, Backend.MAW)):
        out[name] = (jdesign_point(jb, 8, 1.0, adc_bits=12,
                                   noise_enabled=noise),
                     design_point(tb, 8, 1.0, adc_bits=12,
                                  noise_enabled=noise))
    return out


@pytest.fixture(scope="module")
def small():
    """The reference's small CNN params and seeded images, both packages."""
    jparams = jcnn.build_small_cnn(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal(
        (N_IMAGES, 16, 16, 3)).astype(np.float32)
    return jparams, params_from_jax(jparams, device="cpu"), x


@pytest.fixture(scope="module")
def trained():
    """The reference's trained params (20 steps) and its held-out data."""
    jparams = jt4.train_model(steps=20)
    x, y = jt4.make_data(N_IMAGES, jax.random.PRNGKey(123))
    return jparams, params_from_jax(jparams, device="cpu"), x, y


# ---------------------------------------------------------------------------
# models.cnn: the small CNN
# ---------------------------------------------------------------------------
def test_build_small_cnn_shapes_and_scale():
    want = jcnn.build_small_cnn(jax.random.PRNGKey(0), 7, 24, 2)
    got = tcnn.build_small_cnn(torch.Generator().manual_seed(0), 7, 24, 2,
                               device="cpu")
    assert list(got) == list(want)
    for name, w in got.items():
        assert tuple(w.shape) == tuple(want[name].shape), name
        assert w.dtype == torch.float32 and w.device.type == "cpu"
        std = float((w * np.sqrt(w.shape[0])).std())
        assert abs(std - 1.0) < 0.15, (name, std)
    again = tcnn.build_small_cnn(torch.Generator().manual_seed(0), 7, 24, 2,
                                 device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_im2col_shim_matches_reference():
    x = np.random.default_rng(2).standard_normal((2, 6, 5, 3)).astype(
        np.float32)
    want = np.asarray(jcnn._im2col(jnp.asarray(x)))
    got = tcnn._im2col(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 30, 27)
    np.testing.assert_array_equal(got, want)


def test_small_cnn_apply_exact(small):
    jparams, tparams, x = small
    want = np.asarray(jcnn.small_cnn_apply(jparams, jnp.asarray(x)))
    got = tcnn.small_cnn_apply(tparams, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (N_IMAGES, 10)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _exact_sums(params: dict, x: torch.Tensor, cfg: PhotonicConfig):
    """Run the port's plain route, asserting every GEMM's max |xq| @ |wq|
    stays below 2^24 (each partial sum exact in float32)."""
    def mm(a, w):
        xq, _ = quantize(a.reshape(-1, a.shape[-1]), cfg.bits)
        wq, _ = quantize(w, cfg.bits, axis=0)
        bound = float((xq.abs().double() @ wq.abs().double()).max())
        assert bound < EXACT_LIMIT, (tuple(w.shape), bound)
        return ops.photonic_matmul(a, w, cfg, impl="ref")
    return tcnn.small_cnn_apply(params, x, matmul=mm)


@pytest.mark.parametrize("numerics", ["int8", "heana"])
def test_small_cnn_apply_photonic_noise_off_bit_equal(small, numerics):
    jparams, tparams, x = small
    jcfg, tcfg = _configs(noise=False)[numerics]
    assert (tcfg.dpe_size, jcfg.dpe_size) == (
        {"int8": 83, "heana": 2}[numerics],) * 2
    jmm = lambda a, w: jops.photonic_matmul(a, w, jcfg,      # noqa: E731
                                            impl="ref")
    want = np.asarray(jcnn.small_cnn_apply(jparams, jnp.asarray(x),
                                           matmul=jmm))
    got = _exact_sums(tparams, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_array_equal(got, want)


def test_small_cnn_maw_gemms_within_sum_order_bound(small):
    """MAW at N = 1 ADC-rounds every one of C = K chunk psums to a multiple
    of a non-dyadic step, then sums the C float32 values: the port in
    chunk order, the reference with ``jnp.sum`` in XLA's order (ROADMAP
    D9).  So each GEMM, fed the reference's own input, is held per output
    to 2 (C - 1) 2^-24 sum_c |adc_c| sx sw (both sums' error bound) plus
    one float32 rounding of the rescale on each side."""
    jparams, tparams, x = small
    jcfg, tcfg = _configs(noise=False)["maw"]
    assert tcfg.dpe_size == jcfg.dpe_size == 1
    seen = []

    def jmm(a, w):
        out = jops.photonic_matmul(a, w, jcfg, impl="ref")
        seen.append((np.array(a), np.array(w), np.array(out)))
        return out

    jcnn.small_cnn_apply(jparams, jnp.asarray(x), matmul=jmm)
    assert len(seen) == 4
    for a, w, want in seen:
        a2d = torch.from_numpy(a.reshape(-1, a.shape[-1]))
        tw = torch.from_numpy(w)
        got = ops.photonic_matmul(a2d, tw, tcfg, impl="ref").numpy()
        xq, sx = quantize(a2d, tcfg.bits)
        wq, sw = quantize(tw, tcfg.bits, axis=0)
        psums = xq.T[:, :, None] * wq[:, None, :]            # (C, M, D)
        adc = taom_gemm.adc_round(psums, tcfg.adc_bits,
                                  taom_gemm.chunk_fs(tcfg))
        scale = (sx * sw).abs().double().numpy()
        tol = (2 * (w.shape[0] - 1) * 2.0 ** -24 *
               adc.abs().double().sum(0).numpy() * scale +
               2.0 ** -23 * np.abs(want))
        want = want.reshape(got.shape)
        assert (np.abs(got - want) <= tol.reshape(got.shape)).all(), (
            w.shape, np.abs(got - want).max())


# ---------------------------------------------------------------------------
# examples_torch/_table4.py
# ---------------------------------------------------------------------------
def test_sgd_step_matches_reference_train_step():
    t4 = example("_table4")
    key = jax.random.PRNGKey(0)
    p0 = jcnn.build_small_cnn(jax.random.fold_in(key, 1), t4.NCLASS, t4.HW)
    x, y = jt4.make_data(64, jax.random.fold_in(key, 1000))
    want = jt4.train_model(steps=1, lr=0.05, batch=64, seed=0)
    got, loss = t4.sgd_step(params_from_jax(p0, device="cpu"),
                            torch.from_numpy(np.array(x)),
                            torch.from_numpy(np.array(y)), 0.05)
    assert np.isfinite(float(loss))
    for name, w in want.items():
        w = np.asarray(w)
        assert np.abs(got[name].numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_train_model_loss_falls_and_repeats():
    t4 = example("_table4")
    params, losses = t4.train_model(steps=30, device="cpu")
    again, _ = t4.train_model(steps=30, device="cpu")
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert all(torch.equal(params[k], again[k]) for k in params)
    assert all(not v.requires_grad for v in params.values())


def _accuracy(logits, y) -> float:
    return float(np.mean(np.argmax(np.asarray(logits), -1) == np.asarray(y)))


def test_evaluate_on_reference_data_and_params(trained, monkeypatch):
    t4 = example("_table4")
    jparams, tparams, x, y = trained
    tx = torch.from_numpy(np.array(x))
    # exact and int8: the columns the reference's evaluate runs noise-free
    for numerics in ("exact", "int8"):
        got = t4.logits_under(tparams, tx, numerics).numpy()
        want_acc = jt4.evaluate(jparams, numerics, n=N_IMAGES, seed=123)
        assert _accuracy(got, y) == want_acc, numerics
    # int8, HEANA and MAW with noise off: accuracies equal; int8 and HEANA
    # logits bit-equal (MAW's chunk sums run in another order, D9)
    for numerics, (jcfg, tcfg) in _configs(noise=False).items():
        monkeypatch.setattr(t4, "numerics_config", lambda m, c=tcfg: c)
        got = t4.logits_under(tparams, tx, numerics).numpy()
        jmm = lambda a, w, c=jcfg: jops.photonic_matmul(  # noqa: E731
            a, w, c, impl="ref")
        want = np.asarray(jcnn.small_cnn_apply(jparams, x, matmul=jmm))
        if numerics != "maw":
            np.testing.assert_array_equal(got, want)
        assert _accuracy(got, y) == _accuracy(want, y), numerics


@pytest.mark.parametrize("numerics", ["heana", "maw"])
def test_evaluate_noise_on(trained, monkeypatch, numerics):
    t4 = example("_table4")
    jparams, tparams, x, y = trained
    n = 4
    tx = torch.from_numpy(np.array(x[:n]))
    seeds, shapes = [], []
    real = ops.photonic_matmul

    def spy(a, w, cfg, generator=None, **kw):
        seeds.append(generator.initial_seed())
        shapes.append((a.reshape(-1, a.shape[-1]).shape[0], w.shape[0]))
        return real(a, w, cfg, generator=generator, **kw)

    monkeypatch.setattr(t4.ops, "photonic_matmul", spy)
    noisy = t4.logits_under(tparams, tx, numerics)
    assert seeds == [t4.NOISE_SEED] * 4
    if numerics == "maw":        # N = 1: one noise draw a (chunk, row, col)
        assert shapes[1] == (n * 64, 144)
    assert torch.equal(noisy, t4.logits_under(tparams, tx, numerics))
    quiet = t4.logits_under(tparams, tx, "exact")
    drift = float(torch.linalg.norm(noisy - quiet) / torch.linalg.norm(quiet))
    jcfg = _configs(noise=True)[numerics][0]
    jmm = lambda a, w: jops.photonic_matmul(                  # noqa: E731
        a, w, jcfg, key=jax.random.PRNGKey(7), impl="ref")
    jnoisy = np.asarray(jcnn.small_cnn_apply(jparams, x[:n], matmul=jmm))
    jquiet = np.asarray(jcnn.small_cnn_apply(jparams, x[:n]))
    jdrift = float(np.linalg.norm(jnoisy - jquiet) / np.linalg.norm(jquiet))
    assert 0 < drift and 0 < jdrift
    assert 1 / 3 < drift / jdrift < 3, (drift, jdrift)


def test_evaluate_accuracy_counts_hits():
    t4 = example("_table4")
    params, _ = t4.train_model(steps=5, device="cpu")
    acc = t4.evaluate(params, "exact", n=32)
    x, y = t4.make_data(32, 123, device="cpu")
    want = float((t4.logits_under(params, x, "exact").argmax(-1) == y)
                 .float().mean())
    assert acc == want and 0.0 <= acc <= 1.0
    with pytest.raises(ValueError, match="numerics"):
        t4.numerics_config("fp4")


# ---------------------------------------------------------------------------
# The ten scripts
# ---------------------------------------------------------------------------
_ARGS = {"photonic_qat": ["--steps", "2"], "zoo_inference": ["--smoke"]}


@pytest.mark.parametrize("name", [s for s in SCRIPTS if s != "train_lm"])
def test_example_main_runs_on_cpu(name, capsys):
    out = example(name).main(_ARGS.get(name, []) + ["--device", "cpu"])
    assert isinstance(out, dict) and out
    assert capsys.readouterr().out.strip()


def test_train_lm_checkpoints_and_resumes(tmp_path, capsys):
    mod = example("train_lm")
    args = ["--smoke", "--batch", "4", "--seq", "32", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = mod.main(["--steps", "4"] + args)
    assert first["steps"] == 4 and first["final_loss"] < first["first_loss"]
    resumed = mod.main(["--steps", "6"] + args)
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["steps"] == 2


def test_quickstart_analytic_sections_equal_reference():
    out = example("quickstart").main(["--device", "cpu"])
    assert out["dpe_size"] == {be: jmax_dpe_size(be, 4, 1.0)
                               for be in ("heana", "amw", "maw")}
    layers = jcnn.CNN_ZOO["resnet50"]()
    for be, flow in (("heana", JDataflow.OS), ("amw", JDataflow.WS),
                     ("maw", JDataflow.WS)):
        r = jpm.cnn_inference(layers,
                              jpm.AcceleratorConfig.equal_area(be, flow, 1.0))
        assert out["resnet50"][f"{be}-{flow.value}"] == (r.fps,
                                                         r.fps_per_watt)
    assert out["kernel_vs_oracle"] == 0.0
    assert set(out["lm_loss"]) == {"exact", "heana-8bit"}


def test_operating_point_equals_reference():
    out = example("operating_point").main(["--device", "cpu"])
    want = [jhw.OperatingPoint.equal_area(be, JDataflow.OS, dr).describe()
            for be in ("heana", "amw", "maw") for dr in (1.0, 5.0, 10.0)]
    assert out["points"] == want
    model = JZOO["resnet_mini"]
    op = jhw.OperatingPoint.equal_area("heana", JDataflow.OS, 1.0,
                                       noise_enabled=False)
    params = model.init_params(jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (2, *model.in_hw,
                                                  model.in_ch))
    plan = jplan_for_network(params, op, batch=2, in_hw=model.in_hw,
                             lowering=model.graph, cache=JPlanCache())
    te = jexecute(params, x, plan, op.kernel_config(), impl="ref",
                  lowering=model.graph).energy()
    assert (out["executed_fps"], out["executed_fps_per_watt"]) == (
        te.fps, te.fps_per_watt)
    assert out["rel_gap"] == 0.0 and out["rejected"]


def test_fig11_ratios_equal_reference():
    got = example("heana_cnn_inference").fig11_ratios()
    for base in ("amw", "maw"):
        fps, per_w = [], []
        for fn in jcnn.CNN_ZOO.values():
            layers = fn()
            h = jpm.cnn_inference(layers, jpm.AcceleratorConfig.equal_area(
                "heana", JDataflow.OS, 1.0))
            fps.append(h.fps / max(jpm.cnn_inference(
                layers, jpm.AcceleratorConfig.equal_area(base, f, 1.0)).fps
                for f in JDataflow))
            per_w.append(h.fps_per_watt / max(jpm.cnn_inference(
                layers, jpm.AcceleratorConfig.equal_area(
                    base, f, 1.0)).fps_per_watt for f in JDataflow))
        assert got[base] == (jpm.gmean(fps), jpm.gmean(per_w))


def test_autoflow_mix_equals_reference_and_bit_exact():
    out = example("autoflow_inference").main(["--device", "cpu"])
    assert out["bit_exact"] and out["drift"] > 0
    cache = JPlanCache()
    for be in ("heana", "amw"):
        acc = jpm.AcceleratorConfig.equal_area(be, JDataflow.OS, 1.0)
        for name, fn in jcnn.CNN_ZOO.items():
            plan = jschedule_cnn(fn(), acc, batch=1, cache=cache)
            mix, fps, _ = out["mix"][f"{be}/{name}"]
            assert (mix, fps) == (plan.mix(), plan.fps), (be, name)
    assert out["replan"] == (58, 0)


def test_serving_and_zoo_examples_hold_their_checks(capsys):
    eng = example("serving_engine").main(["--device", "cpu"])
    assert eng["stats"]["retraces_since_warmup"] == 0
    assert eng["buckets"] == [1, 2, 4, 8]
    assert "data-parallel skipped (1 device(s)" in capsys.readouterr().out
    thr = example("serving_throughput").main(["--device", "cpu"])
    assert thr["retraces"] == 0
    zoo = example("zoo_inference").main(["--device", "cpu"])
    assert list(zoo["conformant"]) == ["resnet_mini", "mobilenet_mini",
                                       "shufflenet_mini", "googlenet_mini"]
    assert all(zoo["conformant"].values())

"""The port's language-model slice (configs, layers, ssm, transformer,
model_zoo, launch/serve) against the reference, on mamba2-130m.

Params come from the reference's ``init_params`` and cross through
``params_from_jax``; tokens and activations are made from a seed with
numpy.  The reference's prefill runs its Pallas SSD kernel in interpret
mode (``ssm_impl="pallas"``); the port runs its plain versions on the
CPU.  Tolerances, as max |port - reference| <= tol * max |reference| over
each tensor:
  * float32: 1e-4 — both packages round at the same ops; the float32
    reductions (the scan, the norms' means) sum in other orders;
  * bfloat16: 2^-8, one bf16 ulp at the largest entry — the bf16 tensors
    are rounded at the same ops in both packages (silu one op at a time,
    as ``jax.nn.silu``), and an order difference in a float32 reduction
    upstream can still move a rounding by one ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.types import Backend as JBackend
from repro.core.types import PhotonicConfig as JPhotonicConfig
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import tree_leaves

ARCH = "mamba2-130m"
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}


def _cfgs(dtype):
    j = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                            dtype=dtype)
    t = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                            dtype=dtype)
    return j, t


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().to(torch.float32).cpu().numpy()
                     if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def _photonic(pkg_cfg, pkg_backend):
    return pkg_cfg(backend=pkg_backend.HEANA, bits=6, dpe_size=83,
                   noise_enabled=False)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------
def test_configs_equal_reference_field_for_field():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.list_archs():
        for smoke in (False, True):
            assert dataclasses.asdict(tconfigs.get_config(arch, smoke)) == \
                dataclasses.asdict(jconfigs.get_config(arch, smoke)), arch
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in jconfigs.list_archs():
        for name in jconfigs.SHAPES:
            assert tconfigs.cell_is_supported(
                tconfigs.get_config(arch), tconfigs.SHAPES[name]) == \
                jconfigs.cell_is_supported(jconfigs.get_config(arch),
                                           jconfigs.SHAPES[name])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_keeps_structure_shapes_dtypes(dtype):
    jcfg, _ = _cfgs(dtype)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want = list(tree_leaves(jp))
    got = list(tree_leaves(tp))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(j, np.float32))


@pytest.mark.parametrize("smoke", [True, False])
def test_init_params_tree_matches_reference(smoke):
    # The full config at two layers: its published widths, cut in depth.
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH, smoke),
                               num_layers=2)
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH, smoke),
                               num_layers=2)
    want = jzoo.init_params(jcfg, jax.random.PRNGKey(0), abstract=True)
    tp = tzoo.init_params(tcfg, 0, device="cpu")
    got = list(tree_leaves(tp))
    assert [k for k, _ in got] == [k for k, _ in tree_leaves(want)]
    for (key, t), (_, j) in zip(got, tree_leaves(want)):
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
    again = tzoo.init_params(tcfg, 0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(got, tree_leaves(again)))
    other = tzoo.init_params(tcfg, 1, device="cpu")
    assert not torch.equal(tp["embed"]["table"], other["embed"]["table"])


# ---------------------------------------------------------------------------
# base layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["rms_norm", "layer_norm", "rope", "mlp",
                                   "silu"])
def test_base_layers_match_reference(layer, dtype):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    maker = jlayers.ParamMaker(jax.random.PRNGKey(2), dtype=jnp.dtype(dtype))
    if layer == "rms_norm":
        scale = jnp.asarray(rng.standard_normal(16) * 0.1,
                            jnp.dtype(dtype))
        want = jlayers.rms_norm(scale, xj)
        got = tlayers.rms_norm(
            tzoo.params_from_jax(np.asarray(scale), device="cpu"), xt)
    elif layer == "layer_norm":
        jp = {"g": jnp.asarray(1 + rng.standard_normal(16) * 0.1,
                               jnp.dtype(dtype)),
              "b": jnp.asarray(rng.standard_normal(16) * 0.1,
                               jnp.dtype(dtype))}
        want = jlayers.layer_norm(jp, xj)
        got = tlayers.layer_norm(tzoo.params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"), xt)
    elif layer == "rope":
        pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
        want = jlayers.apply_rope(xj, jnp.asarray(pos), 1e4)
        got = tlayers.apply_rope(xt, torch.from_numpy(pos), 1e4)
    elif layer == "mlp":
        jp = jlayers.make_mlp(maker, "mlp", 16, 24)
        want = jlayers.mlp(jp, xj)
        got = tlayers.mlp(tzoo.params_from_jax(
            jax.tree.map(np.asarray, jp), device="cpu"), xt)
    else:
        want = jax.nn.silu(xj)
        got = tlayers.silu(xt)
    assert got.dtype == xt.dtype
    _close(got, want, TOL[dtype], layer)


def test_photonic_dense_noise_is_seeded_per_site():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    w = {"w": torch.from_numpy(rng.standard_normal((40, 6))
                               .astype(np.float32))}
    cfg = dataclasses.replace(_photonic(PhotonicConfig, Backend),
                              noise_enabled=True)
    ctx = tlayers.PhotonicCtx(cfg=cfg, seed=11)
    a = tlayers.dense(w, x, ctx, "site")
    assert torch.equal(a, tlayers.dense(w, x, ctx, "site"))
    assert not torch.equal(a, tlayers.dense(w, x, ctx, "other"))
    quiet = tlayers.dense(w, x, tlayers.PhotonicCtx(
        cfg=_photonic(PhotonicConfig, Backend)), "site")
    assert not torch.equal(a, quiet)
    with pytest.raises(ValueError, match="generator"):
        tlayers.dense(w, x, tlayers.PhotonicCtx(cfg=cfg), "site")


# ---------------------------------------------------------------------------
# the mamba block
# ---------------------------------------------------------------------------
def _block_params(dtype):
    jcfg, tcfg = _cfgs(dtype)
    maker = jlayers.ParamMaker(jax.random.PRNGKey(1),
                               dtype=jnp.dtype(dtype))
    jp = jssm.make_mamba(maker, "m", jcfg.d_model, jcfg.ssm)
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _block_params(dtype)
    x = np.random.default_rng(2).standard_normal((2, 20, jcfg.d_model)) \
        .astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out_j, st_j = jssm.mamba_block(jp, xj, jcfg.d_model, jcfg.ssm,
                                   return_state=True, impl="pallas")
    for impl in ("ref", "kernel"):
        out_t, st_t = tssm.mamba_block(tp, xt, tcfg.d_model, tcfg.ssm,
                                       return_state=True, impl=impl)
        assert out_t.dtype == xt.dtype
        assert st_t["conv"].dtype == torch.float32
        _close(out_t, out_j, TOL[dtype], "out")
        _close(st_t["conv"], st_j["conv"], TOL[dtype], "conv")
        _close(st_t["ssm"], st_j["ssm"], TOL[dtype], "ssm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _block_params(dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    state = jssm.init_state(jcfg.d_model, jcfg.ssm, 2)
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in state.items()}
    out_j, st_j = jssm.mamba_decode_step(
        jp, jnp.asarray(x).astype(jnp.dtype(dtype)), jcfg.d_model, jcfg.ssm,
        {k: jnp.asarray(v) for k, v in state.items()})
    out_t, st_t = tssm.mamba_decode_step(
        tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg.d_model,
        tcfg.ssm, {k: torch.from_numpy(v) for k, v in state.items()})
    _close(out_t, out_j, TOL[dtype], "out")
    for k in ("conv", "ssm"):
        _close(st_t[k], st_j[k], TOL[dtype], k)


# ---------------------------------------------------------------------------
# the model: prefill + decode, forward, photonic ctx
# ---------------------------------------------------------------------------
def _model(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype):
    jcfg, tcfg, jp, tp = _model(dtype)
    b, s, steps = 2, 20, 4
    toks = _tokens(jcfg.vocab_size, b, s)
    jl, js = jzoo.prefill_fn(
        jp, {"tokens": jnp.asarray(toks)}, jcfg,
        jzoo.init_caches(jcfg, b, s + steps, jnp.dtype(dtype)),
        ssm_impl="pallas")
    tl, ts = tzoo.prefill_fn(
        tp, {"tokens": torch.from_numpy(toks).long()}, tcfg,
        tzoo.init_caches(tcfg, b, s + steps, device="cpu"), ssm_impl="ref")
    assert tl.shape == (b, 1, tcfg.vocab_size)
    for step in range(steps + 1):
        _close(tl, jl, TOL[dtype], f"logits {step}")
        for k in ("conv", "ssm"):
            _close(ts["layers"]["mamba"][k], js["layers"]["mamba"][k],
                   TOL[dtype], f"{k} {step}")
        if step == steps:
            break
        tok = np.argmax(np.asarray(jl, np.float32)[:, -1], -1)[:, None] \
            .astype(np.int32)
        jl, js = jzoo.decode_fn(jp, jnp.asarray(tok), jnp.int32(s + step),
                                jcfg, js)
        tl, ts = tzoo.decode_fn(tp, torch.from_numpy(tok).long(), s + step,
                                tcfg, ts)


def test_forward_matches_reference():
    jcfg, tcfg, jp, tp = _model("float32")
    toks = _tokens(jcfg.vocab_size, 2, 12, seed=5)
    from repro.models import transformer as jtransformer
    want = jtransformer.forward(jp, jnp.asarray(toks), jcfg, remat=False)
    got = ttransformer.forward(tp, torch.from_numpy(toks).long(), tcfg)
    _close(got, want, TOL["float32"], "logits")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_photonic_ctx_prefill_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _model(dtype)
    b, s = 2, 20
    toks = _tokens(jcfg.vocab_size, b, s, seed=1)
    jctx = jlayers.PhotonicCtx(cfg=_photonic(JPhotonicConfig, JBackend),
                               impl="ref")
    tctx = tlayers.PhotonicCtx(cfg=_photonic(PhotonicConfig, Backend),
                               impl="ref")
    jl, js = jzoo.prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                             jzoo.init_caches(jcfg, b, s), ctx=jctx,
                             ssm_impl="pallas")
    tl, ts = tzoo.prefill_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                             tcfg, tzoo.init_caches(tcfg, b, s,
                                                    device="cpu"),
                             ctx=tctx)
    _close(tl, jl, TOL[dtype], "logits")
    for k in ("conv", "ssm"):
        _close(ts["layers"]["mamba"][k], js["layers"]["mamba"][k],
               TOL[dtype], k)
    exact, _ = tzoo.prefill_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                               tcfg, tzoo.init_caches(tcfg, b, s,
                                                      device="cpu"))
    assert not torch.equal(exact, tl), "the photonic ctx changed nothing"


# ---------------------------------------------------------------------------
# serving, devices, unported families
# ---------------------------------------------------------------------------
def test_serve_on_cpu_is_deterministic_from_its_seed():
    runs = [tserve.serve(ARCH, batch=2, prompt_len=12, gen=5, seed=s,
                         ssm_impl=impl, device="cpu")
            for s, impl in ((3, "kernel"), (3, "kernel"), (3, "ref"),
                            (4, "kernel"))]
    a, b, ref_impl, other = (r.tokens for r in runs)
    assert a.shape == (2, 12 + 5) and a.dtype == torch.int64
    assert bool(((a >= 0) & (a < 512)).all())
    assert torch.equal(a, b) and torch.equal(a, ref_impl)
    assert not torch.equal(a[:, :12], other[:, :12])
    assert runs[0].prefill_s > 0 and runs[0].tokens_per_s > 0
    sampled = tserve.serve(ARCH, batch=2, prompt_len=12, gen=5, seed=3,
                           greedy=False, temperature=0.7, device="cpu")
    assert torch.equal(sampled.tokens[:, :12], a[:, :12])


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, gen=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tzoo.params_from_jax({"w": np.zeros(2, np.float32)})
    # prefill_fn runs where its params are, and refuses tokens elsewhere.
    params = tzoo.init_params(cfg, 0, device="cpu")
    caches = tzoo.init_caches(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="tokens are on meta"):
        tzoo.prefill_fn(params, {"tokens": torch.zeros(1, 4, dtype=torch.long,
                                                       device="meta")},
                        cfg, caches)


@pytest.mark.parametrize("arch", [a for a in jconfigs.list_archs()
                                  if a != ARCH])
def test_unported_families_raise(arch):
    """The moe family, which the port does not run yet, raises at every
    entry point, naming its ROADMAP item; the others — dense (qwen2,
    h2o-danube3, gemma3), hybrid (zamba2), vlm (llava) and audio
    (whisper), ported since — run through the same entry points (their
    conformance: tests/test_torch_attention.py, tests/test_torch_families.
    py)."""
    cfg = tconfigs.get_config(arch, smoke=True)
    if cfg.family != "moe":
        params = tzoo.init_params(cfg, 0, device="cpu")
        caches = tzoo.init_caches(cfg, 1, 10, device="cpu")
        batch = tserve.request_batch(cfg, torch.zeros(1, 8,
                                                      dtype=torch.long))
        logits, state = tzoo.prefill_fn(params, batch, cfg, caches)
        logits, _ = tzoo.decode_fn(params, torch.zeros(1, 1,
                                                       dtype=torch.long),
                                   8, cfg, state)
        assert logits.shape == (1, 1, cfg.vocab_size)
        assert tserve.serve(arch, batch=1, prompt_len=8, gen=2,
                            device="cpu").tokens.shape == (1, 10)
        return
    for call in (lambda: tzoo.init_params(cfg, 0, device="cpu"),
                 lambda: tzoo.init_caches(cfg, 1, 8, device="cpu"),
                 lambda: tzoo.prefill_fn({}, {"tokens": None}, cfg, {}),
                 lambda: tzoo.decode_fn({}, None, 0, cfg, {}),
                 lambda: tserve.serve(arch, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP A7c"):
            call()

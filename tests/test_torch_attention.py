"""The port's attention slice (flash kernel's plain version, models/
attention, the dense family in transformer / model_zoo / launch.serve)
against the reference.

Inputs are made from a seed with numpy; params come from the reference's
``init_params`` / ``make_attention`` (with every bias drawn at random, so
the QKV biases are exercised) and cross through ``params_from_jax``.  The
reference's flash kernel runs in interpret mode
(``flash_attention_fwd(interpret=True)``, ``attention(attn_impl=
"pallas")``); the port runs its plain versions on the CPU.

Tolerances, as max |port - reference| over each tensor:
  * float32 kernels: rtol = atol = 2e-5, the bound tests/test_flash_
    attention.py holds the reference's kernel to (sums in other orders);
  * float32 modules and models: 1e-4 * max|ref|, as tests/test_torch_lm.py;
  * bfloat16, one path against the same path (the plain flash version
    against the Pallas kernel; 'dense' against 'xla'): 2^-7 * max|ref|.
    The outputs are rounded to bf16 at the same ops, but float32 sums run
    in other orders (torch's einsum and softmax against XLA's), which can
    move a rounding by one bf16 ulp — up to 2^-7 * max|ref| when it falls
    on the largest entry, which sits anywhere in its binade; a flip in an
    early layer is carried by the residual stream (measured: at most 0.69
    of the bound over gemma3's six layers, seeds 0-2).
  * bfloat16, the flash path against the reference's default path (the
    prefill into a cache, which the reference always runs on its XLA
    path): 2^-7 * max|ref| per attention layer.  The reference rounds the
    probabilities to bf16 (relative error 2^-9 each) before P V, the flash
    kernel keeps them in float32 (flash_attention.py:62-66), so each
    layer's attention output can move by about one bf16 ulp, and the
    residual stream adds the layers' differences (measured: at most 1.6
    of 2 on the two-layer configs, 3.3 of 6 on gemma3, seeds 0-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro.kernels.flash_attention import flash_attention_reference as jdense
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttransformer

F32_KERNEL = dict(rtol=2e-5, atol=2e-5)
F32_TOL = 1e-4
BF16_UNIT = 2.0 ** -7
DENSE_ARCHS = ("qwen2-0.5b", "h2o-danube-3-4b", "gemma3-12b")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err,
                                                    float(np.abs(want).max()))


def _same_path_tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_UNIT


def _with_random_biases(tree, rng):
    """The reference's param tree as numpy, every bias ("b") drawn from
    N(0, 0.5^2) in its own dtype (init leaves them zero)."""
    if isinstance(tree, dict):
        return {k: (np.asarray(rng.standard_normal(np.shape(v)) * 0.5,
                               np.float32).astype(np.asarray(v).dtype)
                    if k == "b" else _with_random_biases(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


def _qkv(bh, s, d, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]
    jx = [jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


# ---------------------------------------------------------------------------
# the flash kernel's plain version against the reference's Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,d,bq,bk", [(37, 16, 8, 8), (37, 24, 16, 16),
                                       (48, 16, 16, 8), (29, 24, 8, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_plain_matches_pallas_kernel_f32(s, d, bq, bk, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, s, d, s * d + bq, "float32")
    want = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                             block_q=bq, block_k=bk, interpret=True))
    got = ops._flash_blocked(tq, tk, tv, causal, window, bq, bk)
    np.testing.assert_allclose(_np(got), want, **F32_KERNEL)
    # the default blocks (the kernel wrapper's CPU path) and the oracles
    np.testing.assert_allclose(
        _np(tflash.flash_attention_fwd(tq, tk, tv, causal=causal,
                                       window=window)), want, **F32_KERNEL)
    np.testing.assert_allclose(
        _np(ref.flash_attention_reference(tq, tk, tv, causal=causal,
                                          window=window)),
        np.asarray(jdense(jq, jk, jv, causal=causal, window=window)),
        **F32_KERNEL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 0)])
def test_flash_plain_matches_pallas_kernel_bf16(causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 37, 24, 5 + window, "bfloat16")
    want = jflash(jq, jk, jv, causal=causal, window=window, block_q=16,
                  block_k=16, interpret=True)
    got = ops._flash_blocked(tq, tk, tv, causal, window, 16, 16)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_UNIT, "bf16")


def test_flash_dispatch_on_cpu_runs_the_plain_version():
    _, (q, k, v) = _qkv(3, 21, 16, 9, "float32")
    want = ops._flash_blocked(q, k, v, True, 4)
    before = tflash.LAUNCHES
    for impl in ("auto", "kernel", "ref"):
        got = ops.flash_attention(q, k, v, causal=True, window=4, impl=impl)
        assert torch.equal(got, want), impl
    assert tflash.LAUNCHES == before and tflash._LIB is None
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.flash_attention(q, k, v, impl="pallas")


def test_flash_wrapper_checks_its_inputs():
    _, (q, k, v) = _qkv(2, 8, 16, 1, "float32")
    with pytest.raises(ValueError, match=r"\(BH, S, D\)"):
        tflash.flash_attention_fwd(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="k has shape"):
        tflash.flash_attention_fwd(q, k[:, :4], v)
    with pytest.raises(ValueError, match="window"):
        tflash.flash_attention_fwd(q, k, v, window=-1)
    meta = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        tflash.flash_attention_fwd(meta, meta, meta)


# ---------------------------------------------------------------------------
# base layers at qwen2's shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qwen2_layers_match_reference(dtype):
    """make_dense(bias=True), dense with a bias, RoPE (theta 1e6, positions
    past 1000) and the gated mlp at qwen2-0.5b's smoke widths."""
    cfg = jconfigs.get_config("qwen2-0.5b", smoke=True)
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.num_heads
    maker = jlayers.ParamMaker(jax.random.PRNGKey(4), dtype=jnp.dtype(dtype))
    tmaker = tlayers.ParamMaker(4, dtype=getattr(torch, dtype))
    want_p = jlayers.make_dense(maker, "wq", d, h * hd, bias=True)
    got_p = tlayers.make_dense(tmaker, "wq", d, h * hd, bias=True)
    assert sorted(got_p) == sorted(want_p) == ["b", "w"]
    assert not bool(got_p["b"].any()) and got_p["b"].shape == (h * hd,)
    jp = _with_random_biases(jax.tree.map(np.asarray, want_p),
                             np.random.default_rng(5))
    tp = tzoo.params_from_jax(jp, device="cpu")
    xj, xt = _x(2, 7, d, 6, dtype)
    tol = _same_path_tol(dtype)
    qj = jlayers.dense(jax.tree.map(jnp.asarray, jp), xj)
    qt = tlayers.dense(tp, xt)
    _close(qt, qj, tol, "dense")
    pj, pt = _pos(2, 7, 1000)
    _close(tlayers.apply_rope(qt.reshape(2, 7, h, hd), pt, cfg.rope_theta),
           jlayers.apply_rope(qj.reshape(2, 7, h, hd), pj, cfg.rope_theta),
           tol, "rope")
    mj = jlayers.make_mlp(maker, "ffn", d, cfg.d_ff)
    _close(tlayers.mlp(tzoo.params_from_jax(jax.tree.map(np.asarray, mj),
                                            device="cpu"), xt),
           jlayers.mlp(mj, xj), tol, "mlp")


# ---------------------------------------------------------------------------
# models/attention against the reference's attention()
# ---------------------------------------------------------------------------
def _spec_pair(which, window, dtype):
    """(reference spec, port spec, params as numpy): the reference flash
    test's spec (14 real of 16 padded heads: head_pad 4 over 3 heads, one
    KV head) or qwen2's smoke spec (QKV bias)."""
    if which == "head_pad":
        kw = dict(d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
                  head_pad=4)
    else:
        kw = dataclasses.asdict(jtransformer.attn_spec(
            jconfigs.get_config("qwen2-0.5b", smoke=True)))
        kw.pop("window")
        assert kw["qkv_bias"] and kw.pop("mla") is None
    js = jattn.AttnSpec(window=window, **kw)
    ts = tattn.AttnSpec(window=window, **kw)
    maker = jlayers.ParamMaker(jax.random.PRNGKey(0), dtype=jnp.dtype(dtype))
    jp = _with_random_biases(jattn.make_attention(maker, "a", js),
                             np.random.default_rng(3))
    return js, ts, jp


def _x(b, s, d, seed, dtype):
    x = np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _pos(b, s, start=0):
    p = (start + np.arange(s, dtype=np.int32))[None].repeat(b, 0)
    return jnp.asarray(p), torch.from_numpy(p)


def _cache_close(got, want, tol, what):
    for key in ("k", "v"):
        _close(got[key], want[key], tol, f"{what} {key}")
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("which", ["head_pad", "qwen2"])
def test_attention_without_cache_matches_reference(which, window, dtype):
    js, ts, jp = _spec_pair(which, window, dtype)
    tp = tzoo.params_from_jax(jp, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    xj, xt = _x(2, 24, js.d_model, 1, dtype)
    pj, pt = _pos(2, 24)
    for jimpl, timpl in (("xla", "dense"), ("pallas", "ref")):
        want, wc = jattn.attention(jp, xj, pj, js, attn_impl=jimpl)
        got, gc = tattn.attention(tp, xt, pt, ts, attn_impl=timpl)
        assert wc is None and gc is None
        assert got.dtype == xt.dtype
        _close(got, want, _same_path_tol(dtype), f"{jimpl}/{timpl}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("which", ["head_pad", "qwen2"])
def test_attention_prefill_and_decode_match_reference(which, window, dtype):
    """Prefill into a cache (full; windowed with S = 24 > 8 slots), then 3
    decode steps.  The reference runs both on its default path."""
    js, ts, jp = _spec_pair(which, window, dtype)
    tp = tzoo.params_from_jax(jp, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    b, s, steps = 2, 24, 3
    tdt = getattr(torch, dtype)
    xj, xt = _x(b, s, js.d_model, 2, dtype)
    pj, pt = _pos(b, s)
    jc0 = jattn.init_cache(js, b, s + steps, jnp.dtype(dtype))
    tc0 = tattn.init_cache(ts, b, s + steps, tdt, device="cpu")
    assert tc0["k"].shape == jc0["k"].shape == (
        b, min(window, s + steps) if window else s + steps,
        js.num_kv_heads, js.head_dim)
    assert tc0["k"].dtype == tdt and bool((tc0["pos"] == -1).all())
    want, wc = jattn.attention(jp, xj, pj, js, cache=jc0)
    cross_tol = F32_TOL if dtype == "float32" else BF16_UNIT
    for impl, tol in (("dense", _same_path_tol(dtype)), ("ref", cross_tol)):
        got, gc = tattn.attention(tp, xt, pt, ts, cache=tc0, attn_impl=impl)
        _close(got, want, tol, f"prefill {impl}")
        _cache_close(gc, wc, _same_path_tol(dtype), f"prefill {impl}")
    wcache, gcache = wc, gc
    for step in range(steps):
        xj1, xt1 = _x(b, 1, js.d_model, 10 + step, dtype)
        pj1, pt1 = _pos(b, 1, s + step)
        want, wcache = jattn.attention(jp, xj1, pj1, js, cache=wcache,
                                       cache_index=jnp.int32(s + step))
        got, gcache = tattn.attention(tp, xt1, pt1, ts, cache=gcache,
                                      cache_index=s + step)
        _close(got, want, _same_path_tol(dtype), f"decode {step}")
        _cache_close(gcache, wcache, _same_path_tol(dtype), f"decode {step}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    js, ts, jp = _spec_pair("qwen2", 0, dtype)
    tp = tzoo.params_from_jax(jp, device="cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    xj, xt = _x(2, 6, js.d_model, 4, dtype)
    sj, st = _x(2, 11, js.d_model, 5, dtype)
    pj, pt = _pos(2, 6)
    kpj, kpt = _pos(2, 11, 3)
    for kv_pos in (False, True):
        want, _ = jattn.attention(jp, xj, pj, js, kv_source=sj,
                                  kv_positions=kpj if kv_pos else None,
                                  attn_impl="pallas")
        got, _ = tattn.attention(tp, xt, pt, ts, kv_source=st,
                                 kv_positions=kpt if kv_pos else None)
        _close(got, want, _same_path_tol(dtype), f"kv_positions {kv_pos}")


def test_attention_refuses_what_it_does_not_run():
    spec = tattn.AttnSpec(d_model=16, num_heads=2, num_kv_heads=1,
                          head_dim=8)
    p = tattn.make_attention(tlayers.ParamMaker(0), "a", spec)
    x = torch.zeros(1, 3, 16, dtype=torch.bfloat16)
    pos = torch.arange(3)[None]
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        tattn.attention(p, x, pos, spec, attn_impl="pallas")
    with pytest.raises(ValueError, match="one token"):
        tattn.attention(p, x, pos, spec,
                        cache=tattn.init_cache(spec, 1, 4, device="cpu"),
                        cache_index=3)
    # MLA: one token a decode step; the flash route needs v_head_dim <=
    # qk_nope_dim + qk_rope_dim (V is zero-padded to that head).
    m = tconfigs.get_config("deepseek-v2-236b", smoke=True).mla
    mla = dataclasses.replace(spec, mla=m)
    p = tattn.make_attention(tlayers.ParamMaker(0), "a", mla)
    with pytest.raises(ValueError, match="one token"):
        tattn.attention(p, x, pos, mla,
                        cache=tattn.init_cache(mla, 1, 4, device="cpu"),
                        cache_index=3)
    wide = dataclasses.replace(spec, mla=dataclasses.replace(
        m, v_head_dim=m.qk_nope_dim + m.qk_rope_dim + 8))
    p = tattn.make_attention(tlayers.ParamMaker(0), "a", wide)
    with pytest.raises(ValueError, match="v_head_dim <="):
        tattn.attention(p, x, pos, wide, attn_impl="ref")
    assert tattn.attention(p, x, pos, wide, attn_impl="dense")[0].shape == \
        x.shape


# ---------------------------------------------------------------------------
# the dense family end to end
# ---------------------------------------------------------------------------
def _model(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               dtype=dtype)
    jp = _with_random_biases(
        jax.tree.map(np.asarray, jzoo.init_params(jcfg,
                                                  jax.random.PRNGKey(0))),
        np.random.default_rng(1))
    tp = tzoo.params_from_jax(jp, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def _caches_close(got, want, tol, what):
    if "pos" in want:
        _cache_close(got, want, tol, what)
        return
    assert set(got) == set(want), what
    for key in want:
        _caches_close(got[key], want[key], tol, f"{what}/{key}")


def _prefill_and_decode(arch, dtype, attn_impl, tol):
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    b, s, steps = 2, 20, 4
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (b, s)) \
        .astype(np.int32)
    jl, js = jzoo.prefill_fn(
        jp, {"tokens": jnp.asarray(toks)}, jcfg,
        jzoo.init_caches(jcfg, b, s + steps, jnp.dtype(dtype)))
    tl, ts = tzoo.prefill_fn(
        tp, {"tokens": torch.from_numpy(toks).long()}, tcfg,
        tzoo.init_caches(tcfg, b, s + steps, getattr(torch, dtype),
                         device="cpu"), attn_impl=attn_impl)
    assert tl.shape == (b, 1, tcfg.vocab_size)
    for step in range(steps + 1):
        _close(tl, jl, tol, f"logits {step}")
        _caches_close(ts["layers"], js["layers"], tol, f"caches {step}")
        if step == steps:
            break
        tok = np.argmax(np.asarray(jl, np.float32)[:, -1], -1)[:, None] \
            .astype(np.int32)
        jl, js = jzoo.decode_fn(jp, jnp.asarray(tok), jnp.int32(s + step),
                                jcfg, js)
        tl, ts = tzoo.decode_fn(tp, torch.from_numpy(tok).long(), s + step,
                                tcfg, ts, attn_impl=attn_impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_flash_prefill_and_decode_match_reference(arch, dtype):
    """The port's flash prefill (plain version) + 4 decode steps against
    the reference's prefill_fn + decode_fn: logits and every cache leaf.
    bf16: 2^-7 * max|ref| per attention layer (module docstring)."""
    layers = tconfigs.get_config(arch, smoke=True).num_layers
    tol = F32_TOL if dtype == "float32" else BF16_UNIT * layers
    _prefill_and_decode(arch, dtype, "ref", tol)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_prefill_and_decode_match_reference_bf16(arch):
    _prefill_and_decode(arch, "bfloat16", "dense", BF16_UNIT)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_init_params_tree_matches_reference(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    tcfg = tconfigs.get_config(arch, smoke=True)
    want = jzoo.init_params(jcfg, jax.random.PRNGKey(0), abstract=True)
    got = tzoo.init_params(tcfg, 0, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_g] == \
        [jax.tree_util.keystr(k) for k, _ in flat_w]
    for (key, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == tuple(w.shape), key
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), key
    caches = tzoo.init_caches(tcfg, 2, 30, torch.float32, device="cpu")
    jcaches = jzoo.init_caches(jcfg, 2, 30, jnp.float32)
    flat_c = jax.tree_util.tree_flatten_with_path(caches)[0]
    flat_jc = jax.tree_util.tree_flatten_with_path(jcaches)[0]
    assert [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in flat_c] == \
        [(jax.tree_util.keystr(k), tuple(v.shape)) for k, v in flat_jc]


def test_forward_matches_reference_with_the_flash_path():
    jcfg, tcfg, jp, tp = _model("qwen2-0.5b", "float32")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 12)) \
        .astype(np.int32)
    want = jtransformer.forward(jp, jnp.asarray(toks), jcfg, remat=False)
    for impl in ("auto", "dense"):
        got = ttransformer.forward(tp, torch.from_numpy(toks).long(), tcfg,
                                   attn_impl=impl)
        _close(got, want, F32_TOL, impl)


def test_serve_qwen2_on_cpu():
    runs = [tserve.serve("qwen2-0.5b", batch=2, prompt_len=12, gen=5, seed=3,
                         attn_impl=impl, device="cpu")
            for impl in ("auto", "kernel", "ref")]
    toks = runs[0].tokens
    vocab = tconfigs.get_config("qwen2-0.5b", smoke=True).vocab_size
    assert toks.shape == (2, 17) and toks.dtype == torch.int64
    assert bool(((toks >= 0) & (toks < vocab)).all())
    assert all(torch.equal(r.tokens, toks) for r in runs)
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        tserve.serve("qwen2-0.5b", gen=2, attn_impl="pallas", device="cpu")

"""The port's hybrid (zamba2-7b), VLM (llava-next-mistral-7b) and
encoder-decoder (whisper-tiny) families against the reference.

Smoke configs; params come from the reference's ``init_params`` (every
bias drawn at random, so whisper's QKV and LayerNorm biases are
exercised) and cross through ``params_from_jax``; tokens, frames and
patches are made from a seed with numpy.  The port runs on the CPU, so its
SSD scan and flash attention take their plain versions; the reference runs
its default paths (jnp SSD, XLA attention).

Tolerances, as max |port - reference| <= tol * max |reference| over each
tensor:
  * float32: 1e-4, as tests/test_torch_lm.py holds the ported families.
  * bfloat16, one sublayer at a time (the hybrid's, each fed the
    reference's input and state): 2^-8 for its mamba sublayers and its
    shared block on the reference's own path (``attn_impl="dense"``),
    tests/test_torch_lm.py's mamba2 bound; 2^-7 for the shared block's
    prefill on the flash route (tests/test_torch_attention.py's bound: the
    reference rounds P to bf16 before P V, the flash path keeps it in
    float32).  Fed the same input, a sublayer's bf16 output departs from
    the reference only where a float32 sum in another order (torch's bf16
    matmul against XLA's, the scan's chunk sums) rounds one element the
    other way: one element of a sublayer's output now and then, by one
    ulp.  Measured, seed 0, prefill + one decode step: one element of 1536
    in the first mamba sublayer's output (0.15 of its bound) and one in
    the tail's (0.08), every other output bit-equal on the reference's
    path; the shared block's prefill on the flash route at 0.54 of its
    bound.
  * bfloat16, the whole model: bounds set from readings, since a one-ulp
    departure is carried, and in the hybrid amplified, by the layers after
    it.  Max over seeds 0-7 (the hybrid 0-15) of prefill + 4 decode steps,
    logits and every state leaf, in units of 2^-8 * max|reference|:
      - hybrid: 13.3 on the reference's path, 12.3 on the flash route;
        held at 2^-4 (16 units).  Seed 0's one flipped element in its
        first mamba sublayer (above) grows to 5.6 units in the tail's SSM
        state: each flip changes the next layer's dt and B x, and the
        state sums exp(dt a)-weighted updates over the prompt.  The
        per-sublayer bound above is the tight check;
      - llava: 1.3 on the reference's path, held at 2^-7 (2 units,
        tests/test_torch_attention.py's same-path bound); 3.4 on the flash
        route, held at 2^-7 per layer (4 units, its flash bound);
      - whisper: 2.4 on the reference's path and 2.8 on the flash route,
        held at 2^-6 (4 units); the reference's-path reading is above
        the attention slice's 2^-7, and which op flips first was not
        traced.
  * The photonic prefill in bf16 is held on the reference's own path: there
    a one-ulp difference from the flash route moves an operand across a
    quantization step, and the measured gap reaches ~100 units (the
    float32 photonic prefill runs the flash route, within 1e-4).
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
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import tree_leaves

HYBRID, VLM, AUDIO = "zamba2-7b", "llava-next-mistral-7b", "whisper-tiny"
ARCHS = (HYBRID, VLM, AUDIO)
F32_TOL = 1e-4
BF16_SUBLAYER = 2.0 ** -8
BF16_FLASH_SUBLAYER = 2.0 ** -7
# The whole model in bf16: (the reference's own path, the flash route).
BF16_MODEL = {HYBRID: (2.0 ** -4, 2.0 ** -4),
              VLM: (2.0 ** -7, 2.0 ** -7 * 2),      # the smoke's 2 layers
              AUDIO: (2.0 ** -6, 2.0 ** -6)}


def _tol(arch, dtype, attn_impl="auto"):
    """The module docstring's whole-model tolerance for ``arch``."""
    if dtype == "float32":
        return F32_TOL
    return BF16_MODEL[arch][attn_impl != "dense"]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (
        what, err, float(np.abs(want).max()))


def _trees_close(got, want, tol, what):
    g, w = list(tree_leaves(got)), list(tree_leaves(want))
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (key, a), (_, b) in zip(g, w):
        if key[-1] == "pos":
            np.testing.assert_array_equal(_np(a), _np(b))
        else:
            _close(a, b, tol, f"{what} {key}")


def _with_random_biases(tree, rng):
    """The reference's param tree as numpy, every bias ("b") drawn from
    N(0, 0.5^2) in its own dtype (init leaves them zero)."""
    if isinstance(tree, dict):
        return {k: (np.asarray(rng.standard_normal(np.shape(v)) * 0.5,
                               np.float32).astype(np.asarray(v).dtype)
                    if k == "b" else _with_random_biases(v, rng))
                for k, v in tree.items()}
    return np.asarray(tree)


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


def _batches(cfg, b, s, dtype, seed=0):
    """The same request for both packages: tokens, plus random frames
    (audio) or patches (vlm)."""
    rng = np.random.default_rng(seed)
    arrs = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32)}
    if cfg.family == "audio":
        arrs["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, tzoo.WHISPER_FRAME_FEAT)).astype(np.float32)
    if cfg.family == "vlm":
        arrs["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_embed_dim)) \
            .astype(np.float32)
    jb = {k: jnp.asarray(v) if k == "tokens" else
          jnp.asarray(v).astype(jnp.dtype(dtype)) for k, v in arrs.items()}
    tb = {k: torch.from_numpy(v).long() if k == "tokens" else
          torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in arrs.items()}
    return jb, tb


def _ref(fn, dtype, static_argnums=(), static_argnames=()):
    """A reference function as the tests call it: jitted in float32 (one
    compile instead of one per op; the numerics are XLA's either way), op
    by op in bf16, where a jitted graph may keep excess precision between
    ops (as tests/test_torch_lm.py runs it)."""
    if dtype != "float32":
        return fn
    return jax.jit(fn, static_argnums=static_argnums,
                   static_argnames=static_argnames)


def _ref_serving(dtype):
    """The reference's (prefill_fn, decode_fn) per ``_ref``."""
    return (_ref(jzoo.prefill_fn, dtype, (2,), ("ctx",)),
            _ref(jzoo.decode_fn, dtype, (3,)))


def _photonic(pkg_cfg, pkg_backend):
    return pkg_cfg(backend=pkg_backend.HEANA, bits=6, dpe_size=83,
                   noise_enabled=False)


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------
def _cut(cfg):
    """The full config cut in depth as chip_smoke.py's ``cut_config`` cuts
    it: the hybrid to one superblock and its tail, the VLM to 2 layers,
    whisper (4 + 4 layers) whole."""
    if cfg.family == "hybrid":
        tail = cfg.num_layers % cfg.shared_attn_period
        return dataclasses.replace(
            cfg, num_layers=cfg.shared_attn_period + tail)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, num_layers=2)
    return cfg


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch, smoke):
    """Key for key, shape for shape, dtype for dtype: the smoke config
    (drawn), and the full config cut in depth (its published widths, on the
    meta device: shapes and dtypes only)."""
    jcfg = jconfigs.get_config(arch, smoke)
    tcfg = tconfigs.get_config(arch, smoke)
    if not smoke:
        jcfg, tcfg = _cut(jcfg), _cut(tcfg)
    want = list(tree_leaves(jzoo.init_params(jcfg, jax.random.PRNGKey(0),
                                             abstract=True)))
    got = list(tree_leaves(tzoo.init_params(
        tcfg, 0, device="cpu" if smoke else "meta")))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
    if tcfg.family == "hybrid" and not smoke:
        plan = ttransformer.layer_plan(tcfg)
        assert [(g.name, g.kind, g.repeats) for g in plan] == [
            ("hybrid", "mamba_shared", 1), ("tail", "mamba", 3)]
    caches = tzoo.init_caches(tcfg, 2, 30, torch.float32,
                              device="cpu" if smoke else "meta")
    jcaches = jax.eval_shape(lambda: jzoo.init_caches(jcfg, 2, 30,
                                                      jnp.float32))
    assert [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree_leaves(caches)] == \
        [(k, tuple(v.shape), str(v.dtype)) for k, v in tree_leaves(jcaches)]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_structure_shapes_dtypes(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want, got = list(tree_leaves(jp)), list(tree_leaves(tp))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))


# ---------------------------------------------------------------------------
# base layers and the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_the_references_tanh_form(dtype):
    x = (np.random.default_rng(7).standard_normal(4096) * 3) \
        .astype(np.float32)
    want = jax.nn.gelu(jnp.asarray(x).astype(jnp.dtype(dtype)))
    got = tlayers.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":      # one op at a time, as the reference rounds
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _close(got, want, 1e-6, "gelu")
        _close(got, torch.nn.functional.gelu(torch.from_numpy(x),
                                             approximate="tanh"), 1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((erf - tlayers.gelu(torch.from_numpy(x))).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(dtype):
    jcfg, tcfg, jp, tp = _model(AUDIO, dtype)
    jb, tb = _batches(tcfg, 2, 5, dtype, seed=3)
    want = _ref(jencdec.encode, dtype, (2,))(jp, jb["frames"], jcfg)
    got = tencdec.encode(tp, tb["frames"], tcfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, _tol(AUDIO, dtype), "enc_out")
    # the reference's own path (the grouped einsum)
    _close(tencdec.encode(tp, tb["frames"], tcfg, attn_impl="dense"), want,
           _tol(AUDIO, dtype, "dense"), "enc_out dense")


def test_forward_matches_reference():
    for arch in (VLM, AUDIO):
        jcfg, tcfg, jp, tp = _model(arch, "float32")
        jb, tb = _batches(tcfg, 2, 9, "float32", seed=5)
        if arch == AUDIO:
            want = _ref(jencdec.forward, "float32", (3,))(
                jp, jb["tokens"], jb["frames"], jcfg)
            got = tencdec.forward(tp, tb["tokens"], tb["frames"], tcfg)
        else:
            want = _ref(jtransformer.forward, "float32", (2,), ("remat",))(
                jp, jb["tokens"], jcfg, remat=False,
                prefix_embeds=jb["patches"])
            got = ttransformer.forward(tp, tb["tokens"], tcfg,
                                       prefix_embeds=tb["patches"])
        _close(got, want, F32_TOL, arch)


# ---------------------------------------------------------------------------
# prefill + decode through model_zoo
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,attn_impl", [("float32", "auto"),
                                             ("bfloat16", "auto"),
                                             ("bfloat16", "dense")])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, attn_impl):
    """prefill_fn + 4 decode_fn steps: logits and every state leaf (the
    hybrid's mamba states and shared-block KV caches, whisper's decoder
    caches and encoder output); the port's default route (flash over the
    prompt), and in bf16 also the reference's own path."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    tol = _tol(arch, dtype, attn_impl)
    b, s, steps = 2, 12, 4
    jb, tb = _batches(tcfg, b, s, dtype)
    prefill, decode = _ref_serving(dtype)
    jl, js = prefill(
        jp, jb, jcfg, jzoo.init_caches(jcfg, b, s + steps, jnp.dtype(dtype)))
    tl, ts = tzoo.prefill_fn(
        tp, tb, tcfg, tzoo.init_caches(tcfg, b, s + steps,
                                       getattr(torch, dtype), device="cpu"),
        attn_impl=attn_impl)
    assert tl.shape == (b, 1, tcfg.vocab_size)
    assert sorted(ts) == sorted(js)
    for step in range(steps + 1):
        _close(tl, jl, tol, f"logits {step}")
        _trees_close(ts, js, tol, f"state {step}")
        if step == steps:
            break
        tok = np.argmax(np.asarray(jl, np.float32)[:, -1], -1)[:, None] \
            .astype(np.int32)
        jl, js = decode(jp, jnp.asarray(tok), jnp.int32(s + step), jcfg,
                        js)
        tl, ts = tzoo.decode_fn(tp, torch.from_numpy(tok).long(), s + step,
                                tcfg, ts, attn_impl=attn_impl)


def _hybrid_sublayers(jcfg, jp, tp):
    """The hybrid's sublayers in the order the model runs them: (group,
    repeat, cache key or None, kind, reference params, port params, site
    name)."""
    out = []
    grp = "hybrid"
    for r in range(jcfg.num_layers // jcfg.shared_attn_period):
        for i in range(jcfg.shared_attn_period):
            out.append((grp, r, f"m{i}", "mamba",
                        jax.tree.map(lambda a, r=r: a[r],
                                     jp[grp]["stack"][f"m{i}"]),
                        ttransformer.tree_map(lambda a, r=r: a[r],
                                              tp[grp]["stack"][f"m{i}"]),
                        f"{grp}.m{i}"))
        out.append((grp, r, "sh", "attn_dense", jp[grp]["shared_attn"],
                    tp[grp]["shared_attn"], f"{grp}.sh"))
    for r in range(jcfg.num_layers % jcfg.shared_attn_period):
        out.append(("tail", r, None, "mamba",
                    jax.tree.map(lambda a, r=r: a[r], jp["tail"]["stack"]),
                    ttransformer.tree_map(lambda a, r=r: a[r],
                                          tp["tail"]["stack"]), "tail"))
    return out


@pytest.mark.parametrize("dtype,attn_impl", [("float32", "auto"),
                                             ("bfloat16", "dense"),
                                             ("bfloat16", "auto")])
def test_hybrid_sublayers_match_reference_one_at_a_time(dtype, attn_impl):
    """Each of the hybrid's sublayers fed the reference's input: the
    prompt (its output and the state it writes into an empty cache), then
    one decode step from the reference's state (its output and the state
    it returns).  The module docstring's per-sublayer bounds."""
    jcfg, tcfg, jp, tp = _model(HYBRID, dtype)
    b, s = 2, 12
    jb, tb = _batches(tcfg, b, s, dtype, seed=0)
    tdt = getattr(torch, dtype)
    jcaches = jzoo.init_caches(jcfg, b, s + 1, jnp.dtype(dtype))

    def port(t):        # a reference tensor, as the port's
        arr = np.asarray(t)
        if arr.dtype.kind in "iu":
            return torch.from_numpy(arr.astype(np.int64)).to(torch.int32)
        return torch.from_numpy(np.array(t, np.float32)).to(
            torch.bfloat16 if t.dtype == jnp.bfloat16 else torch.float32)

    x = jlayers.embed(jp["embed"], jb["tokens"])
    xd = jlayers.embed(jp["embed"], jb["tokens"][:, :1])
    pos_j = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    pos_t = torch.arange(s)[None].expand(b, s)
    exact_j, exact_t = jlayers.EXACT_CTX, tlayers.EXACT_CTX
    for grp, r, key, kind, pj, pt, name in _hybrid_sublayers(jcfg, jp, tp):
        cj = jcaches[grp] if key is None else jcaches[grp][key]
        cj = jax.tree.map(lambda a, r=r: a[r], cj)
        tol = (F32_TOL if dtype == "float32" else
               BF16_FLASH_SUBLAYER if kind != "mamba" and
               attn_impl != "dense" else BF16_SUBLAYER)
        what = f"{name}[{r}]"
        jx, jst = jtransformer._run_sublayer(
            pj, x, pos_j, jcfg, kind, 0, exact_j, jtransformer.M.LOCAL, name,
            cj, None, "jax", True)
        tx, tst = ttransformer._run_sublayer(
            pt, port(x), pos_t, tcfg, kind, 0, exact_t, name,
            ttransformer.tree_map(port, cj), None, "auto", attn_impl, True)
        assert tx.dtype == tdt
        _close(tx, jx, tol, f"prefill {what}")
        _trees_close(tst, jst, tol, f"prefill state {what}")
        tol = F32_TOL if dtype == "float32" else BF16_SUBLAYER
        jd, jdst = jtransformer._run_sublayer(
            pj, xd, jnp.full((b, 1), s, jnp.int32), jcfg, kind, 0, exact_j,
            jtransformer.M.LOCAL, name, jst, jnp.int32(s), "jax", True)
        td, tdst = ttransformer._run_sublayer(
            pt, port(xd), torch.full((b, 1), s), tcfg, kind, 0, exact_t,
            name, ttransformer.tree_map(port, jst), s, "auto", attn_impl,
            True)
        _close(td, jd, tol, f"decode {what}")
        _trees_close(tdst, jdst, tol, f"decode state {what}")
        x, xd = jx, jd


@pytest.mark.parametrize("dtype,attn_impl", [("float32", "auto"),
                                             ("bfloat16", "dense")])
def test_photonic_hybrid_prefill_matches_reference(dtype, attn_impl):
    """6-bit HEANA, noise off: every dense of the mamba and shared
    attention sublayers through the photonic GEMM's plain version (bf16
    on the reference's own path: module docstring)."""
    jcfg, tcfg, jp, tp = _model(HYBRID, dtype)
    b, s = 2, 12
    jb, tb = _batches(tcfg, b, s, dtype, seed=1)
    jctx = jlayers.PhotonicCtx(cfg=_photonic(JPhotonicConfig, JBackend),
                               impl="ref")
    tctx = tlayers.PhotonicCtx(cfg=_photonic(PhotonicConfig, Backend),
                               impl="ref")
    jl, js = _ref_serving(dtype)[0](jp, jb, jcfg, jzoo.init_caches(
        jcfg, b, s, jnp.dtype(dtype)), ctx=jctx)
    tl, ts = tzoo.prefill_fn(tp, tb, tcfg, tzoo.init_caches(
        tcfg, b, s, getattr(torch, dtype), device="cpu"), ctx=tctx,
        attn_impl=attn_impl)
    tol = _tol(HYBRID, dtype, attn_impl)
    _close(tl, jl, tol, "logits")
    _trees_close(ts, js, tol, "state")
    exact, _ = tzoo.prefill_fn(tp, tb, tcfg, tzoo.init_caches(
        tcfg, b, s, getattr(torch, dtype), device="cpu"))
    assert not torch.equal(exact, tl), "the photonic ctx changed nothing"


def test_vlm_prompt_shorter_than_its_image_tokens_raises():
    cfg = tconfigs.get_config(VLM, smoke=True)
    params = tzoo.init_params(cfg, 0, device="cpu")
    short = cfg.num_image_tokens - 1
    batch = tserve.request_batch(cfg, torch.zeros(1, short,
                                                  dtype=torch.long))
    with pytest.raises(ValueError, match="image positions"):
        tzoo.prefill_fn(params, batch, cfg,
                        tzoo.init_caches(cfg, 1, short + 2, device="cpu"))
    with pytest.raises(ValueError, match="image positions"):
        tserve.serve(VLM, batch=1, prompt_len=short, gen=2, device="cpu")
    # exactly the image tokens is a whole prompt
    assert tserve.serve(VLM, batch=1, prompt_len=cfg.num_image_tokens,
                        gen=2, device="cpu").tokens.shape == (
        1, cfg.num_image_tokens + 2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu_is_deterministic_from_its_seed(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    runs = [tserve.serve(arch, batch=2, prompt_len=8, gen=4, seed=s,
                         device="cpu") for s in (3, 3, 4)]
    a, b, other = (r.tokens for r in runs)
    assert a.shape == (2, 12) and a.dtype == torch.int64
    assert bool(((a >= 0) & (a < cfg.vocab_size)).all())
    assert torch.equal(a, b)
    assert not torch.equal(a[:, :8], other[:, :8])
    assert runs[0].prefill_s > 0 and runs[0].tokens_per_s > 0
    batch = tserve.request_batch(cfg, a[:, :8])
    if cfg.family == "audio":
        assert batch["frames"].shape == (2, cfg.encoder_seq, 80)
        assert not bool(batch["frames"].any())
    elif cfg.family == "vlm":
        assert batch["patches"].shape == (2, cfg.num_image_tokens,
                                          cfg.vision_embed_dim)
        assert not bool(batch["patches"].any())
    else:
        assert sorted(batch) == ["tokens"]

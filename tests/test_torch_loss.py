"""The port's training loss and its gradients against the reference:
``model_zoo.loss_fn`` under ``torch.autograd`` against
``jax.value_and_grad(repro.models.model_zoo.loss_fn)``, the STE drop-in
matmul of ``core/photonic_gemm.py``, remat, and the route rule that keeps
the forward-only kernels out of a backward (ROADMAP C1).

Smoke configs in float32; params come from the reference's
``init_params`` and cross through ``params_from_jax``; tokens, targets,
frames, patches and noise are made from a seed with numpy.  The port runs
on the CPU, so its SSD scan and attention take their plain versions (as
they do under grad on the card); the reference runs its training defaults
(``ssm_impl="jax"``, XLA attention, remat on), jitted.

Tolerances:
  * loss: 1e-5 relative.  Read: at most 7.6e-8 (whisper, the photonic
    qwen2), 0 for the other families.
  * gradients, leaf by leaf: max |port - reference| <= 1e-4 * max
    |reference| of the leaf, floored at 1e-6 * the largest max |g| over
    the tree.  Read: at most 1.1e-5 of the leaf's max (zamba2;
    deepseek-v3 3.4e-6, the others 1.6e-6 and below).  The floor is for
    leaves whose exact gradient is 0 — attention's key bias (the softmax
    is shift-invariant), where both packages carry ~1e-9 of rounding.
  * the STE matmul (``photonic_dot_general``, ``device_level_dot``): the
    value bit-equal on pre-drawn noise — R1's rule holds: the integer
    psums stay below 2^24 (asserted).  The straight-through gradients are
    an exact matmul's, summed in another order: rtol 1e-5 (read: 9.6e-8
    of the largest entry).
  * remat on and off in the port: bit-equal, loss and every gradient.
  * the plain SSD scan's gradient where exp() overflows above the
    diagonal (a chunk of 128 with fast decay, as at mamba2-130m's full
    width): finite, and within 1e-4 of max |g| of the naive per-token
    recurrence's in float64, where the reference's is NaN (ROADMAP R5).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import photonic_gemm as jpg
from repro.kernels import ops as jops
from repro.core.types import Backend as JBackend
from repro.core.types import PhotonicConfig as JPhotonicConfig
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro_torch import configs as tconfigs
from repro_torch.core import photonic_gemm as tpg
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import tree_leaves, tree_map

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6
FAMILIES = ("mamba2-130m", "qwen2-0.5b", "zamba2-7b",
            "llava-next-mistral-7b", "whisper-tiny", "deepseek-v3-671b")
QAT = dict(bits=8, adc_bits=12, dpe_size=128, noise_enabled=False)


def _model(arch):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                               dtype="float32")
    jp = jax.tree.map(np.asarray, jzoo.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jcfg, tcfg, jp


def _leaves(tp):
    return tree_map(lambda t: t.requires_grad_(),
                    tzoo.params_from_jax(tp, device="cpu"))


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    arrs = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "audio":
        arrs["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, tzoo.WHISPER_FRAME_FEAT)).astype(np.float32)
    if cfg.family == "vlm":
        arrs["patches"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.vision_embed_dim)) \
            .astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _ref_loss(jp, jb, jcfg, ctx=jlayers.EXACT_CTX, mtp_weight=0.0):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jzoo.loss_fn(p, b, jcfg, ctx, mtp_weight=mtp_weight)))
    loss, grads = fn(jax.tree.map(jnp.asarray, jp), jb)
    return float(loss), dict(tree_leaves(jax.tree.map(np.asarray, grads)))


def _port_loss(tp, tb, tcfg, ctx=tlayers.EXACT_CTX, **kw):
    params = _leaves(tp)
    loss = tzoo.loss_fn(params, tb, tcfg, ctx, **kw)
    loss.backward()
    return (float(loss.detach()),
            {k: p.grad for k, p in tree_leaves(params)})


def _grads_close(got, want):
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in want.values())
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        ref = want[key]
        err = 0.0 if g is None and not ref.any() else \
            float(np.abs(g.numpy() - ref).max())
        assert err <= max(GRAD_TOL * float(np.abs(ref).max()), floor), \
            (key, err, float(np.abs(ref).max()))


def _ref_routes_agree(calls, k):
    """Every routing the port made (router input, router weight, top-k
    set) equals the reference's top-k on the same input."""
    for xf, w, top_e in calls:
        logits = (jnp.asarray(xf.numpy()) @ jnp.asarray(w.numpy())) \
            .astype(jnp.float32)
        _, je = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        np.testing.assert_array_equal(np.sort(top_e.numpy(), -1),
                                      np.sort(np.asarray(je), -1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """One case per family (ssm, dense, hybrid, vlm with patches, audio
    with frames, moe with v3's MTP term); deepseek-v3's routings are
    checked against the reference's, forward and remat recompute."""
    jcfg, tcfg, jp = _model(arch)
    jb, tb = _batch(tcfg)
    calls = []
    real_route = tmoe.route

    def route(router_w, xf, cfg):
        top_p, top_e = real_route(router_w, xf, cfg)
        calls.append((xf.detach().clone(), router_w.detach(), top_e.clone()))
        return top_p, top_e
    monkeypatch.setattr(tmoe, "route", route)
    mtp = 0.3 if jcfg.mtp_depth else 0.0
    want_loss, want = _ref_loss(jp, jb, jcfg, mtp_weight=mtp)
    got_loss, got = _port_loss(jp, tb, tcfg, mtp_weight=mtp)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss), \
        (got_loss, want_loss)
    _grads_close(got, want)
    if tcfg.moe is not None:
        assert mtp and calls
        _ref_routes_agree(calls, tcfg.moe.experts_per_token)


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-0.5b"])
def test_photonic_qat_loss_and_grads_match_reference(arch):
    """photonic_heana (8-bit HEANA, N 128, 12-bit ADC, noise off) through
    ``kernels.ops.photonic_matmul`` (its plain version on the CPU) against
    the reference's ``PhotonicCtx(impl="ref")``, as ``launch/train.py``
    trains."""
    jcfg, tcfg, jp = _model(arch)
    jb, tb = _batch(tcfg)
    jctx = jlayers.PhotonicCtx(
        cfg=JPhotonicConfig(backend=JBackend.HEANA, **QAT), impl="ref")
    tctx = tlayers.PhotonicCtx(cfg=PhotonicConfig(backend=Backend.HEANA,
                                                  **QAT))
    want_loss, want = _ref_loss(jp, jb, jcfg, jctx)
    got_loss, got = _port_loss(jp, tb, tcfg, tctx)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _grads_close(got, want)


@pytest.mark.parametrize("arch,noise", [("mamba2-130m", False),
                                        ("qwen2-0.5b", False),
                                        ("mamba2-130m", True)])
def test_remat_is_bit_equal(arch, noise, monkeypatch):
    """remat on and off give the same loss and gradients bit for bit; with
    detection noise on (seeded sites), the recompute redraws the forward's
    noise.  The photonic GEMM's forward runs once per call site without
    remat and twice with it (the recompute)."""
    _, tcfg, jp = _model(arch)
    _, tb = _batch(tcfg)
    ctx = tlayers.EXACT_CTX
    if noise:
        ctx = tlayers.PhotonicCtx(cfg=PhotonicConfig(
            backend=Backend.HEANA, bits=6, dpe_size=16, noise_enabled=True),
            seed=7)
    calls = []
    real = ops._taom_forward
    monkeypatch.setattr(ops, "_taom_forward",
                        lambda *a: calls.append(1) or real(*a))
    runs = {}
    for remat in (False, True):
        calls.clear()
        runs[remat] = _port_loss(jp, tb, tcfg, ctx, remat=remat)
        runs[remat] += (len(calls),)
    (l0, g0, n0), (l1, g1, n1) = runs[False], runs[True]
    assert l0 == l1
    for key in g0:
        assert torch.equal(g0[key], g1[key]), key
    if noise:
        assert n0 == 2 * tcfg.num_layers and n1 == 2 * n0, (n0, n1)
        quiet = tlayers.PhotonicCtx(cfg=dataclasses.replace(
            ctx.cfg, noise_enabled=False))
        assert _port_loss(jp, tb, tcfg, quiet)[0] != l0


# ---------------------------------------------------------------------------
# the STE drop-in matmul (core/photonic_gemm.py)
# ---------------------------------------------------------------------------
BACKENDS = ("HEANA", "AMW", "MAW", "INT_QUANT", "HEANA_AMW_BPCA", "EXACT")


def _operands(backend, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 100)).astype(np.float32)
    w = rng.standard_normal((100, 9)).astype(np.float32)
    kw = dict(bits=6, dpe_size=37, adc_bits=10, noise_enabled=True)
    jcfg = JPhotonicConfig(backend=getattr(JBackend, backend), **kw)
    tcfg = PhotonicConfig(backend=getattr(Backend, backend), **kw)
    noise = rng.standard_normal(tpg.noise_shape(x.shape, w.shape, tcfg)) \
        .astype(np.float32)
    assert 63 * 63 * 100 < 2 ** 24          # psums exact in float32
    return x, w, noise, jcfg, tcfg


@pytest.mark.parametrize("backend", BACKENDS)
def test_photonic_dot_general_value_bit_equal_and_ste_grads(backend):
    x, w, noise, jcfg, tcfg = _operands(backend)
    g = np.random.default_rng(1).standard_normal((2, 5, 9)) \
        .astype(np.float32)
    if backend == "EXACT":
        want, vjp = jax.vjp(lambda a, b: a @ b, jnp.asarray(x),
                            jnp.asarray(w))
    else:
        want, vjp = jax.vjp(lambda a, b: jpg._ste_dot(
            a, b, jnp.asarray(noise), jcfg), jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tpg.photonic_dot_general(tx, tw, tcfg,
                                   noise=torch.from_numpy(noise))
    got.backward(torch.from_numpy(g))
    if backend == "EXACT":      # a plain matmul: rounding order may differ
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        return
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), gw, rtol=1e-5, atol=1e-6)


def test_photonic_dot_general_noise_sources():
    """Pre-drawn noise equals the same draw made from a generator; noise
    off (or neither source) is the deterministic simulation, which
    matches the reference's ``key=None``; a wrong noise shape raises."""
    x, w, noise, jcfg, tcfg = _operands("HEANA")
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    gen = torch.Generator().manual_seed(3)
    drawn = tpg.photonic_dot_general(tx, tw, tcfg, generator=gen)
    again = tpg.photonic_dot_general(
        tx, tw, tcfg, noise=tpg.sample_noise(torch.Generator().manual_seed(3),
                                             x.shape, w.shape, tcfg))
    assert torch.equal(drawn, again)
    quiet = tpg.photonic_dot_general(tx, tw, tcfg)
    assert not torch.equal(quiet, drawn)
    np.testing.assert_array_equal(
        quiet.numpy(), np.asarray(jpg.photonic_dot_general(
            jnp.asarray(x), jnp.asarray(w), jcfg, None)))
    with pytest.raises(ValueError, match="noise is"):
        tpg.photonic_dot_general(tx, tw, tcfg,
                                 noise=torch.zeros(2, 5, 8))


@pytest.mark.parametrize("backend", ["HEANA", "HEANA_AMW_BPCA"])
def test_device_level_dot_matches_reference_and_the_fused_product(backend):
    x, w, noise, jcfg, tcfg = _operands(backend)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    want = jpg.device_level_dot(jnp.asarray(x), jnp.asarray(w), jcfg, None)
    np.testing.assert_array_equal(
        tpg.device_level_dot(tx, tw, tcfg).numpy(), np.asarray(want))
    tn = torch.from_numpy(noise)
    assert torch.equal(tpg.device_level_dot(tx, tw, tcfg, noise=tn),
                       tpg.photonic_dot_general(tx, tw, tcfg, noise=tn))
    with pytest.raises(ValueError, match="analog-carry"):
        tpg.device_level_dot(tx, tw, dataclasses.replace(
            tcfg, backend=Backend.AMW))


# ---------------------------------------------------------------------------
# C1: the forward-only kernels stay out of a backward
# ---------------------------------------------------------------------------
def _fake(cuda, grad):
    return types.SimpleNamespace(is_cuda=cuda, requires_grad=grad)


def test_resolve_impl_rule():
    """Without grad (or with no input requiring it) 'auto' is the kernel
    on CUDA tensors and the plain version elsewhere; under grad a
    forward-only kernel's 'auto' is the plain version and 'kernel'
    raises, while a kernel with a backward (the TAOM STE) keeps 'auto'."""
    r = ops.resolve_impl
    on_card = (_fake(True, False), _fake(True, True))
    assert r("auto", on_card, forward_only=True) == "ref"
    assert r("auto", on_card, forward_only=False) == "kernel"
    assert r("ref", on_card, forward_only=True) == "ref"
    with pytest.raises(ValueError, match="forward-only"):
        r("kernel", on_card, forward_only=True)
    assert r("kernel", on_card, forward_only=False) == "kernel"
    assert r("auto", (_fake(True, False),), forward_only=True) == "kernel"
    assert r("auto", (_fake(False, True),), forward_only=False) == "ref"
    with torch.no_grad():
        assert r("auto", on_card, forward_only=True) == "kernel"
        assert r("kernel", on_card, forward_only=True) == "kernel"
    with pytest.raises(ValueError, match="impl must be"):
        r("pallas", on_card, forward_only=True)


def test_kernel_route_under_grad_raises_before_the_device():
    """The wrappers refuse impl='kernel' for a grad-requiring input — on
    CPU tensors too, before any kernel would run — and run it without
    grad."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 16, 8)).astype(np.float32))
    dt = torch.rand(4, 16)
    a = -torch.rand(4)
    b = torch.randn(4, 16, 8)
    q = torch.randn(4, 16, 8, requires_grad=True)
    with pytest.raises(ValueError, match="forward-only"):
        ops.ssd_scan(x, dt, a.requires_grad_(), b, b, chunk=8,
                     impl="kernel")
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(q, q, q, impl="kernel")
    with torch.no_grad():
        ops.ssd_scan(x, dt, a, b, b, chunk=8, impl="kernel")
        ops.flash_attention(q, q, q, impl="kernel")
    # The photonic GEMM keeps its kernel route under grad (STE backward).
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=8,
                         noise_enabled=False)
    w = torch.randn(8, 5, requires_grad=True)
    ops.photonic_matmul(q, w, cfg, impl="kernel").sum().backward()
    assert w.grad is not None


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-0.5b"])
def test_grads_through_forward_auto_equal_ref(arch):
    """Gradients through ``transformer.forward`` under the default 'auto'
    routes equal the plain routes' bit for bit; 'kernel' raises."""
    _, tcfg, jp = _model(arch)
    _, tb = _batch(tcfg)
    runs = []
    for impl in ("auto", "ref"):
        params = _leaves(jp)
        ttransformer.forward(params, tb["tokens"], tcfg, ssm_impl=impl,
                             attn_impl=impl).sum().backward()
        runs.append({k: p.grad for k, p in tree_leaves(params)})
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key
    with pytest.raises(ValueError, match="forward-only"):
        ttransformer.forward(_leaves(jp), tb["tokens"], tcfg,
                             ssm_impl="kernel", attn_impl="kernel")


def test_ssd_gradient_is_finite_where_the_references_overflows():
    """A 128-token chunk whose decay sums past exp's range above the
    diagonal: the reference's chunked scan gives a NaN gradient (0 * inf
    through its select, ROADMAP R5); the port's gives the naive
    recurrence's gradient, and the same forward as the reference's."""
    rng = np.random.default_rng(0)
    h, l, p, n = 3, 128, 8, 16
    x = rng.standard_normal((h, l, p)).astype(np.float32)
    dt = rng.uniform(0.5, 1.0, (h, l)).astype(np.float32)
    a = -rng.uniform(1.5, 2.5, (h,)).astype(np.float32)
    b = rng.standard_normal((h, l, n)).astype(np.float32)
    c = rng.standard_normal((h, l, n)).astype(np.float32)
    r = rng.standard_normal((h, l, p)).astype(np.float32)

    def jloss(*args):
        y, _ = jops._ssd_chunked_jax(*args, chunk=l)
        return jnp.sum(y * r)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(t) for t in (x, dt, a, b, c)))
    assert not all(np.isfinite(np.asarray(g)).all() for g in jgrads)

    ts = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, b, c)]
    y, _ = ops._ssd_chunked(*ts, chunk=l)
    want_y, _ = jops._ssd_chunked_jax(*(jnp.asarray(t) for t in (
        x, dt, a, b, c)), chunk=l)
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_y).max()))
    (y * torch.from_numpy(r)).sum().backward()
    # The naive recurrence (heads as the reference's (L, H, ...) layout,
    # one group per head) in float64.
    ns = [torch.from_numpy(t).double().requires_grad_()
          for t in (x, dt, a, b, c)]
    yn, _ = tref.ssd_scan_reference(
        ns[0].transpose(0, 1), ns[1].T, ns[2], ns[3].transpose(0, 1),
        ns[4].transpose(0, 1))
    (yn.transpose(0, 1) * torch.from_numpy(r).double()).sum().backward()
    for name, got, want in zip("x dt a b c".split(), ts, ns):
        assert bool(torch.isfinite(got.grad).all()), name
        err = (got.grad.double() - want.grad).abs().max()
        assert err <= 1e-4 * want.grad.abs().max(), (name, float(err))

"""The port's moe family (deepseek-v2-236b, deepseek-v3-671b: MoE routing,
MLA attention, v3's MTP) against the reference.

Smoke configs; params come from the reference's ``init_params`` /
``make_moe`` / ``make_attention`` and cross through ``params_from_jax``;
tokens and activations are made from a seed with numpy.  The port runs on
the CPU, so its flash route takes the plain version (``_flash_blocked``,
V zero-padded to nope + rope); the reference runs its default paths.

Routing is discontinuous: a one-ulp difference in the router's input can
swap an expert and move that token's output by O(1).  So no test holds a
whole bf16 MoE model elementwise against the reference; bf16 is held one
function at a time, the routed experts with the reference's routing fed
in (``moe.route`` replaced by the reference's top-k).  In float32 the
whole model is held, and every routing the port computes is checked
against the reference's on the same router input, top-k sets equal token
by token except at near-ties (the k-th and (k+1)-th probabilities within
1e-5 of the k-th).

Tolerances, as max |port - reference| <= tol * max |reference| over each
tensor:
  * float32: 1e-4, as tests/test_torch_lm.py holds the ported families.
  * bfloat16, the routed experts with the reference's routing, and
    ``moe_ffn`` with its shared experts: 2^-8, one bf16 ulp at the largest
    entry.  Each product is a float32 sum rounded once in both packages,
    in another order, so an element now and then rounds the other way by
    one ulp; the combine adds the k slots in the same order in bf16.
    Measured, seeds 0-7: at most 0.011 of the bound, the routed experts
    and moe_ffn alike (an element far below the largest one ulp off).
  * bfloat16, MLA one call at a time (the prefill into a cache, then
    decode steps each fed the reference's cache): 2^-8 on the reference's
    own path ('dense'), 2^-7 on the flash route (tests/test_torch_
    attention.py's bound: the reference rounds P to bf16 before P V, the
    flash path keeps it in float32).  The absorbed decode rounds q_abs to
    bf16 and P to the cache's dtype, as the reference does.  Measured,
    both query layouts: the dense route's prefill and every decode step
    and cache leaf bit-equal to the reference; the flash route's prefill
    output at 0.71 of its bound.
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
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import tree_leaves

V2, V3 = "deepseek-v2-236b", "deepseek-v3-671b"
ARCHS = (V2, V3)
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -8
BF16_FLASH_TOL = 2.0 ** -7
NEAR_TIE = 1e-5
CUT = {"dense_head": 1, "moe_body": 2}     # chip_smoke.py's served cut


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def _err(got, want):
    """max |got - want| / max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _close(got, want, tol, what=""):
    err = _err(got, want)
    assert err <= tol, (what, err, tol)


def _trees_close(got, want, tol, what):
    g, w = list(tree_leaves(got)), list(tree_leaves(want))
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (key, a), (_, b) in zip(g, w):
        if key[-1] == "pos":
            np.testing.assert_array_equal(_np(a), _np(b))
        else:
            _close(a, b, tol, f"{what} {key}")


def _port(t):
    """A reference array as the port's tensor (bf16 kept, ints int32)."""
    arr = np.asarray(t)
    if arr.dtype.kind in "iu":
        return torch.from_numpy(arr.astype(np.int32))
    return torch.from_numpy(np.array(arr, np.float32)).to(
        torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)


def _cfgs(arch, dtype="float32"):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                            dtype=dtype)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                            dtype=dtype)
    return j, t


def _model(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = jax.tree.map(np.asarray, jzoo.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), \
        tzoo.params_from_jax(jp, device="cpu")


def _ref(fn, dtype, static_argnums=()):
    """Jitted in float32 (one compile; XLA's numerics either way), op by op
    in bf16, as tests/test_torch_families.py runs the reference."""
    if dtype != "float32":
        return fn
    return jax.jit(fn, static_argnums=static_argnums)


def _jax_route(router_w, xf, k):
    """The reference's routing (``moe._routed_local``'s first lines):
    (top_p renormalised, top_e, probs)."""
    logits = (xf @ router_w.astype(jnp.float32).astype(xf.dtype)) \
        .astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    return top_p / jnp.sum(top_p, axis=-1, keepdims=True), top_e, probs


def _routes_agree(xf, router_w, top_e, k):
    """The port's top-k sets ``top_e`` for router input ``xf`` against the
    reference's on the same input: equal token by token, except at
    near-ties of the reference's k-th and (k+1)-th probabilities.  Returns
    the number of near-tie tokens whose sets differ."""
    xj = jnp.asarray(_np(xf)).astype(jnp.dtype(str(xf.dtype)[6:]))
    _, je, probs = _jax_route(jnp.asarray(_np(router_w)).astype(xj.dtype),
                              xj, k)
    mine = np.sort(top_e.numpy(), -1)
    theirs = np.sort(np.asarray(je), -1)
    differ = (mine != theirs).any(-1)
    p = np.sort(np.asarray(probs), -1)[:, ::-1]
    kth = p[:, k - 1]
    near = (kth - p[:, k]) < NEAR_TIE * kth
    assert not (differ & ~near).any(), np.nonzero(differ & ~near)
    return int(differ.sum())


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch, smoke):
    """Key for key, shape for shape, dtype for dtype (the MoE layers'
    (E, D, F) experts and router, MLA's weights and norms, v3's ``mtp``
    subtree): the smoke config (drawn), and the full config cut to 1 dense
    + 2 MoE layers (its published widths, on the meta device); the caches
    likewise."""
    jcfg = jconfigs.get_config(arch, smoke)
    tcfg = tconfigs.get_config(arch, smoke)
    if not smoke:
        jcfg = tserve.cfg_with_repeats(jcfg, CUT)
        tcfg = tserve.cfg_with_repeats(tcfg, CUT)
    want = list(tree_leaves(jzoo.init_params(jcfg, jax.random.PRNGKey(0),
                                             abstract=True)))
    got = list(tree_leaves(tzoo.init_params(
        tcfg, 0, device="cpu" if smoke else "meta")))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == tuple(j.shape), key
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
    assert any(k[0] == "mtp" for k, _ in got) == (arch == V3)
    caches = tzoo.init_caches(tcfg, 2, 30, torch.float32,
                              device="cpu" if smoke else "meta")
    jcaches = jax.eval_shape(lambda: jzoo.init_caches(jcfg, 2, 30,
                                                      jnp.float32))
    assert [(k, tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree_leaves(caches)] == \
        [(k, tuple(v.shape), str(v.dtype)) for k, v in tree_leaves(jcaches)]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_experts_and_mtp(arch):
    jcfg = jconfigs.get_config(arch, smoke=True)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want, got = list(tree_leaves(jp)), list(tree_leaves(tp))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, t), (_, j) in zip(got, want):
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), key
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    assert tp["moe_body"]["stack"]["ffn"]["gate"].ndim == 4  # (L, E, D, F)
    assert ("mtp" in tp) == (arch == V3)


def test_cfg_with_repeats_cuts_depth_only():
    cfg = tconfigs.get_config(V2)
    cut = tserve.cfg_with_repeats(cfg, CUT)
    assert (cut.num_layers, cut.moe.first_dense_layers) == (3, 1)
    assert cut.d_model == cfg.d_model and cut.moe.num_experts == 160
    assert [(g.name, g.kind, g.repeats)
            for g in ttransformer.layer_plan(cut)] == [
        ("dense_head", "attn_dense", 1), ("moe_body", "attn_moe", 2)]
    with pytest.raises(ValueError, match="groups"):
        tserve.cfg_with_repeats(cfg, {"body": 2})


def test_expert_capacity_is_the_references():
    """``cap_e`` as the reference computes it with one shard: 192 at
    deepseek-v2's served prefill (4 x 1000 tokens), 8 in its decode
    step."""
    moe = tconfigs.get_config(V2).moe
    assert tmoe.expert_capacity(4000, moe) == 192
    assert tmoe.expert_capacity(4, moe) == 8
    for t in (1, 7, 48, 333, 4000):
        for cfg in (moe, tconfigs.get_config(V3, smoke=True).moe):
            k = cfg.experts_per_token
            cap = min(jmoe._round8(int(t * k * cfg.capacity_factor)), t * k)
            assert tmoe.expert_capacity(t, cfg) == jmoe._round8(
                int(cap * cfg.capacity_factor) // cfg.num_experts)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------
def _moe_inputs(cfg, dtype, seed, b=2, s=24, prefer=None):
    """Reference ``make_moe`` params (numpy) and x (B, S, D).  ``prefer``
    = e makes expert e every token's first choice: a common direction u
    added to x and to the router's column e."""
    rng = np.random.default_rng(seed)
    maker = jlayers.ParamMaker(jax.random.PRNGKey(seed),
                               dtype=jnp.dtype(dtype))
    p = jax.tree.map(np.asarray, jmoe.make_moe(maker, "ffn", cfg.d_model,
                                               cfg.moe))
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if prefer is not None:
        u = rng.standard_normal(cfg.d_model).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 5.0 * u
        router = np.array(p["router"], np.float32)
        router[:, prefer] += 5.0 * u
        p["router"] = router.astype(p["router"].dtype)
    return p, x.astype(jnp.dtype(dtype))


def _routed_pair(p, x, jcfg, tcfg):
    ref = _ref(jmoe._routed_local, str(x.dtype), (5, 6, 7))
    want = ref(*(jnp.asarray(p[n]) for n in ("router", "gate", "up",
                                             "down")),
               jnp.asarray(x), jcfg.moe, 1, 0)
    tp = tzoo.params_from_jax(p, device="cpu")
    got = tmoe._routed_local(tp["router"], tp["gate"], tp["up"], tp["down"],
                             _port(x), tcfg.moe)
    return tp, got, want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_routed_experts_match_reference_f32(seed):
    jcfg, tcfg = _cfgs(V2)
    p, x = _moe_inputs(jcfg, "float32", seed)
    tp, got, want = _routed_pair(p, x, jcfg, tcfg)
    _close(got, want, F32_TOL, "routed")
    xf = _port(x).reshape(-1, tcfg.d_model)
    _, top_e = tmoe.route(tp["router"], xf, tcfg.moe)
    assert _routes_agree(xf, tp["router"], top_e,
                         tcfg.moe.experts_per_token) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_capacity_overflow_drops_what_the_reference_drops(seed):
    """Expert 3 is every token's first choice: 48 slots for a capacity
    of 16, so 32 are dropped.  The port equals the reference, and its
    kept and dropped slots are the drop rule's (a slot's position is the
    running count of its expert over the slots in order)."""
    jcfg, tcfg = _cfgs(V2)
    p, x = _moe_inputs(jcfg, "float32", seed, prefer=3)
    tp, got, want = _routed_pair(p, x, jcfg, tcfg)
    _close(got, want, F32_TOL, "routed with drops")
    k, e = tcfg.moe.experts_per_token, tcfg.moe.num_experts
    xf = _port(x).reshape(-1, tcfg.d_model)
    t = xf.shape[0]
    top_p, top_e = tmoe.route(tp["router"], xf, tcfg.moe)
    assert bool((top_e[:, 0] == 3).all())
    pos, keep, cap_e = tmoe.slot_positions(top_e, tcfg.moe)
    assert cap_e == 16
    # the rule, slot by slot
    seen = [0] * e
    want_keep = []
    for slot, ex in enumerate(top_e.reshape(-1).tolist()):
        assert int(pos[slot]) == seen[ex]
        want_keep.append(seen[ex] < cap_e)
        seen[ex] += 1
    assert keep.tolist() == want_keep
    assert seen[3] == t
    assert sum(want_keep) == sum(min(c, cap_e) for c in seen) < t * k
    kept_first = torch.tensor(want_keep).reshape(t, k)[:, 0]
    assert bool(kept_first[:cap_e].all()) and not bool(
        kept_first[cap_e:].any())

    # and a token's output sums its kept slots only
    def expert(i, v):
        g = v @ tp["gate"][i]
        return (tlayers.silu(g) * (v @ tp["up"][i])) @ tp["down"][i]
    naive = torch.stack([
        sum((top_p[n, j] * expert(int(top_e[n, j]), xf[n])
             for j in range(k) if want_keep[n * k + j]),
            torch.zeros(tcfg.d_model))
        for n in range(t)])
    _close(got.reshape(t, -1), naive, F32_TOL, "naive")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_routed_experts_match_reference_bf16_on_its_routing(seed,
                                                            monkeypatch):
    """bf16, the reference's routing fed to the port's dispatch and
    combine, then ``moe_ffn`` (shared experts too) with ``route`` replaced
    by the reference's: within 2^-8 (module docstring)."""
    jcfg, tcfg = _cfgs(V2, "bfloat16")
    p, x = _moe_inputs(jcfg, "bfloat16", seed, prefer=3 if seed % 2 else None)
    k = tcfg.moe.experts_per_token
    xj = jnp.asarray(x)
    top_p, top_e, _ = _jax_route(jnp.asarray(p["router"]),
                                 xj.reshape(-1, tcfg.d_model), k)
    routing = (torch.from_numpy(np.array(top_p)),
               torch.from_numpy(np.array(top_e, np.int64)))
    want = jmoe._routed_local(*(jnp.asarray(p[n]) for n in (
        "router", "gate", "up", "down")), xj, jcfg.moe, 1, 0)
    tp = tzoo.params_from_jax(p, device="cpu")
    got = tmoe.dispatch_combine(tp["gate"], tp["up"], tp["down"], _port(x),
                                *routing, tcfg.moe)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL, "routed bf16")
    monkeypatch.setattr(tmoe, "route", lambda *a: routing)
    want = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), xj, jcfg.moe)
    got = tmoe.moe_ffn(tp, _port(x), tcfg.moe)
    _close(got, want, BF16_TOL, "moe_ffn bf16")


@pytest.mark.parametrize("seed", [5, 6])
def test_moe_ffn_and_load_balance_loss_match_reference(seed):
    """float32, v3's MoE (one shared expert)."""
    jcfg, tcfg = _cfgs(V3)
    p, x = _moe_inputs(jcfg, "float32", seed)
    tp = tzoo.params_from_jax(p, device="cpu")
    pj = jax.tree.map(jnp.asarray, p)
    want = jmoe.load_balance_loss(pj, jnp.asarray(x), jcfg.moe)
    got = tmoe.load_balance_loss(tp, _port(x), tcfg.moe)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    want = jax.jit(jmoe.moe_ffn, static_argnums=(2,))(
        pj, jnp.asarray(x), jcfg.moe)
    _close(tmoe.moe_ffn(tp, _port(x), tcfg.moe), want, F32_TOL, "moe_ffn")


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _mla(dtype, q_lora):
    """(reference spec, port spec, reference params, port params): the v2
    smoke config's MLA, with or without the query's low-rank path."""
    jcfg, tcfg = _cfgs(V2, dtype)
    if not q_lora:
        jcfg = dataclasses.replace(
            jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = dataclasses.replace(
            tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    js, ts = jtransformer.attn_spec(jcfg), ttransformer.attn_spec(tcfg)
    jp = jax.tree.map(np.asarray, jattn.make_attention(
        jlayers.ParamMaker(jax.random.PRNGKey(3), dtype=jnp.dtype(dtype)),
        "attn", js))
    assert ("wq_a" in jp) == q_lora
    return js, ts, jax.tree.map(jnp.asarray, jp), \
        tzoo.params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("dtype,attn_impl", [("float32", "auto"),
                                             ("float32", "dense"),
                                             ("bfloat16", "dense"),
                                             ("bfloat16", "auto")])
def test_mla_prefill_and_absorbed_decode_match_reference(dtype, attn_impl,
                                                         q_lora):
    """The prompt into an empty cache (output and the cache leaves), then
    three absorbed decode steps, each fed the reference's cache (output and
    the cache it writes in place)."""
    js, ts, jp, tp = _mla(dtype, q_lora)
    rng = np.random.default_rng(11)
    b, s, steps = 2, 12, 3
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = rng.standard_normal((b, s + steps, ts.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    call = _ref(jattn.attention, dtype, (3,))
    jo, jc = call(jp, jx[:, :s], jnp.asarray(pos), js,
                  cache=jattn.init_cache(js, b, s + steps, jdt))
    to, tc = tattn.attention(tp, _port(jx[:, :s]), torch.from_numpy(pos),
                             ts, cache=tattn.init_cache(ts, b, s + steps,
                                                        tdt, device="cpu"),
                             attn_impl=attn_impl)
    tol = (F32_TOL if dtype == "float32" else
           BF16_FLASH_TOL if attn_impl != "dense" else BF16_TOL)
    assert to.dtype == tdt and sorted(tc) == ["ckv", "kr", "pos"]
    _close(to, jo, tol, "prefill out")
    _trees_close(tc, jc, tol, "prefill cache")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for i in range(steps):
        p1 = np.full((b, 1), s + i, np.int32)
        xd = jx[:, s + i:s + i + 1]
        jo, jc_next = call(jp, xd, jnp.asarray(p1), js, cache=jc,
                           cache_index=jnp.int32(s + i))
        cache = jax.tree.map(_port, jc)
        to, tc = tattn.attention(tp, _port(xd), torch.from_numpy(p1), ts,
                                 cache=cache, cache_index=s + i,
                                 attn_impl=attn_impl)
        assert tc is cache             # written in place
        _close(to, jo, tol, f"decode {i}")
        _trees_close(tc, jc_next, tol, f"decode cache {i}")
        jc = jc_next


@pytest.mark.parametrize("attn_impl", ["auto", "dense"])
def test_mla_without_cache_matches_reference(attn_impl):
    js, ts, jp, tp = _mla("float32", True)
    x = np.random.default_rng(2).standard_normal((2, 17, ts.d_model)) \
        .astype(np.float32)
    pos = np.tile(np.arange(17, dtype=np.int32), (2, 1))
    jo, jc = jax.jit(jattn.attention, static_argnums=(3,))(
        jp, jnp.asarray(x), jnp.asarray(pos), js)
    to, tc = tattn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                             ts, attn_impl=attn_impl)
    assert jc is None and tc is None
    _close(to, jo, F32_TOL, "no cache")


def test_mla_flash_route_is_the_dense_route(monkeypatch):
    """The flash route's Q = [q_nope, q_rope], K = [k_nope, k_rope] and V
    zero-padded to nope + rope compute MLA's attention: through the plain
    flash version ('ref') the output equals the dense route's within
    float32 sums, and the wrapper sees D = nope + rope."""
    js, ts, jp, tp = _mla("float32", True)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 33, ts.d_model)).astype(np.float32))
    pos = torch.arange(33)[None].expand(3, 33)
    dense, _ = tattn.attention(tp, x, pos, ts, attn_impl="dense")
    flash, _ = tattn.attention(tp, x, pos, ts, attn_impl="ref")
    _close(flash, dense, 1e-5, "flash vs dense")
    seen = []
    real = tattn.kops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(v.shape)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn.kops, "flash_attention", spy)
    tattn.attention(tp, x, pos, ts, attn_impl="ref")
    d = ts.mla.qk_nope_dim + ts.mla.qk_rope_dim
    assert seen == [((3 * ts.num_heads, 33, d), (3 * ts.num_heads, 33, d))]


# ---------------------------------------------------------------------------
# whole models, float32
# ---------------------------------------------------------------------------
def _recording_routes(monkeypatch):
    """Record every (router input, router weight, top_e) the port routes."""
    calls = []
    real = tmoe.route

    def route(router_w, xf, cfg):
        top_p, top_e = real(router_w, xf, cfg)
        calls.append((xf.clone(), router_w, top_e.clone()))
        return top_p, top_e
    monkeypatch.setattr(tmoe, "route", route)
    return calls


@pytest.mark.parametrize("attn_impl", ["auto", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, attn_impl, monkeypatch):
    """prefill_fn + 4 decode_fn steps in float32: logits and every cache
    leaf within 1e-4; every routing the port made agrees with the
    reference's on the same router input (near-ties aside; none occur at
    these seeds)."""
    jcfg, tcfg, jp, tp = _model(arch, "float32")
    calls = _recording_routes(monkeypatch)
    b, s, steps = 2, 12, 4
    tokens = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (b, s)).astype(np.int32)
    prefill = jax.jit(jzoo.prefill_fn, static_argnums=(2,))
    decode = jax.jit(jzoo.decode_fn, static_argnums=(3,))
    jl, js = prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                     jzoo.init_caches(jcfg, b, s + steps, jnp.float32))
    tl, ts = tzoo.prefill_fn(
        tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg,
        tzoo.init_caches(tcfg, b, s + steps, torch.float32, device="cpu"),
        attn_impl=attn_impl)
    for step in range(steps + 1):
        _close(tl, jl, F32_TOL, f"logits {step}")
        _trees_close(ts, js, F32_TOL, f"state {step}")
        if step == steps:
            break
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, js = decode(jp, jnp.asarray(tok), jnp.int32(s + step), jcfg, js)
        tl, ts = tzoo.decode_fn(tp, torch.from_numpy(tok).long(), s + step,
                                tcfg, ts, attn_impl=attn_impl)
    moe_layers = tcfg.num_layers - tcfg.moe.first_dense_layers
    assert len(calls) == moe_layers * (steps + 1)
    k = tcfg.moe.experts_per_token
    assert sum(_routes_agree(xf, w, e, k) for xf, w, e in calls) == 0


def test_photonic_moe_prefill_matches_reference():
    """6-bit HEANA, noise off, float32: every dense of MLA and of the
    dense and shared-expert MLPs through the photonic GEMM's plain
    version; the routed experts exact, as in the reference."""
    jcfg, tcfg, jp, tp = _model(V2, "float32")
    b, s = 2, 12
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (b, s)).astype(np.int32)
    pc = dict(bits=6, dpe_size=83, noise_enabled=False)
    jctx = jlayers.PhotonicCtx(cfg=JPhotonicConfig(backend=JBackend.HEANA,
                                                   **pc), impl="ref")
    tctx = tlayers.PhotonicCtx(cfg=PhotonicConfig(backend=Backend.HEANA,
                                                  **pc), impl="ref")
    jl, js = jax.jit(jzoo.prefill_fn, static_argnums=(2,),
                     static_argnames=("ctx",))(
        jp, {"tokens": jnp.asarray(tokens)}, jcfg,
        jzoo.init_caches(jcfg, b, s, jnp.float32), ctx=jctx)
    tl, ts = tzoo.prefill_fn(
        tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg,
        tzoo.init_caches(tcfg, b, s, torch.float32, device="cpu"), ctx=tctx)
    _close(tl, jl, F32_TOL, "logits")
    _trees_close(ts, js, F32_TOL, "state")
    exact, _ = tzoo.prefill_fn(
        tp, {"tokens": torch.from_numpy(tokens).long()}, tcfg,
        tzoo.init_caches(tcfg, b, s, torch.float32, device="cpu"))
    assert not torch.equal(exact, tl), "the photonic ctx changed nothing"


def test_mtp_hidden_matches_reference():
    """v3's depth-1 MTP trunk on the main trunk's final hidden states."""
    jcfg, tcfg, jp, tp = _model(V3, "float32")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 10)).astype(np.int32)
    hidden = rng.standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    want = jax.jit(jtransformer.mtp_hidden, static_argnums=(3,))(
        jp, jnp.asarray(hidden), jnp.asarray(tokens), jcfg)
    for attn_impl in ("auto", "dense"):
        got = ttransformer.mtp_hidden(tp, torch.from_numpy(hidden),
                                      torch.from_numpy(tokens).long(), tcfg,
                                      attn_impl=attn_impl)
        assert got.shape == (2, 9, tcfg.d_model)
        _close(got, want, F32_TOL, f"mtp {attn_impl}")


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
    dense = tserve.serve(arch, batch=2, prompt_len=8, gen=4, seed=3,
                         attn_impl="dense", device="cpu")
    assert dense.tokens.shape == a.shape
    cut = tserve.serve(arch, batch=1, prompt_len=5, gen=2, device="cpu",
                       repeats={"dense_head": 1, "moe_body": 1})
    assert cut.tokens.shape == (1, 7)

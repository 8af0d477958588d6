"""The port's distributed code paths at one rank (a gloo process group of
one on the CPU, mesh (1, 1)) against the reference on a one-device mesh,
and the expert-parallel shard body against the reference's for every
shard of 2 and 4.

Tolerances, as max |port - reference| <= tol * max |reference|:
  * the expert-parallel body (float32, deepseek-v2 smoke, a capacity
    factor at which the slot capacity drops selected slots): 1e-5.  The
    slot selection, capacities and drops are integer decisions made
    alike; the values go through float32 products and exp in two
    libraries (read: at most 1.7e-7).  One slot decided otherwise would
    move a token by O(1), five orders above the bound.
  * compression: bit-equal (elementwise float32 ops only, the reference
    run op by op), the one-rank ``allreduce_compressed`` included.
  * the pipeline at one stage: rtol = atol = 2e-5, the reference's own
    bound for its schedule.
  * flash-decode at one rank (qwen2-0.5b smoke, heads padded 4 -> 6, float32,
    prefill + 3 decode steps through ``prefill_fn`` / ``decode_fn`` with
    ``dist``): 1e-4, as tests/test_torch_lm.py holds the float32 models.
  * the vocab-sharded CE at one rank through ``loss_fn(dist)``: loss rtol
    1e-5, gradients 1e-4 (floor 1e-6 of the largest), as
    tests/test_torch_loss.py holds ``loss_fn``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.optim import compression as jcomp
from repro.parallel import pipeline_parallel as jpp
from repro.parallel import sharded_ce as jce
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattn
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import compression as tcomp
from repro_torch.parallel import pipeline_parallel as tpp
from repro_torch.parallel import sharded_ce as tce
from repro_torch.runtime import fault_tolerance as tft

EP_TOL = 1e-5
F32_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for these smoke-width computations: beside the
    suite's other workers a pool of one thread a core mostly waits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one, started by ``make_local_mesh`` itself."""
    assert not tdist.is_initialized()
    m = tmesh.make_local_mesh(device_type="cpu")
    yield m
    tdist.destroy_process_group()


def _jax_mesh(shape, names):
    """A one-device reference mesh with automatic (GSPMD) axes, as the
    reference's code was written for."""
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]).reshape(shape), names)


@pytest.fixture(scope="module")
def jmesh():
    return _jax_mesh((1, 1), ("data", "model"))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).cpu().numpy()
    return np.asarray(t, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def test_local_mesh_is_a_world_of_one(mesh):
    assert tdist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert tmoe.DistCtx(mesh).model_shards == 1
    assert tmoe.LOCAL.model_shards == 1
    assert tmesh.mesh_shape_for(8, 2) == (4, 2)
    assert tmesh.mesh_shape_for(1, 4) == (1, 1)
    for survivors, model in ((7, 2), (16, 4), (3, 3)):
        plan = tft.plan_elastic_remesh(survivors, model)
        assert plan.mesh_shape == tmesh.mesh_shape_for(plan.devices, model)
    with pytest.raises(ValueError, match="divide"):
        tmesh.mesh_shape_for(6, 4)


# ---------------------------------------------------------------------------
# expert parallelism: the shard body
# ---------------------------------------------------------------------------
def _moe_case(cf, seed=0):
    jcfg = jconfigs.get_config("deepseek-v2-236b", smoke=True)
    tcfg = tconfigs.get_config("deepseek-v2-236b", smoke=True)
    jm = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=cf)
    maker = jlayers.ParamMaker(jax.random.PRNGKey(seed), dtype=jnp.float32)
    p = jax.tree.map(np.asarray, jmoe.make_moe(maker, "ffn", jcfg.d_model,
                                               jm))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    return jm, tm, p, tzoo.params_from_jax(p, device="cpu"), x


@pytest.mark.parametrize("n_shards", [2, 4])
def test_ep_shard_body_matches_reference(n_shards):
    """Every shard's body, with selected slots dropped by the slot
    capacity (capacity factor 0.5)."""
    jm, tm, p, tp, x = _moe_case(0.5)
    e_loc = tm.num_experts // n_shards
    ref = jax.jit(jmoe._routed_local, static_argnums=(5, 6, 7))
    _, top_e = tmoe.route(tp["router"],
                          torch.from_numpy(x).reshape(-1, x.shape[-1]), tm)
    t, k = top_e.shape
    cap = min(tmoe._round8(int(t * k * tm.capacity_factor) // n_shards),
              t * k)
    dropped = 0
    for my in range(n_shards):
        sl = slice(my * e_loc, (my + 1) * e_loc)
        want = ref(*(jnp.asarray(p[n]) if n == "router" else
                     jnp.asarray(p[n][sl]) for n in ("router", "gate", "up",
                                                     "down")),
                   jnp.asarray(x), jm, n_shards, my)
        got = tmoe._routed_local(tp["router"], tp["gate"][sl], tp["up"][sl],
                                 tp["down"][sl], torch.from_numpy(x), tm,
                                 n_shards, my)
        _close(got, want, EP_TOL, f"shard {my}")
        dropped += max(0, int(((top_e // e_loc) == my).sum()) - cap)
    assert dropped > 0


def test_one_shard_route_is_unchanged(mesh):
    """n_shards = 1, and a (1, 1) mesh, take today's single-device route
    (``route`` + ``dispatch_combine``), bit for bit."""
    _, tm, _, tp, x = _moe_case(1.25)
    xt = torch.from_numpy(x)
    top_p, top_e = tmoe.route(tp["router"], xt.reshape(-1, x.shape[-1]), tm)
    base = tmoe.dispatch_combine(tp["gate"], tp["up"], tp["down"], xt,
                                 top_p, top_e, tm)
    assert torch.equal(tmoe._routed_local(tp["router"], tp["gate"],
                                          tp["up"], tp["down"], xt, tm),
                       base)
    want = tmoe.moe_ffn(tp, xt, tm)
    assert torch.equal(tmoe.moe_ffn(tp, xt, tm, dist=tmoe.DistCtx(mesh)),
                       want)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 64)).astype(np.float32),
            "n": {"b": rng.standard_normal(67).astype(np.float32) * 1e-3}}


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return tree_map(torch.from_numpy, tree)


def _equal_trees(got, want, what):
    g = dict(tree_leaves(got))
    w = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(g) == sorted(w), what
    for key in g:
        np.testing.assert_array_equal(g[key].numpy(), w[key],
                                      err_msg=f"{what} {key}")


def test_compress_and_error_feedback_bit_equal_reference():
    g = _grads()
    jstate, tstate = jcomp.init_state(_jt(g)), tcomp.init_state(_tt(g))
    for step in range(3):
        gs = _grads(step)
        jc, jstate = jcomp.compress_grads(_jt(gs), jstate)
        tc, tstate = tcomp.compress_grads(_tt(gs), tstate)
        _equal_trees(tcomp.decompress_grads(tc), jcomp.decompress_grads(jc),
                     f"decompressed {step}")
        _equal_trees(tstate.residual, jstate.residual, f"residual {step}")
        assert tc["a"].q.dtype == torch.int8
        np.testing.assert_array_equal(tc["a"].q.numpy(), np.asarray(jc["a"].q))
        np.testing.assert_array_equal(tc["n"]["b"].scale.numpy(),
                                      np.asarray(jc["n"]["b"].scale))
    assert tcomp.compression_ratio(_tt(g)) == jcomp.compression_ratio(_jt(g))


def test_allreduce_compressed_one_rank_bit_equal_reference(mesh):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    jm = _jax_mesh((1,), ("pod",))
    g = _grads(3)
    state = jcomp.init_state(_jt(g))

    def f(gr, r):
        return jcomp.allreduce_compressed(gr, jcomp.ErrorFeedbackState(r),
                                          "pod")

    # Op by op, as tests/test_substrate.py runs it: under jit XLA fuses
    # the elementwise chain and moves the result by a float32 ulp.
    want, wstate = shard_map(f, mesh=jm, in_specs=(P(), P()),
                             out_specs=P(), check_rep=False)(
        _jt(g), state.residual)
    got, gstate = tcomp.allreduce_compressed(_tt(g),
                                             tcomp.init_state(_tt(g)))
    _equal_trees(got, want, "reduced")
    _equal_trees(gstate.residual, wstate.residual, "state")
    # at one rank the wire format gives back decompress(compress(g))
    comp, _ = tcomp.compress_grads(_tt(g), tcomp.init_state(_tt(g)))
    plain = tcomp.decompress_grads(comp)
    for key, t in tree_leaves(got):
        assert torch.equal(t, dict(tree_leaves(plain))[key]), key


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def _block_t(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _block_j(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("m", [1, 2, 5])
def test_pipeline_one_stage_matches_reference(mesh, m):
    from torch.distributed.device_mesh import init_device_mesh
    stage_mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
    rng = np.random.default_rng(m)
    d = 8
    params = {"w": (rng.standard_normal((1, d, d)) / np.sqrt(d))
              .astype(np.float32),
              "b": rng.standard_normal((1, d)).astype(np.float32)}
    x = rng.standard_normal((m, 4, d)).astype(np.float32)
    want = jpp.pipeline_forward(_block_j, _jt(params), jnp.asarray(x),
                                _jax_mesh((1,), ("stage",)), "stage")
    got = tpp.pipeline_forward(_block_t, _tt(params), torch.from_numpy(x),
                               stage_mesh, "stage")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    for s, mb in ((4, 4), (1, 8), (4, 28), (3, 1)):
        assert tpp.bubble_fraction(s, mb) == jpp.bubble_fraction(s, mb)


# ---------------------------------------------------------------------------
# flash-decode and the sharded CE through the model
# ---------------------------------------------------------------------------
def _qwen(seed=0, head_pad=1):
    jcfg = dataclasses.replace(jconfigs.get_config("qwen2-0.5b", smoke=True),
                               dtype="float32", head_pad=head_pad)
    tcfg = dataclasses.replace(tconfigs.get_config("qwen2-0.5b", smoke=True),
                               dtype="float32", head_pad=head_pad)
    jp = jax.tree.map(np.asarray, jzoo.init_params(jcfg,
                                                   jax.random.PRNGKey(seed)))
    return jcfg, tcfg, jp, tzoo.params_from_jax(jp, device="cpu")


def test_decode_axes_equal_reference(mesh, jmesh):
    jd, td = jmoe.DistCtx(jmesh), tmoe.DistCtx(mesh)
    for b, slots in ((1, 1024), (4, 77), (2, 8)):
        assert tattn.decode_axes(td, b, slots) == \
            jattn.decode_axes(jd, b, slots)
    assert tattn.decode_axes(tmoe.LOCAL, 4, 64) == (None, None)
    assert tattn.decode_axes(None, 4, 64) == (None, None)


def test_flash_decode_one_rank_matches_reference(mesh, jmesh, monkeypatch):
    """Prefill + 3 greedy decode steps with ``dist`` on both sides; every
    port decode step's attention went through ``flash_decode_gqa``."""
    jcfg, tcfg, jp, tp = _qwen(head_pad=3)
    assert tcfg.num_heads % tcfg.head_pad != 0      # padded heads
    calls = []
    real = tattn.flash_decode_gqa
    monkeypatch.setattr(tattn, "flash_decode_gqa",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jd, td = jmoe.DistCtx(jmesh), tmoe.DistCtx(mesh)
    b, s, steps = 2, 10, 3
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (b, s)) \
        .astype(np.int32)
    jprefill = jax.jit(lambda p, bt, c: jzoo.prefill_fn(p, bt, jcfg, c,
                                                        dist=jd))
    jdecode = jax.jit(lambda p, t, i, st: jzoo.decode_fn(p, t, i, jcfg, st,
                                                         dist=jd))
    jl, js = jprefill(jp, {"tokens": jnp.asarray(toks)},
                      jzoo.init_caches(jcfg, b, s + steps, jnp.float32))
    tl, ts = tzoo.prefill_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                             tcfg, tzoo.init_caches(tcfg, b, s + steps,
                                                    torch.float32, "cpu"),
                             dist=td)
    local = tzoo.init_caches(tcfg, b, s + steps, torch.float32, "cpu")
    ll, ls = tzoo.prefill_fn(tp, {"tokens": torch.from_numpy(toks).long()},
                             tcfg, local)
    assert not calls
    for step in range(steps):
        _close(tl, jl, F32_TOL, f"logits {step}")
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, js = jdecode(jp, jnp.asarray(tok), jnp.int32(s + step), js)
        tl, ts = tzoo.decode_fn(tp, torch.from_numpy(tok).long(), s + step,
                                tcfg, ts, dist=td)
        ll, ls = tzoo.decode_fn(tp, torch.from_numpy(tok).long(), s + step,
                                tcfg, ls)
        _close(tl, ll, F32_TOL, f"dist vs LOCAL {step}")
    _close(tl, jl, F32_TOL, "last logits")
    for (key, a), (_, w) in zip(tree_leaves(ts["layers"]),
                                tree_leaves(jax.tree.map(np.asarray,
                                                         js["layers"]))):
        _close(a, w, F32_TOL, f"cache {key}")
    assert len(calls) == steps * tcfg.num_layers


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_decode_dist_vs_local_within_bound(mesh, seed):
    """bf16 qwen2 smoke, prefill + 16 decode steps fed the same tokens:
    the flash-decode (P rounded to bf16 before the rescale) against the
    LOCAL grouped einsum (P normalised, then rounded) within 2^-5 of
    max|LOCAL| — the bound chip_smoke.py holds the full width to (its
    phase 14(a) reads weight seeds 0-3 there: at most 0.0244 on an H100
    80GB HBM3 at 700 W)."""
    cfg = tconfigs.get_config("qwen2-0.5b", smoke=True)
    params = tzoo.init_params(cfg, seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (4, 40), generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen)
    runs = []
    for d in (tmoe.LOCAL, tmoe.DistCtx(mesh)):
        lg, st = tzoo.prefill_fn(params, {"tokens": toks}, cfg,
                                 tzoo.init_caches(cfg, 4, 56, torch.bfloat16,
                                                  "cpu"), dist=d)
        outs = [lg]
        for i in range(16):
            lg, st = tzoo.decode_fn(params, steps[:, i:i + 1], 40 + i, cfg,
                                    st, dist=d)
            outs.append(lg)
        runs.append(outs)
    assert torch.equal(runs[0][0], runs[1][0])       # the prefill: no dist
    for i, (want, got) in enumerate(zip(*runs)):
        _close(got, want, 2.0 ** -5, f"step {i}")


def test_flash_decode_gqa_matches_reference(mesh, jmesh):
    """The function alone: a sliding window, empty slots (pos -1), GQA
    groups of 3, bf16 cache with float32 accumulation."""
    rng = np.random.default_rng(7)
    b, slots, kvh, g, hd = 2, 32, 2, 3, 16
    spec_kw = dict(d_model=64, num_heads=kvh * g, num_kv_heads=kvh,
                   head_dim=hd, window=20)
    pos = np.tile(np.arange(slots, dtype=np.int32), (b, 1))
    pos[:, 27:] = -1
    qpos = np.full((b, 1), 26, np.int32)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2.0 ** -8)):
        arrs = [rng.standard_normal(sh).astype(np.float32) for sh in
                ((b, 1, kvh * g, hd), (b, slots, kvh, hd),
                 (b, slots, kvh, hd))]
        jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in arrs)
        tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                      .to(getattr(torch, dtype)) for a in (jq, jk, jv))
        want = jax.jit(lambda *a: jattn.flash_decode_gqa(
            *a, jattn.AttnSpec(**spec_kw), jmoe.DistCtx(jmesh)))(
            jq, jk, jv, jnp.asarray(pos), jnp.asarray(qpos))
        got = tattn.flash_decode_gqa(tq, tk, tv, torch.from_numpy(pos),
                                     torch.from_numpy(qpos),
                                     tattn.AttnSpec(**spec_kw),
                                     tmoe.DistCtx(mesh))
        assert got.dtype == tq.dtype
        _close(got, want, tol, dtype)


def test_sharded_ce_one_rank_matches_reference(mesh, jmesh):
    """``loss_fn(dist)``'s loss and every gradient against
    ``jax.value_and_grad`` of the reference's on a (1, 1) mesh, which
    takes the vocab-sharded CE there too."""
    jcfg, tcfg, jp, tp = _qwen(2)
    jd, td = jmoe.DistCtx(jmesh), tmoe.DistCtx(mesh)
    assert jce.supports(jcfg.vocab_size, jd)
    assert tce.supports(tcfg.vocab_size, td)
    assert not tce.supports(tcfg.vocab_size, tmoe.LOCAL)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    arrs = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, bt: jzoo.loss_fn(p, bt, jcfg, dist=jd)))(
        jax.tree.map(jnp.asarray, jp),
        {k: jnp.asarray(v) for k, v in arrs.items()})
    want = dict(tree_leaves(jax.tree.map(np.asarray, grads)))
    params = tree_map(lambda t: t.requires_grad_(), tp)
    got_loss = tzoo.loss_fn(params, {k: torch.from_numpy(v)
                                     for k, v in arrs.items()}, tcfg,
                            dist=td)
    got_loss.backward()
    assert abs(float(got_loss.detach()) - float(loss)) <= \
        LOSS_RTOL * abs(float(loss))
    floor = GRAD_FLOOR * max(float(np.abs(g).max()) for g in want.values())
    got = {k: p.grad for k, p in tree_leaves(params)}
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        err = float(np.abs(g.numpy() - want[key]).max())
        assert err <= max(GRAD_TOL * float(np.abs(want[key]).max()), floor), \
            (key, err)

"""The port's training path against the reference: the data pipeline,
AdamW, full train steps, checkpoints in both directions, the driver
``launch.train.train`` on the CPU, and the fault-tolerance pieces.

Inputs are made from seeds with numpy (data batches, gradient trees) or
come from the reference's ``init_params`` through ``params_from_jax`` and
``adam_state_from_jax``.  Tolerances:
  * data batches, checkpoints, resume and the supervised loop: bit-equal.
  * ``lr_schedule``: bit-equal.  ``global_norm``: 1e-6 relative (the sum
    over leaves runs in another order; read: 1 float32 ulp).
  * ``apply`` with the clip inactive (global norm below ``grad_clip``):
    params, moments and step bit-equal to the reference run op by op, in
    float32 and bf16.  With the clip active the clip factor carries the
    norm's ulp: moments within 1e-6 relative of max |m|, |v|; params
    within 1e-6 relative in float32 and one bf16 ulp in bf16.
  * three full train steps (mamba2 smoke, float32, the reference's step
    jitted as its driver jits it): losses within 1e-5 relative; params
    within 1e-2 * lr of the reference's (read: 1.8e-3 * lr, the embedding
    table).  Adam divides each entry's moment by its own root mean
    square, so where an entry's gradient is near 0 a rounding difference
    in it moves that entry's step by up to lr.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jdata
from repro.models import model_zoo as jzoo
from repro.optim import optimizer as jopt
from repro.runtime import fault_tolerance as jft
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo as tzoo
from repro_torch.models.layers import EXACT_CTX
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import optimizer as topt
from repro_torch.runtime import fault_tolerance as tft

ARCH = "mamba2-130m"


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_batches_equal_reference(hosts):
    kw = dict(vocab_size=300, seq_len=40, global_batch=4, seed=5)
    want = jdata.make_source(jdata.DataConfig(**kw))
    got = tdata.make_source(tdata.DataConfig(**kw))
    assert isinstance(got, tdata.SyntheticLM)
    for step in (0, 1, 7):
        for host in range(hosts):
            a, b = got.batch(step, host, hosts), want.batch(step, host, hosts)
            assert sorted(a) == sorted(b) == ["targets", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    it_t = tdata.iterate(tdata.DataConfig(**kw), start_step=3)
    it_j = jdata.iterate(jdata.DataConfig(**kw), start_step=3)
    for _ in range(2):
        np.testing.assert_array_equal(next(it_t)["tokens"],
                                      next(it_j)["tokens"])


def test_file_shards_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    for i, n in enumerate((500, 333, 90)):
        np.save(tmp_path / f"shard_{i:03d}.npy",
                rng.integers(0, 1000, n).astype(np.uint16))
    np.save(tmp_path / "other.npy", np.zeros(10, np.uint16))
    kw = dict(vocab_size=1000, seq_len=20, global_batch=3,
              source="file", path=str(tmp_path))
    want = jdata.make_source(jdata.DataConfig(**kw))
    got = tdata.make_source(tdata.DataConfig(**kw))
    assert got.files == want.files and len(got.files) == 3
    for step in range(5):          # the last shard is shorter than a batch
        for host, hosts in ((0, 1), (1, 2)):
            a, b = got.batch(step, host, hosts), want.batch(step, host, hosts)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tdata.FileShards(tdata.DataConfig(**{**kw, "path": str(empty)}))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
ADAM = dict(lr=1e-3, warmup_steps=3, total_steps=40)


def test_lr_schedule_and_global_norm_match_reference():
    jc, tc = jopt.AdamWConfig(**ADAM), topt.AdamWConfig(**ADAM)
    for step in range(45):
        want = np.float32(jopt.lr_schedule(jc, jnp.int32(step)))
        got = topt.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert np.float32(got) == want, step
    tree = _tree(np.random.default_rng(0), "float32")
    want = float(jopt.global_norm(tree))
    got = float(topt.global_norm(tzoo.params_from_jax(
        jax.tree.map(np.asarray, tree), device="cpu")))
    assert abs(got - want) <= 1e-6 * want


def _tree(rng, dtype, scale=1.0):
    shapes = {"a": {"w": (33, 17), "b": (17,)}, "c": (5,),
              "d": {"x": (4, 3, 2)}}
    return jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s) * scale).astype(dtype),
        shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_reference(dtype, clipped):
    """Three AdamW updates from the same params, op by op on both sides;
    the port's params stay the same leaf tensors."""
    rng = np.random.default_rng(1)
    jc, tc = jopt.AdamWConfig(**ADAM), topt.AdamWConfig(**ADAM)
    jp = _tree(rng, dtype)
    js = jopt.init(jp)
    tp = tree_map(lambda t: t.requires_grad_(), tzoo.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu"))
    leaves = [id(t) for _, t in tree_leaves(tp)]
    ts = topt.init(tp)
    for _ in range(3):
        g = _tree(rng, dtype, scale=0.3 if clipped else 0.01)
        jp, js, jm = jopt.apply(jc, jp, js, g)
        tp, ts, tm = topt.apply(tc, tp, ts, tzoo.params_from_jax(
            jax.tree.map(np.asarray, g), device="cpu"))
        assert (float(jm["grad_norm"]) > 1.0) == clipped
        assert float(tm["lr"]) == float(jm["lr"])
    assert [id(t) for _, t in tree_leaves(tp)] == leaves
    assert all(t.requires_grad and t.is_leaf for _, t in tree_leaves(tp))
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    pairs = [(tp, jp, "params"), (ts.m, js.m, "m"), (ts.v, js.v, "v")]
    for got, want, what in pairs:
        for (key, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
            a, b = _np(a), _np(b)
            if not clipped:
                np.testing.assert_array_equal(a, b, f"{what} {key}")
            elif what == "params" and dtype == "bfloat16":
                ulp = 2.0 ** (np.floor(np.log2(np.abs(b) + 1e-30)) - 7)
                assert (np.abs(a - b) <= ulp).all(), (what, key)
            else:
                tol = 1e-6 * np.abs(b).max()
                assert np.abs(a - b).max() <= tol, (what, key)


def test_three_train_steps_match_reference():
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                               dtype="float32")
    adam = dict(lr=1e-3, warmup_steps=2, total_steps=3)
    jadam, tadam = jopt.AdamWConfig(**adam), topt.AdamWConfig(**adam)
    jp = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    js = jopt.init(jp)
    tp = tree_map(lambda t: t.requires_grad_(), tzoo.params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu"))
    ts = tzoo.adam_state_from_jax(jax.tree.map(np.asarray, js),
                                  device="cpu")

    @jax.jit
    def jstep(params, state, tokens, targets):
        loss, grads = jax.value_and_grad(lambda p: jzoo.loss_fn(
            p, {"tokens": tokens, "targets": targets}, jcfg))(params)
        params, state, _ = jopt.apply(jadam, params, state, grads)
        return params, state, loss

    source = tdata.make_source(tdata.DataConfig(
        vocab_size=tcfg.vocab_size, seq_len=16, global_batch=2, seed=0))
    for step in range(3):
        b = source.batch(step)
        jp, js, jl = jstep(jp, js, jnp.asarray(b["tokens"]),
                           jnp.asarray(b["targets"]))
        tl, ts, _ = ttrain.train_step(
            tp, ts, ttrain.device_batch(b, tcfg, torch.device("cpu")),
            tcfg, EXACT_CTX, tadam)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), step
    for (key, a), (_, b) in zip(tree_leaves(tp), tree_leaves(jp)):
        assert np.abs(_np(a) - _np(b)).max() <= 1e-2 * adam["lr"], key


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _trained_pair():
    """A bf16 mamba2 smoke tree and an AdamState with a non-trivial step
    and moments, in both packages."""
    cfg = jconfigs.get_config(ARCH, smoke=True)
    jp = jzoo.init_params(cfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    js = jopt.AdamState(
        jnp.int32(7),
        jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), jnp.float32), jp),
        jax.tree.map(lambda p: jnp.asarray(
            rng.random(p.shape), jnp.float32), jp))
    tp = tzoo.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ts = tzoo.adam_state_from_jax(jax.tree.map(np.asarray, js),
                                  device="cpu")
    return (jp, js), (tp, ts)


def _assert_same(port_tree, ref_tree):
    got = list(tree_leaves(tuple(port_tree)))
    want = list(tree_leaves(jax.tree.map(np.asarray, tuple(ref_tree))))
    assert len(got) == len(want)
    for (_, a), (_, b) in zip(got, want):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


def test_checkpoints_cross_both_ways(tmp_path):
    (jp, js), (tp, ts) = _trained_pair()
    jckpt.save(str(tmp_path / "ref"), 7, (jp, js), extra={"loss": 1.5})
    tckpt.save(str(tmp_path / "port"), 7, (tp, ts), extra={"loss": 1.5})
    keys = {}
    for side in ("ref", "port"):
        with open(tmp_path / side / "step_00000007" / "manifest.json") as f:
            m = json.load(f)
        keys[side] = {k: (v["shape"], v["dtype"], v["crc32"])
                      for k, v in m["arrays"].items()}
        assert m["step"] == 7 and m["extra"] == {"loss": 1.5}
    assert keys["ref"] == keys["port"]
    assert {"1/.step", "0/embed/table", "1/.m/embed/table",
            "1/.v/mamba/stack/mamba/in_proj/w"} <= set(keys["port"])
    assert keys["port"]["0/embed/table"][1] == "float32"   # bf16 upcast
    # reference -> port, into a zero template
    zero = (tree_map(torch.zeros_like, tp),
            topt.AdamState(torch.zeros((), dtype=torch.int32),
                           tree_map(torch.zeros_like, ts.m),
                           tree_map(torch.zeros_like, ts.v)))
    (rp, rs), manifest = tckpt.restore(str(tmp_path / "ref"), zero)
    assert manifest["step"] == 7 and isinstance(rs, topt.AdamState)
    _assert_same((rp, rs), (jp, js))
    # port -> reference
    (bp, bs), _ = jckpt.restore(str(tmp_path / "port"), (jp, js))
    _assert_same((tp, ts), (bp, bs))


def test_checkpoint_crc_mismatch_raises_and_retain(tmp_path):
    (_, _), (tp, ts) = _trained_pair()
    root = str(tmp_path)
    for step in (2, 4, 6, 8):
        tckpt.save(root, step, (tp, ts))
    os.makedirs(tmp_path / "step_00000009.tmp")          # a crashed save
    assert tckpt.latest_step(root) == 8
    tckpt.retain(root, keep_last=2, pin_step=2)
    assert sorted(d for d in os.listdir(root) if not d.endswith(".tmp")) \
        == ["step_00000002", "step_00000006", "step_00000008"]
    # Corrupt one array of step 8: restore must refuse it.
    path = tmp_path / "step_00000008" / "arrays.npz"
    arrays = dict(np.load(path))
    arrays["0/final_ln"] = arrays["0/final_ln"] + 1.0
    np.savez(path, **arrays)
    with pytest.raises(IOError, match="checksum mismatch for 0/final_ln"):
        tckpt.restore(root, (tp, ts))
    (rp, _), _ = tckpt.restore(root, (tp, ts), verify=False)
    assert torch.equal(rp["final_ln"], tp["final_ln"] + 1.0)
    restored, manifest = tckpt.restore(root, (tp, ts), step=6)
    assert manifest["step"] == 6
    for (key, a), (_, b) in zip(tree_leaves(tuple(restored)),
                                tree_leaves((tp, ts))):
        assert a.dtype == b.dtype and torch.equal(a, b), key
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "empty"), (tp, ts))


# ---------------------------------------------------------------------------
# the driver, on the CPU
# ---------------------------------------------------------------------------
def test_train_loss_falls_and_resume_is_exact(tmp_path):
    kw = dict(smoke=True, batch=4, seq=32, device="cpu", log_every=100)
    full = ttrain.train(ARCH, steps=20, ckpt_dir=str(tmp_path / "a"),
                        ckpt_every=10, **kw)
    assert full.steps == 20 and len(full.losses) == 20
    assert np.mean(full.losses[-5:]) < np.mean(full.losses[:5])
    assert tckpt.latest_step(str(tmp_path / "a")) == 20
    d = str(tmp_path / "b")
    ttrain.train(ARCH, steps=10, ckpt_dir=d, ckpt_every=10, total_steps=20,
                 **kw)
    resumed = ttrain.train(ARCH, steps=20, ckpt_dir=d, ckpt_every=10,
                           resume=True, **kw)
    assert resumed.steps == 10
    assert resumed.losses == full.losses[10:]
    for (key, a), (_, b) in zip(tree_leaves(resumed.params),
                                tree_leaves(full.params)):
        assert torch.equal(a, b), key


@pytest.mark.parametrize("arch", ["whisper-tiny", "llava-next-mistral-7b"])
def test_train_runs_the_stubbed_frontends(arch):
    """Audio trains on zero frames and the VLM on zero patches, as in the
    reference; photonic QAT on the CPU runs the plain GEMM."""
    res = ttrain.train(arch, steps=2, batch=2, seq=24, device="cpu",
                       numerics="photonic_heana")
    assert res.steps == 2 and all(np.isfinite(res.losses))


def test_resilient_loop_restores_exact_state(tmp_path):
    """The supervised loop with injected failures lands on the same params
    as an uninterrupted run (the port's train_step and checkpoints)."""
    cfg = tconfigs.get_config("qwen2-0.5b", smoke=True)
    adam = topt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=24)
    data = tdata.make_source(tdata.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=3))
    cpu = torch.device("cpu")

    def run(fail_at, root):
        params = tree_map(lambda p: p.requires_grad_(),
                          tzoo.init_params(cfg, 0, device="cpu"))
        holder = {"params": params, "state": topt.init(params)}
        tckpt.save(root, 0, (holder["params"], holder["state"]))

        def do_step(s):
            if s in fail_at:
                fail_at.remove(s)
                raise RuntimeError("injected failure")
            _, holder["state"], _ = ttrain.train_step(
                holder["params"], holder["state"],
                ttrain.device_batch(data.batch(s), cfg, cpu), cfg,
                EXACT_CTX, adam)

        def save(s):
            tckpt.save(root, s, (holder["params"], holder["state"]))

        def restore():
            (p, holder["state"]), m = tckpt.restore(
                root, (holder["params"], holder["state"]))
            holder["params"] = tree_map(lambda t: t.requires_grad_(), p)
            return m["step"]

        rep = tft.run_resilient_loop(do_step, save, restore,
                                     total_steps=12, checkpoint_every=4)
        return holder["params"], rep

    p_clean, rep_clean = run(set(), str(tmp_path / "a"))
    p_faulty, rep_faulty = run({3, 9}, str(tmp_path / "b"))
    assert rep_clean.failures_survived == 0
    assert rep_faulty.failures_survived == rep_faulty.restores == 2
    for (key, a), (_, b) in zip(tree_leaves(p_clean), tree_leaves(p_faulty)):
        assert torch.equal(a, b), key


def test_straggler_plus_remesh_plan_and_heartbeats():
    """As tests/test_train_integration.py's straggler case, on both
    packages; heartbeats on a fake clock."""
    for ft in (tft, jft):
        pol = ft.StragglerPolicy(strikes_to_flag=2)
        hosts = [f"h{i}" for i in range(8)]   # 8 hosts x 64 chips
        for _ in range(6):
            for h in hosts:
                pol.record(h, 1.0 if h != "h5" else 9.0)
            flagged = pol.update_strikes()
        assert flagged == ["h5"]
        plan = ft.plan_elastic_remesh((len(hosts) - len(flagged)) * 64,
                                      model_axis=16)
        assert (plan.model, plan.data, plan.devices) == (16, 28, 448)
        with pytest.raises(RuntimeError, match="cannot re-mesh"):
            ft.plan_elastic_remesh(8, model_axis=16)
        now = [0.0]
        mon = ft.HeartbeatMonitor(["a", "b"], dead_after=5.0,
                                  clock=lambda: now[0])
        now[0] = 4.0
        mon.beat("a")
        now[0] = 6.0
        assert mon.dead_hosts() == ["b"] and not mon.all_alive()

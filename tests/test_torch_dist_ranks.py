"""The port's distributed code paths across 2 and 4 ranks, on the CPU over
gloo (``torch.multiprocessing`` spawn; rendezvous through a FileStore
under the test's own directory, no network port).  Every check of a rank
count runs in ONE spawn; ``join`` has its own deadline, so a hung rank
fails the test.  Smoke widths, float32; what each rank computes is held
against the same computation made in one process:

  * expert-parallel ``moe_ffn`` (deepseek-v2 smoke, mesh (1, n): each rank
    holds n-th of the experts) against the shard bodies
    (``_routed_local(..., n, s)`` for every s) summed in one process plus
    the shared experts: bit-equal at 2 ranks (two addends commute), 1e-6
    relative at 4 (gloo may associate four addends otherwise);
  * ``flash_decode_gqa`` with the slots split over n ranks against the
    one-rank result (mesh (1, 1) is not needed: the one-process decode
    ``_gqa_scores_softmax_out`` computes the same softmax), 1e-5; and
    qwen2's whole decode step through ``decode_fn(dist)`` against
    ``LOCAL``, 1e-4;
  * the vocab-sharded CE through ``loss_fn(dist)`` against the unsharded
    ``loss_fn``: loss rtol 1e-5, gradients 1e-4 of the largest (floor
    1e-6) — on mesh (1, n) every rank's; on mesh (2, 2) each data rank
    holds half the batch and the gradients summed over the data group;
    model ranks hold bit-equal gradients;
  * ``pipeline_forward`` over n stages against the stages run one after
    another, rtol = atol = 2e-5 (the reference's bound);
  * ``allreduce_compressed`` against a numpy model of the wire format
    (int8 payloads summed exactly, the mean scale, the int8
    requantization and all-gather): bit-equal at 2 ranks, 1e-6 relative
    at 4 (the scales' float sum); the error-feedback state bit-equal to
    ``compress_grads``'.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

JOIN_TIMEOUT_S = 150.0


def _close(got, want, tol, what):
    got = got.detach().to(torch.float32).numpy()
    want = want.detach().to(torch.float32).numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _check_moe(mesh, n):
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(configs.get_config("deepseek-v2-236b",
                                                 smoke=True),
                              dtype="float32")
    maker = L.ParamMaker(0, dtype=torch.float32)
    p = M.make_moe(maker, "ffn", cfg.d_model, cfg.moe)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    e_loc = cfg.moe.num_experts // n
    my = mesh.get_local_rank("model")

    def part(s):
        sl = slice(s * e_loc, (s + 1) * e_loc)
        return {**p, **{k: p[k][sl] for k in ("gate", "up", "down")}}
    got = M.moe_ffn(part(my), x, cfg.moe, dist=M.DistCtx(mesh))
    routed = M._routed_local(p["router"], *(part(0)[k] for k in
                                            ("gate", "up", "down")),
                             x, cfg.moe, n, 0)
    for s in range(1, n):
        routed = routed + M._routed_local(
            p["router"], *(part(s)[k] for k in ("gate", "up", "down")), x,
            cfg.moe, n, s)
    want = L.mlp(p["shared"], x, L.EXACT_CTX, "moe.shared") + routed
    if n == 2:
        assert torch.equal(got, want)
    else:
        _close(got, want, 1e-6, "moe")


def _check_flash_decode(mesh, n):
    from repro_torch import configs
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import model_zoo as zoo
    dist = M.DistCtx(mesh)
    rng = np.random.default_rng(2)
    b, slots, kvh, g, hd = 2, 32, 2, 3, 16
    spec = A.AttnSpec(d_model=64, num_heads=kvh * g, num_kv_heads=kvh,
                      head_dim=hd, window=20)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((b, 1, kvh * g, hd), (b, slots, kvh, hd),
                          (b, slots, kvh, hd)))
    pos = torch.arange(slots, dtype=torch.int32).repeat(b, 1)
    pos[:, 27:] = -1
    qpos = torch.full((b, 1), 26, dtype=torch.int32)
    got = A.flash_decode_gqa(q, k, v, pos, qpos, spec, dist)
    want = A._gqa_scores_softmax_out(
        q, k, v, A._mask_bias(qpos, pos, spec.window, spec.causal),
        spec.num_heads)
    _close(got, want, 1e-5, "flash_decode_gqa")

    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b", smoke=True),
                              dtype="float32")
    params = zoo.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    outs = []
    for d in (M.LOCAL, dist):
        caches = zoo.init_caches(cfg, 2, 12, torch.float32, "cpu")
        _, st = zoo.prefill_fn(params, {"tokens": toks}, cfg, caches, dist=d)
        logits, _ = zoo.decode_fn(params, toks[:, -1:], 9, cfg, st, dist=d)
        outs.append(logits)
    _close(outs[1], outs[0], 1e-4, "decode_fn(dist)")


def _grads_of(params):
    from repro_torch.models.transformer import tree_leaves
    return {k: p.grad for k, p in tree_leaves(params)}


def _check_sharded_ce(mesh, n):
    from repro_torch import configs
    from repro_torch.models import moe as M
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import tree_map
    from repro_torch.parallel import sharding as shd
    cfg = dataclasses.replace(configs.get_config("qwen2-0.5b", smoke=True),
                              dtype="float32")
    base = zoo.init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 9)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def run(d, rows):
        params = tree_map(lambda t: t.clone().requires_grad_(), base)
        loss = zoo.loss_fn(params, {k: v[rows] for k, v in batch.items()},
                           cfg, dist=d)
        loss.backward()
        return loss, _grads_of(params)
    want_loss, want = run(M.LOCAL, slice(None))
    floor = 1e-6 * max(float(g.abs().max()) for g in want.values())
    meshes = [(mesh, slice(None))]
    if n == 4:
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
        d_rank = dm.get_local_rank("data")
        meshes.append((dm, slice(2 * d_rank, 2 * d_rank + 2)))
    for m, rows in meshes:
        loss, grads = run(M.DistCtx(m), rows)
        assert abs(float(loss.detach()) - float(want_loss.detach())) <= \
            1e-5 * abs(float(want_loss.detach()))
        data_group = shd.axes_group(m, ("data",))
        model_group = shd.axes_group(m, ("model",))
        for key, g in grads.items():
            mine = g.clone()
            peers = [torch.empty_like(g) for _ in
                     range(tdist.get_world_size(model_group))]
            tdist.all_gather(peers, g, group=model_group)
            assert all(torch.equal(mine, p) for p in peers), key
            tdist.all_reduce(g, group=data_group)
            err = float((g - want[key]).abs().max())
            assert err <= max(1e-4 * float(want[key].abs().max()), floor), \
                (key, err)


def _check_pipeline(n):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel import pipeline_parallel as pp
    mesh = init_device_mesh("cpu", (n,), mesh_dim_names=("stage",))
    rng = np.random.default_rng(4)
    d = 8
    params = {"w": torch.from_numpy((rng.standard_normal((n, d, d)) /
                                     np.sqrt(d)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal((n, d))
                                    .astype(np.float32))}

    def block(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    for m in (1, 3, 6):
        x = torch.from_numpy(rng.standard_normal((m, 4, d))
                             .astype(np.float32))
        got = pp.pipeline_forward(block, params, x, mesh, "stage")
        want = x.clone()
        for s in range(n):
            want = block({k: v[s] for k, v in params.items()}, want)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5)


def _np_compress(g):
    scale = np.float32(max(np.float32(np.abs(g).max()),
                           np.float32(1e-12))) / np.float32(127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale)


def _np_allreduce(grads_by_rank):
    """numpy model of the wire format for one tensor."""
    n = len(grads_by_rank)
    shape = grads_by_rank[0].shape
    qs, scales = zip(*(_np_compress(g) for g in grads_by_rank))
    flat = [q.reshape(-1).astype(np.int32) for q in qs]
    pad = (-flat[0].size) % n
    flat = [np.pad(f, (0, pad)) for f in flat]
    total = sum(flat)                                  # exact
    scale = np.float32(0.0)
    for s in scales:
        scale = np.float32(scale + s)
    scale = np.float32(scale / np.float32(n))
    chunks = total.reshape(n, -1)
    out = []
    for c in chunks:
        cf = (c.astype(np.float32) * scale / np.float32(n)).astype(np.float32)
        cq, cs = _np_compress(cf)
        out.append(cq.astype(np.float32) * cs)
    out = np.concatenate(out)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def _check_compression(n, rank):
    from repro_torch.optim import compression as C

    def grads(r):
        rng = np.random.default_rng(10 + r)
        return {"a": rng.standard_normal((33, 7)).astype(np.float32),
                "n": {"b": (rng.standard_normal(129) * 1e-3)
                      .astype(np.float32)}}
    mine = {"a": torch.from_numpy(grads(rank)["a"]),
            "n": {"b": torch.from_numpy(grads(rank)["n"]["b"])}}
    out, state = C.allreduce_compressed(mine, C.init_state(mine))
    _, want_state = C.compress_grads(mine, C.init_state(mine))
    assert torch.equal(state.residual["a"], want_state.residual["a"])
    for get in (lambda t: t["a"], lambda t: t["n"]["b"]):
        want = _np_allreduce([get(grads(r)) for r in range(n)])
        if n == 2:
            np.testing.assert_array_equal(get(out).numpy(), want)
        else:
            np.testing.assert_allclose(get(out).numpy(), want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))


def _rank_main(rank, world, store_path):
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store_path, world),
                             rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(model=world, device_type="cpu")
        assert tuple(mesh.shape) == (1, world)
        _check_moe(mesh, world)
        _check_flash_decode(mesh, world)
        _check_sharded_ce(mesh, world)
        _check_pipeline(world)
        _check_compression(world, rank)
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_paths_across_ranks(world, tmp_path):
    ctx = tmp.start_processes(_rank_main,
                              args=(world, str(tmp_path / "store")),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks did not finish in "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    assert all(p.exitcode == 0 for p in ctx.processes)

"""The port's distribution plan against the reference's, entry for entry:
spec trees (``param_specs``), pspecs (``spec_to_pspec`` /
``param_shardings`` under RULES and FSDP_RULES), the decode caches' and
ZeRO-1 moments' pspecs, and the dry run's stand-ins (``input_specs``,
``cache_specs``: ``meta`` tensors against ``ShapeDtypeStruct``s), for
every arch of the zoo at its full and smoke configs, on the reference's
16x16 and 2x16x16 abstract meshes.  All equalities are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.parallel import sharding as jshd
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model_zoo as tzoo
from repro_torch.parallel import sharding as tshd

ARCHS = tconfigs.list_archs()
MESHES = {"single": ((("data", 16), ("model", 16)), False),
          "multi": ((("pod", 2), ("data", 16), ("model", 16)), True)}


def _jmesh(axes):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(axes)
    except TypeError:                      # older (shape, names) signature
        return AbstractMesh(tuple(s for _, s in axes),
                            tuple(n for n, _ in axes))


def _flat(tree, prefix=()):
    """[(path, leaf)] over nested dicts, sorted by key; anything else is a
    leaf (spec tuples included)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _jpspecs(tree):
    return [(p, tuple(ns.spec)) for p, ns in _flat(tree)]


def _meshes():
    for name, (axes, multi) in MESHES.items():
        yield name, _jmesh(axes), tmesh.make_production_mesh(multi_pod=multi)


def test_arch_list_is_the_references():
    assert tuple(ARCHS) == tuple(jconfigs.list_archs())


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, smoke):
    want = _flat(jzoo.param_specs(jconfigs.get_config(arch, smoke=smoke)))
    got = _flat(tzoo.param_specs(tconfigs.get_config(arch, smoke=smoke)))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert got == want
    # one spec per dimension of the param it names
    params = _flat(tzoo.init_params(tconfigs.get_config(arch, smoke=smoke),
                                    0, device="meta"))
    assert [p for p, _ in params] == [p for p, _ in got]
    for (_, t), (path, axes) in zip(params, got):
        assert t.dim() == len(axes), (path, tuple(t.shape), axes)


def test_production_mesh_is_the_references():
    for name, jm, tm in _meshes():
        assert tshd.axis_sizes(tm) == dict(jm.shape), name
        assert tshd.data_axes(tm) == jshd.data_axes(jm)
    assert tmesh.make_production_mesh().size == 256
    assert tmesh.make_production_mesh(multi_pod=True).size == 512


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jspecs, tspecs = jzoo.param_specs(jcfg), tzoo.param_specs(tcfg)
    jabs = jzoo.init_params(jcfg, jax.random.PRNGKey(0), abstract=True)
    tabs = tzoo.init_params(tcfg, 0, device="meta")
    for rules_name in ("RULES", "FSDP_RULES"):
        jr, tr = getattr(jshd, rules_name), getattr(tshd, rules_name)
        for _, axes in _flat(tspecs):
            assert tshd.spec_to_pspec(axes, tr) == \
                tuple(jshd.spec_to_pspec(axes, jr)), (axes, rules_name)
        for name, jm, tm in _meshes():
            want = _jpspecs(jshd.param_shardings(jspecs, jm, jabs, jr))
            got = _flat(tshd.param_shardings(tspecs, tm, tabs, tr))
            assert got == want, (name, rules_name)
            want = _jpspecs(jshd.param_shardings(jspecs, jm, rules=jr))
            got = _flat(tshd.param_shardings(tspecs, tm, rules=tr))
            assert got == want, (name, rules_name, "no shapes")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_zero1_shardings_equal_reference(arch):
    """Every decode cell's cache pspecs and every train cell's ZeRO-1
    moment pspecs (the rules the dry run picks: FSDP for MoE)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    rules = "FSDP_RULES" if tcfg.moe is not None else "RULES"
    n_cells = 0
    for shape_name, shape in tconfigs.SHAPES.items():
        jshape = jconfigs.SHAPES[shape_name]
        ok = tconfigs.cell_is_supported(tcfg, shape)[0]
        assert ok == jconfigs.cell_is_supported(jcfg, jshape)[0]
        if not ok:
            continue
        for name, jm, tm in _meshes():
            if shape.kind == "decode":
                want = _jpspecs(jshd.cache_shardings(
                    jzoo.cache_specs(jcfg, jshape), jm,
                    jshape.global_batch))
                got = _flat(tshd.cache_shardings(
                    tzoo.cache_specs(tcfg, shape), tm, shape.global_batch))
                assert got == want, (shape_name, name)
                n_cells += 1
            elif shape.kind == "train":
                jabs = jzoo.init_params(jcfg, jax.random.PRNGKey(0),
                                        abstract=True)
                want = _jpspecs(jshd.zero1_shardings(
                    jzoo.param_specs(jcfg), jm, jabs,
                    getattr(jshd, rules)))
                got = _flat(tshd.zero1_shardings(
                    tzoo.param_specs(tcfg), tm,
                    tzoo.init_params(tcfg, 0, device="meta"),
                    getattr(tshd, rules)))
                assert got == want, (shape_name, name)
                n_cells += 1
    assert n_cells > 0


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_reference(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for shape_name, shape in tconfigs.SHAPES.items():
        jshape = jconfigs.SHAPES[shape_name]
        if not tconfigs.cell_is_supported(tcfg, shape)[0]:
            continue
        trees = [(jzoo.input_specs(jcfg, jshape),
                  tzoo.input_specs(tcfg, shape))]
        if shape.kind == "decode":
            trees.append((jzoo.cache_specs(jcfg, jshape),
                          tzoo.cache_specs(tcfg, shape)))
        for jt, tt in trees:
            want, got = _flat(jt), _flat(tt)
            assert [p for p, _ in got] == [p for p, _ in want]
            for (path, t), (_, s) in zip(got, want):
                assert t.device.type == "meta", path
                assert tuple(t.shape) == tuple(s.shape), (shape_name, path)
                assert _dtype_name(t.dtype) == str(jnp.dtype(s.dtype)), \
                    (shape_name, path)


def test_local_shard_cuts_model_major():
    """A dimension over ('model', 'data') splits into |model| x |data|
    pieces, the model index major (JAX's order); stacked dims compose."""
    mesh = tmesh.AbstractMesh(("data", "model"), (2, 3))
    t = torch.arange(12 * 4).reshape(12, 4)
    seen = []
    for d in range(2):
        for m in range(3):
            piece = tshd.local_shard(t, (("model", "data"), None), mesh,
                                     {"data": d, "model": m})
            assert piece.shape == (2, 4)
            assert int(piece[0, 0]) // 4 == (m * 2 + d) * 2
            seen.append(piece)
    assert torch.equal(torch.sort(torch.cat(seen).reshape(-1))[0],
                       t.reshape(-1))
    t2 = torch.arange(12 * 6).reshape(12, 6)
    piece = tshd.local_shard(t2, ("data", "model"), mesh,
                             {"data": 1, "model": 2})
    np.testing.assert_array_equal(piece.numpy(), t2.numpy()[6:12, 4:6])
    with pytest.raises(ValueError, match="divide"):
        tshd.local_shard(torch.zeros(5, 3), ("data", None), mesh,
                         {"data": 0, "model": 0})


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b",
                                  "whisper-tiny"])
def test_dryrun_shard_shapes_are_the_references(arch, tmp_path):
    """``launch/dryrun.py``'s per-device shapes equal the reference
    plan's ``NamedSharding.shard_shape`` leaf by leaf (params under the
    dry run's rules, decode caches), and a cell's JSON lands where asked:
    the parameter bytes summed over the leaves' shard shapes."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro_torch.launch import dryrun
    tcfg = tconfigs.get_config(arch)
    rules = tshd.FSDP_RULES if tcfg.moe is not None else tshd.RULES
    params = tzoo.init_params(tcfg, 0, device="meta")
    state = tzoo.cache_specs(tcfg, tconfigs.SHAPES["decode_32k"])
    for name, jm, tm in _meshes():
        trees = [(params, tshd.param_shardings(tzoo.param_specs(tcfg), tm,
                                               params, rules)),
                 (state, tshd.cache_shardings(state, tm, 128))]
        for tree, specs in trees:
            for (path, t), (_, spec) in zip(_flat(tree), _flat(specs)):
                want = NamedSharding(jm, P(*spec)).shard_shape(
                    tuple(t.shape))
                assert dryrun.shard_shape(tuple(t.shape), spec, tm) == \
                    tuple(want), (name, path)
        rec = dryrun.run_cell(arch, "decode_32k", name, out_dir=tmp_path)
        assert rec["status"] == "ok" and rec["devices"] == tm.size
        assert rec["bytes_per_device"]["params"] == dryrun.device_bytes(
            params, trees[0][1], tm)
        assert (tmp_path / f"{arch}__decode_32k__{name}.json").exists()
    rec = dryrun.run_cell(arch, "long_500k", "single", out_dir=tmp_path)
    assert rec["status"] == ("ok" if tconfigs.cell_is_supported(
        tcfg, tconfigs.SHAPES["long_500k"])[0] else "skipped")

"""Port conformance for the lowering's data movement and glue: im2col,
the depthwise block-diagonal operand, pools, shuffle/slice/concat, and
the exact-matmul walk of every zoo network, against the reference on the
same seeded numpy inputs; and the conv operand the walk hands its GEMMs
(``ConvOperand``: its im2col matrix, the pixels its windows cover, which
the TAOM kernels' |max| reads, and which benchmark layers are views).

Tolerance: bit-equal for pure data movement, max pools and the
window-ordered average pool; the global average pool and the exact
matmuls sum in an order XLA and PyTorch may choose differently (rtol
1e-6 for a mean, 1e-5 through a network of f32 matmuls)."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lowering as jlw
from repro.models.zoo_cnn import ZOO as JZOO

from repro_torch.kernels.taom_gemm import covered_axis
from repro_torch.models import lowering as tlw
from repro_torch.models.lowering import params_from_jax
from repro_torch.models.zoo_cnn import ZOO


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("hw", [(7, 9), (8, 8)])
@pytest.mark.parametrize("kk", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["same", "valid"])
def test_im2col_bit_equal(hw, kk, stride, padding):
    x = _x((2, *hw, 3))
    jcols, jout = jlw.im2col(jnp.asarray(x), kk, kk, stride, padding)
    tcols, tout = tlw.im2col(torch.from_numpy(x), kk, kk, stride, padding)
    assert tout == jout
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))


def test_depthwise_block_diag_bit_equal():
    w = _x((9, 6), 1)
    np.testing.assert_array_equal(
        tlw.depthwise_block_diag(torch.from_numpy(w)).numpy(),
        np.asarray(jlw.depthwise_block_diag(jnp.asarray(w))))


@pytest.mark.parametrize("kind,size,stride,padding,hw", [
    ("max", 2, 2, "valid", (8, 6)), ("max", 3, 1, "same", (7, 9)),
    ("max", 3, 2, "same", (7, 8)), ("avg", 2, 2, "valid", (8, 6)),
    ("avg", 3, 2, "valid", (9, 7)), ("global", 2, 2, "valid", (7, 9)),
])
def test_pools(kind, size, stride, padding, hw):
    x = _x((3, *hw, 5), 2)
    jnode = jlw.OpNode("p", "pool", ("in",), pool=kind, pool_size=size,
                       pool_stride=stride, padding=padding)
    tnode = tlw.OpNode("p", "pool", ("in",), pool=kind, pool_size=size,
                       pool_stride=stride, padding=padding)
    want = np.asarray(jlw._apply_pool(jnode, jnp.asarray(x)))
    got = tlw._apply_pool(tnode, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if kind == "global":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(16, 16), (7, 9), (1, 1)])
def test_global_pool_is_batch_invariant(hw):
    """An image's mean is the same bits in any batch: the data-parallel
    engine's shards must equal one device's rows."""
    x = torch.from_numpy(_x((5, *hw, 6), 4))
    node = tlw.OpNode("p", "pool", ("in",), pool="global")
    whole = tlw._apply_pool(node, x)
    for lo, hi in ((0, 1), (1, 3), (3, 5)):
        assert torch.equal(tlw._apply_pool(node, x[lo:hi]), whole[lo:hi])


def test_shuffle_bit_equal():
    x = _x((2, 3, 4, 12), 3)
    for groups in (2, 3, 4):
        jnode = jlw.OpNode("s", "shuffle", ("in",), groups=groups)
        tnode = tlw.OpNode("s", "shuffle", ("in",), groups=groups)
        np.testing.assert_array_equal(
            tlw._apply_shuffle(tnode, torch.from_numpy(x)).numpy(),
            np.asarray(jlw._apply_shuffle(jnode, jnp.asarray(x))))


# Between them these three graphs hold every node kind (strided and
# depthwise convs, 'same' max pools, residuals, concat, shuffle, slice);
# resnet_mini and small_cnn run through test_torch_slice*.py.
@pytest.mark.parametrize("name", ["mobilenet_mini", "shufflenet_mini",
                                  "googlenet_mini"])
def test_zoo_walks_agree(name):
    """Exact-matmul walk of a zoo graph against the reference's, and the
    lowered walk against the port's direct (torch conv) forward."""
    jmodel, model = JZOO[name], ZOO[name]
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    x = _x((2, *model.in_hw, model.in_ch), 4)
    # One compiled program (the tolerance covers compiled-vs-eager order).
    want = np.asarray(jax.jit(lambda p, v: jlw.graph_apply(
        p, v, jmodel.graph))(jparams, jnp.asarray(x)))
    got = tlw.graph_apply(params, torch.from_numpy(x), model.graph)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    direct = tlw.direct_forward(params, torch.from_numpy(x), model.graph)
    np.testing.assert_allclose(direct.numpy(), got.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert tlw.infer_shapes(model.graph, model.in_hw) == \
        jlw.infer_shapes(jmodel.graph, model.in_hw)


# The conv operand over a grid of geometries: kernel 1, 3, 7, stride 1 and
# 2, both paddings, odd, even and mixed H and W, 3 and 8 channels.
GEOMETRY = pytest.mark.parametrize(
    "kk,stride,padding,hw,c",
    [(kk, stride, padding, hw, c) for kk in (1, 3, 7) for stride in (1, 2)
     for padding in ("same", "valid") for hw in ((7, 9), (8, 10), (9, 8))
     for c in (3, 8)])


@GEOMETRY
def test_conv_operand_matrix_bit_equal(kk, stride, padding, hw, c):
    x = _x((2, *hw, c), kk + 10 * stride)
    jcols, (oh, ow) = jlw.im2col(jnp.asarray(x), kk, kk, stride, padding)
    op = tlw.ConvOperand(torch.from_numpy(x), kk, kk, stride, padding)
    assert op.out_hw == (oh, ow)
    assert op.shape == (2 * oh * ow, kk * kk * c)
    assert op.kind == ("view" if kk == stride == 1 else "implicit")
    assert op.windows[:3] == (kk, kk, stride) and op.windows[5:] == (oh, ow)
    np.testing.assert_array_equal(op.matrix().numpy(),
                                  np.asarray(jcols).reshape(op.shape))


def _covered(size, k, stride, before, out):
    """Positions of one axis some window covers: t = y + before, covered
    iff t >= 0 and t - stride * min(out - 1, t // stride) < k."""
    return [y for y in range(size)
            if y + before >= 0 and
            y + before - stride * min(out - 1, (y + before) // stride) < k]


@GEOMETRY
@pytest.mark.parametrize("sign", ["mixed", "negative"])
def test_covered_pixels_hold_the_im2col_max(kk, stride, padding, hw, c,
                                            sign):
    x = torch.from_numpy(_x((2, *hw, c), kk + stride))
    if sign == "negative":
        x = -(x.abs() + 0.5)
    op = tlw.ConvOperand(x, kk, kk, stride, padding)
    _, _, _, top, left, oh, ow = op.windows
    picked = []
    for size, before, out in ((hw[0], top, oh), (hw[1], left, ow)):
        want = _covered(size, kk, stride, before, out)
        count, run, period, off = covered_axis(size, kk, stride, before,
                                               out)
        walk = [t // run * period + t % run - off for t in range(count)]
        assert sorted({p for p in walk if 0 <= p < size}) == want
        assert len(walk) == len(set(walk))      # no pixel read twice
        picked.append(want)
    covered = x[:, picked[0]][:, :, picked[1]]
    assert torch.equal(covered.abs().max(), op.matrix().abs().max())


@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("hw,c", [((7, 9), 3), ((8, 10), 8), ((1, 1), 5)])
def test_1x1_stride_1_im2col_shares_storage(padding, hw, c):
    x = torch.from_numpy(_x((2, *hw, c), 5))
    cols, out = tlw.im2col(x, 1, 1, 1, padding)
    assert out == hw
    assert cols.data_ptr() == x.data_ptr()
    assert cols.untyped_storage().data_ptr() == \
        x.untyped_storage().data_ptr()
    op = tlw.ConvOperand(x, 1, 1, 1, padding)
    assert op.kind == "view" and op.matrix().data_ptr() == x.data_ptr()
    assert torch.equal(op.matrix(), x.reshape(-1, c))


def _bench_graph(name: str) -> tlw.OpGraph:
    """A benchmark configuration's node records as an op graph."""
    path = Path(__file__).resolve().parents[1] / "perfbench" / "configs"
    nodes = []
    for r in json.loads((path / f"{name}.json").read_text())["nodes"]:
        k = r.get("kernel", 3)
        nodes.append(tlw.OpNode(
            r["name"], r["op"], tuple(r.get("inputs", ())),
            cout=r.get("cout", 0), kh=k, kw=k, stride=r.get("stride", 1),
            padding=r.get("padding", "same"), relu=r.get("relu", False),
            pool=r.get("pool", "max"), pool_size=r.get("size", 2),
            pool_stride=r.get("stride", 2)))
    return tlw.OpGraph(tuple(nodes))


@pytest.mark.parametrize("name,view,implicit,matrix", [
    ("resnet50-heana4", 30, 23, 1), ("mobilenetv2-heana4", 34, 18, 1),
    ("googlenet-heana4", 37, 20, 1)])
def test_operand_kinds_over_the_benchmark_graphs(name, view, implicit,
                                                 matrix):
    """The walk hands each GEMM a view (1x1, stride 1), an implicit
    operand (any other conv: the windows) or a matrix (the fc), and the
    exact walk on operands equals the walk on im2col matrices."""
    graph = _bench_graph(name)
    params = tlw.init_params(graph, torch.Generator().manual_seed(0),
                             in_hw=32, device="cpu")
    x = torch.from_numpy(_x((1, 32, 32, 3), 6))
    kinds = []

    def mm(a, w, gi, node):
        kinds.append(a.kind if isinstance(a, tlw.ConvOperand) else "matrix")
        assert kinds[-1] == "matrix" or a.shape == tlw.gemm_matrix(a).shape
        return tlw.gemm_matrix(a) @ w

    got = tlw.graph_forward(params, x, graph, mm)[graph.output.name]
    assert [kinds.count(k) for k in ("view", "implicit", "matrix")] == \
        [view, implicit, matrix]
    assert torch.equal(got, tlw.graph_apply(params, x, graph))

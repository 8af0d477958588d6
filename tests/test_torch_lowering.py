"""Port conformance for the lowering's data movement and glue: im2col,
the depthwise block-diagonal operand, pools, shuffle/slice/concat, and
the exact-matmul walk of every zoo network, against the reference on the
same seeded numpy inputs.

Tolerance: bit-equal for pure data movement, max pools and the
window-ordered average pool; the global average pool and the exact
matmuls sum in an order XLA and PyTorch may choose differently (rtol
1e-6 for a mean, 1e-5 through a network of f32 matmuls)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lowering as jlw
from repro.models.zoo_cnn import ZOO as JZOO

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

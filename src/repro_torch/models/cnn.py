"""The paper's CNN workloads as im2col GEMM tables (+ a runnable small CNN).

The paper's simulator consumes convolution layers as GEMMs via the Toeplitz
/ im2col transform (paper §2.1): a conv with C_in input channels, k x k
kernel, C_out filters and H_out x W_out output pixels becomes

    I (C x K) @ W (K x D)   with  C = H_out * W_out,
                                  K = C_in * k * k,
                                  D = C_out.

Depthwise convolutions are grouped GEMMs: ``count`` instances of a
(C, k*k, 1) GEMM.  All four evaluation CNNs (GoogleNet, ResNet50,
MobileNetV2, ShuffleNetV2 — paper §6.2) are generated below from their
published block structures at 224x224 input.

This module is the PyTorch counterpart of ``repro.models.cnn``: the
analytic tables are copied as they are; the runnable side keeps the
lowering hooks the executor needs (``small_cnn_graph``, ``as_graph``,
``lowered_gemms``, ``lowered_apply``).

Runnable lowerings come in two shapes:

  * the general op-graph IR (models.lowering.OpGraph) — stride/padding
    convs, depthwise convs, pooling, residual adds, concats, channel
    shuffles; the paper's four evaluation networks have reduced-scale
    runnable variants built on it in models.zoo_cnn;
  * the legacy flat ``LoweredLayer`` tuple (conv/fc chains), kept as a
    convenience and converted to a graph internally (``as_graph``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.models import lowering as lw
# Re-exported: LayerGemm's home is the lowering IR now (single source of
# truth for analytic tables AND runnable graphs), but every historical
# importer uses models.cnn.LayerGemm.
from repro_torch.models.lowering import LayerGemm, OpGraph  # noqa: F401


def _conv(name, hw, cin, kk, cout, count=1) -> LayerGemm:
    return LayerGemm(name, hw * hw, cin * kk * kk, cout, count)


def _dw(name, hw, ch, kk=3) -> LayerGemm:
    # depthwise: per-channel (C, kk*kk, 1) GEMMs
    return LayerGemm(name, hw * hw, kk * kk, 1, count=ch)


def googlenet() -> List[LayerGemm]:
    L: List[LayerGemm] = [
        _conv("conv1", 112, 3, 7, 64),
        _conv("conv2_reduce", 56, 64, 1, 64),
        _conv("conv2", 56, 64, 3, 192),
    ]
    # (hw, c_in, 1x1, r3, 3x3, r5, 5x5, pool_proj)
    inception = [
        ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
        ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
        ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
        ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
        ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
        ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
        ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
        ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
        ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
    ]
    for tag, hw, cin, b1, r3, b3, r5, b5, pp in inception:
        L += [
            _conv(f"inc{tag}_1x1", hw, cin, 1, b1),
            _conv(f"inc{tag}_3x3r", hw, cin, 1, r3),
            _conv(f"inc{tag}_3x3", hw, r3, 3, b3),
            _conv(f"inc{tag}_5x5r", hw, cin, 1, r5),
            _conv(f"inc{tag}_5x5", hw, r5, 5, b5),
            _conv(f"inc{tag}_pool", hw, cin, 1, pp),
        ]
    L.append(LayerGemm("fc", 1, 1024, 1000))
    return L


def googlenet_layer5() -> LayerGemm:
    """'Layer 5 of GoogleNet' used by the paper's Fig. 1 buffer-access table
    (5th conv layer = the inception-3a 3x3 branch)."""
    return next(l for l in googlenet() if l.name == "inc3a_3x3")


def resnet50() -> List[LayerGemm]:
    L = [_conv("conv1", 112, 3, 7, 64)]
    stages = [  # (hw_out, c_in_first, width, c_out, blocks)
        (56, 64, 64, 256, 3),
        (28, 256, 128, 512, 4),
        (14, 512, 256, 1024, 6),
        (7, 1024, 512, 2048, 3),
    ]
    for hw, cin_first, wdt, cout, blocks in stages:
        for bi in range(blocks):
            cin = cin_first if bi == 0 else cout
            tag = f"s{hw}b{bi}"
            L += [
                _conv(f"{tag}_1x1a", hw, cin, 1, wdt),
                _conv(f"{tag}_3x3", hw, wdt, 3, wdt),
                _conv(f"{tag}_1x1b", hw, wdt, 1, cout),
            ]
            if bi == 0:
                L.append(_conv(f"{tag}_ds", hw, cin, 1, cout))
    L.append(LayerGemm("fc", 1, 2048, 1000))
    return L


def mobilenet_v2() -> List[LayerGemm]:
    L = [_conv("conv1", 112, 3, 3, 32)]
    # (expansion t, c_out, repeats n, hw_out_of_first_block)
    cfg = [(1, 16, 1, 112), (6, 24, 2, 56), (6, 32, 3, 28), (6, 64, 4, 14),
           (6, 96, 3, 14), (6, 160, 3, 7), (6, 320, 1, 7)]
    cin, hw_in = 32, 112
    for t, cout, n, hw_out in cfg:
        for bi in range(n):
            hw = hw_out if bi == 0 else hw_out
            hidden = cin * t
            tag = f"mb{cout}_{bi}"
            if t > 1:
                L.append(_conv(f"{tag}_expand", hw_in if bi == 0 else hw,
                               cin, 1, hidden))
            L.append(_dw(f"{tag}_dw", hw, hidden))
            L.append(_conv(f"{tag}_project", hw, hidden, 1, cout))
            cin, hw_in = cout, hw
    L.append(_conv("conv_last", 7, 320, 1, 1280))
    L.append(LayerGemm("fc", 1, 1280, 1000))
    return L


def shufflenet_v2() -> List[LayerGemm]:
    L = [_conv("conv1", 112, 3, 3, 24)]
    stages = [  # (hw_out, c_in, c_branch, blocks)
        (28, 24, 58, 4),
        (14, 116, 116, 8),
        (7, 232, 232, 4),
    ]
    for hw, cin, cb, blocks in stages:
        hw_in = hw * 2
        # stride-2 block: two branches
        L += [
            _dw(f"sh{hw}s2_b1dw", hw, cin),
            _conv(f"sh{hw}s2_b1pw", hw, cin, 1, cb),
            _conv(f"sh{hw}s2_b2pw1", hw_in, cin, 1, cb),
            _dw(f"sh{hw}s2_b2dw", hw, cb),
            _conv(f"sh{hw}s2_b2pw2", hw, cb, 1, cb),
        ]
        for bi in range(1, blocks):
            L += [
                _conv(f"sh{hw}b{bi}_pw1", hw, cb, 1, cb),
                _dw(f"sh{hw}b{bi}_dw", hw, cb),
                _conv(f"sh{hw}b{bi}_pw2", hw, cb, 1, cb),
            ]
    L.append(_conv("conv5", 7, 464, 1, 1024))
    L.append(LayerGemm("fc", 1, 1024, 1000))
    return L


CNN_ZOO: Dict[str, Callable[[], List[LayerGemm]]] = {
    "googlenet": googlenet,
    "resnet50": resnet50,
    "mobilenet_v2": mobilenet_v2,
    "shufflenet_v2": shufflenet_v2,
}


def total_macs(layers: List[LayerGemm]) -> int:
    return sum(l.macs for l in layers)


# ---------------------------------------------------------------------------
# GEMM lowering hooks (consumed by repro_torch.exec — the execution engine)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LoweredLayer:
    """One GEMM-lowered layer of a *runnable* CNN.

    ``name`` doubles as the params-dict key holding the (K, D) weight
    matrix.  ``kind`` selects the input transform: 'conv' applies the
    kk x kk im2col (SAME padding, stride 1) before the GEMM; 'fc' flattens
    the feature map into a single row per image.  ``relu``/``pool_after``
    describe the digital post-GEMM stages (activation unit / pooling unit
    in the accelerator's tile, Fig. 10).
    """
    name: str
    kind: str                 # 'conv' | 'fc'
    relu: bool = True
    pool_after: bool = False  # 2x2 max pool, stride 2
    kk: int = 3


def small_cnn_lowering() -> tuple:
    """The GEMM-lowering of the reference's small CNN, layer by layer.

    The executor's default lowering.  This is the legacy flat form;
    ``small_cnn_graph`` is the same network as op-graph IR.
    """
    return (
        LoweredLayer("conv1", "conv", relu=True, pool_after=True),
        LoweredLayer("conv2", "conv", relu=True, pool_after=True),
        LoweredLayer("conv3", "conv", relu=True, pool_after=False),
        LoweredLayer("fc", "fc", relu=False, pool_after=False),
    )


def small_cnn_graph(num_classes: int = 10, in_ch: int = 3) -> OpGraph:
    """The small CNN as op-graph IR (identical numerics to the legacy
    flat lowering: conv-relu-pool, conv-relu-pool, conv-relu, fc)."""
    return OpGraph((
        lw.input_node(in_ch),
        lw.conv("conv1", "input", 16),
        lw.pool("conv1.pool", "conv1"),
        lw.conv("conv2", "conv1.pool", 32),
        lw.pool("conv2.pool", "conv2"),
        lw.conv("conv3", "conv2.pool", 32),
        lw.fc("fc", "conv3", num_classes),
    ))


def _spatial_dims(in_hw) -> tuple:
    """Normalize a spatial-size spec: int -> square, (H, W) -> as given.

    Delegates to lowering.spatial_dims, which validates the spec
    explicitly (length, positivity) instead of failing downstream."""
    return lw.spatial_dims(in_hw)


def graph_from_layers(layers, channels: Dict[str, int],
                      in_ch: int) -> OpGraph:
    """Convert a legacy flat LoweredLayer tuple into the op-graph IR.

    ``channels`` maps layer name -> output channels (read off weights or
    a plan — the flat form never carried them).  pool_after becomes an
    explicit 2x2/2 max-pool node named ``<layer>.pool``.
    """
    nodes = [lw.input_node(in_ch)]
    prev = "input"
    for lyr in layers:
        d = channels[lyr.name]
        if lyr.kind == "conv":
            nodes.append(lw.conv(lyr.name, prev, d, kk=lyr.kk,
                                 relu=lyr.relu))
        elif lyr.kind == "fc":
            nodes.append(lw.fc(lyr.name, prev, d, relu=lyr.relu))
        else:
            raise ValueError(f"unknown lowered-layer kind: {lyr.kind!r}")
        prev = lyr.name
        if lyr.pool_after:
            nodes.append(lw.pool(f"{lyr.name}.pool", prev))
            prev = f"{lyr.name}.pool"
    return OpGraph(tuple(nodes))


def as_graph(lowering, params: Optional[dict] = None,
             plan=None) -> OpGraph:
    """Normalize any runnable lowering to the op-graph IR.

    OpGraphs pass through; legacy flat tuples need channel counts, read
    from ``params`` weight shapes (preferred) or a CnnPlan's per-layer
    ``d`` — the executor's compiled wrapper has a plan but no params.
    """
    if isinstance(lowering, OpGraph):
        return lowering
    layers = tuple(lowering)
    if params is not None:
        channels = {l.name: int(params[l.name].shape[1]) for l in layers}
    elif plan is not None:
        channels = {l.name: p.d for l, p in zip(layers, plan.layers)}
    else:
        raise ValueError("converting a legacy flat lowering needs params "
                         "or a plan to recover channel counts")
    first = layers[0]
    if first.kind != "conv":
        raise ValueError(
            f"legacy flat lowerings must start with a conv layer to "
            f"recover C_in (got {first.kind!r}) — build an OpGraph with "
            f"an explicit input node instead")
    if params is not None:
        in_ch = int(params[first.name].shape[0]) // (first.kk * first.kk)
    else:
        in_ch = next(p.k for p in plan.layers) // (first.kk * first.kk)
    return graph_from_layers(layers, channels, in_ch)


def lowered_gemms(params: dict, lowering=None, in_hw=16) -> List[LayerGemm]:
    """Analytic GEMM table (for the scheduler) of a lowered runnable CNN.

    Walks the lowering (op-graph or legacy flat tuple), tracking spatial
    size through strides and pools, validating every weight shape against
    the graph — the same (C, K, D) the executor will feed the kernel, so
    plans and execution agree.

    ``in_hw`` is the input spatial size: an int for square images or an
    (H, W) pair for rectangular ones (conv rows become H_out*W_out).
    """
    graph = as_graph(lowering or small_cnn_lowering(), params=params)
    return lw.graph_gemms(graph, in_hw, params=params)


def lowered_apply(params: dict, x, lowering=None,
                  matmul: Optional[Callable] = None):
    """Forward pass of ANY lowered runnable CNN, driven by its lowering.

    The single source of truth for what a lowering computes — op-graph
    IR or legacy flat tuple: the executor (repro_torch.exec.executor) replays
    exactly this structure through the TAOM kernel, and the
    bit-exactness oracle (exec.executor.reference_forward) calls this
    with the *same* lowering the executor ran — so the contract covers
    every lowered network (stride/depthwise/residual/pool included), not
    just the small CNN.

    ``matmul(a, w)`` defaults to exact and can be the photonic simulation
    (ops.photonic_matmul partial).  Rectangular images are first-class.
    """
    graph = as_graph(lowering or small_cnn_lowering(), params=params)
    return lw.graph_apply(params, x, graph, matmul)

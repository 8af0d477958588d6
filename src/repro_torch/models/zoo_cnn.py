"""Executable paper model zoo (PyTorch counterpart of
``repro.models.zoo_cnn``; the graphs are data and are copied as they
are): reduced-scale runnable variants of the four evaluation CNNs (paper
§6.2 — GoogleNet, ResNet50, MobileNetV2, ShuffleNet-V2) on the lowering
IR (models.lowering).

Each variant keeps its network's *structural signature* — the thing the
full-size analytic tables in models.cnn model — at a small scale:

  * resnet_mini      bottleneck residual blocks (1x1 -> 3x3 -> 1x1 with
                     projection/identity shortcuts, one stride-2 stage)
  * mobilenet_mini   inverted residuals: 1x1 expand -> depthwise 3x3
                     (stride 1 and 2) -> linear 1x1 project, residual
                     only at stride 1 with matching channels
  * shufflenet_mini  stride-2 two-branch unit + split/concat basic unit
                     with channel shuffle
  * googlenet_mini   inception branch+concat (1x1 / 3x3 / 5x5 / pooled
                     projection)
  * small_cnn        the original runnable toy net, as a graph

Every ``ZooModel`` carries both views of the network from ONE graph:
``gemms()`` (what the scheduler/executor consume) and ``analytic()``
(the same layers written with the paper-table helpers ``_conv``/``_dw``
that generate models.cnn.CNN_ZOO and feed benchmarks/fig11_fps.py).
The reference's tests/test_zoo_conformance.py pins the two against each
other layer by layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.models import lowering as lw
from repro_torch.models.cnn import LayerGemm, _conv, _dw, small_cnn_graph
from repro_torch.models.lowering import (OpGraph, concat, conv, dwconv, fc,
                                   global_avg, input_node, pool, residual,
                                   shuffle, slice_ch)


@dataclasses.dataclass(frozen=True)
class ZooModel:
    """One runnable zoo network: graph + input geometry + analytic view."""
    name: str
    graph: OpGraph
    in_hw: Tuple[int, int]
    num_classes: int
    _analytic: Callable[[], List[LayerGemm]]

    @property
    def in_ch(self) -> int:
        return self.graph.input.cout

    def init_params(self, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
        """Seeded weights (from a CPU ``generator``) on ``device`` — the
        CUDA card unless the caller names another device."""
        return lw.init_params(self.graph, generator, self.in_hw,
                              device=device)

    def gemms(self, params: dict = None) -> List[LayerGemm]:
        """The executor/scheduler GEMM table, straight off the graph."""
        return lw.graph_gemms(self.graph, self.in_hw, params=params)

    def analytic(self) -> List[LayerGemm]:
        """The same network written with the paper-table formulas
        (models.cnn._conv/_dw) — the fig11-style accounting."""
        return self._analytic()


def _resnet_mini() -> ZooModel:
    """Three ResNet50-style bottleneck blocks at 32x32: projection
    shortcut, stride-2 downsample block, identity block."""
    g = OpGraph((
        input_node(3),
        conv("stem", "input", 16),
        # block 1: projection shortcut (16 -> 32 channels), stride 1
        conv("b1_1x1a", "stem", 8, kk=1),
        conv("b1_3x3", "b1_1x1a", 8),
        conv("b1_1x1b", "b1_3x3", 32, kk=1, relu=False),
        conv("b1_ds", "stem", 32, kk=1, relu=False),
        residual("b1_add", "b1_1x1b", "b1_ds"),
        # block 2: stride-2 downsample (32x32 -> 16x16, 32 -> 64 ch)
        conv("b2_1x1a", "b1_add", 16, kk=1),
        conv("b2_3x3", "b2_1x1a", 16, stride=2),
        conv("b2_1x1b", "b2_3x3", 64, kk=1, relu=False),
        conv("b2_ds", "b1_add", 64, kk=1, stride=2, relu=False),
        residual("b2_add", "b2_1x1b", "b2_ds"),
        # block 3: identity shortcut
        conv("b3_1x1a", "b2_add", 16, kk=1),
        conv("b3_3x3", "b3_1x1a", 16),
        conv("b3_1x1b", "b3_3x3", 64, kk=1, relu=False),
        residual("b3_add", "b3_1x1b", "b2_add"),
        global_avg("gap", "b3_add"),
        fc("fc", "gap", 10),
    ))

    def analytic() -> List[LayerGemm]:
        return [
            _conv("stem", 32, 3, 3, 16),
            _conv("b1_1x1a", 32, 16, 1, 8),
            _conv("b1_3x3", 32, 8, 3, 8),
            _conv("b1_1x1b", 32, 8, 1, 32),
            _conv("b1_ds", 32, 16, 1, 32),
            _conv("b2_1x1a", 32, 32, 1, 16),
            _conv("b2_3x3", 16, 16, 3, 16),
            _conv("b2_1x1b", 16, 16, 1, 64),
            _conv("b2_ds", 16, 32, 1, 64),
            _conv("b3_1x1a", 16, 64, 1, 16),
            _conv("b3_3x3", 16, 16, 3, 16),
            _conv("b3_1x1b", 16, 16, 1, 64),
            LayerGemm("fc", 1, 64, 10),
        ]

    return ZooModel("resnet_mini", g, (32, 32), 10, analytic)


def _mobilenet_mini() -> ZooModel:
    """MobileNetV2-style inverted residuals at 32x32: t=1 first block,
    t=6 stride-2 block, t=6 residual block (linear bottlenecks — no
    activation after the projection, residual add without ReLU)."""
    g = OpGraph((
        input_node(3),
        conv("stem", "input", 8, stride=2),
        # t=1 block: depthwise + linear project (8 -> 16 ch)
        dwconv("ir1_dw", "stem", relu=True),
        conv("ir1_pw", "ir1_dw", 16, kk=1, relu=False),
        # t=6 stride-2 block (16 -> 24 ch, 16x16 -> 8x8)
        conv("ir2_ex", "ir1_pw", 96, kk=1),
        dwconv("ir2_dw", "ir2_ex", stride=2, relu=True),
        conv("ir2_pw", "ir2_dw", 24, kk=1, relu=False),
        # t=6 residual block (24 -> 24 ch, stride 1: shortcut applies)
        conv("ir3_ex", "ir2_pw", 144, kk=1),
        dwconv("ir3_dw", "ir3_ex", relu=True),
        conv("ir3_pw", "ir3_dw", 24, kk=1, relu=False),
        residual("ir3_add", "ir3_pw", "ir2_pw", relu=False),
        conv("head", "ir3_add", 64, kk=1),
        global_avg("gap", "head"),
        fc("fc", "gap", 10),
    ))

    def analytic() -> List[LayerGemm]:
        return [
            _conv("stem", 16, 3, 3, 8),
            _dw("ir1_dw", 16, 8),
            _conv("ir1_pw", 16, 8, 1, 16),
            _conv("ir2_ex", 16, 16, 1, 96),
            _dw("ir2_dw", 8, 96),
            _conv("ir2_pw", 8, 96, 1, 24),
            _conv("ir3_ex", 8, 24, 1, 144),
            _dw("ir3_dw", 8, 144),
            _conv("ir3_pw", 8, 144, 1, 24),
            _conv("head", 8, 24, 1, 64),
            LayerGemm("fc", 1, 64, 10),
        ]

    return ZooModel("mobilenet_mini", g, (32, 32), 10, analytic)


def _shufflenet_mini() -> ZooModel:
    """ShuffleNet-V2 units at 32x32: the stride-2 two-branch unit
    (both branches concat to 2x channels) and the basic unit (channel
    split, one branch transformed, concat) — each followed by the
    channel shuffle."""
    g = OpGraph((
        input_node(3),
        conv("stem", "input", 16),
        # stride-2 unit: branch 1 = dw/s2 + pw, branch 2 = pw + dw/s2 + pw
        dwconv("d1_b1dw", "stem", stride=2),
        conv("d1_b1pw", "d1_b1dw", 16, kk=1),
        conv("d1_b2pw1", "stem", 16, kk=1),
        dwconv("d1_b2dw", "d1_b2pw1", stride=2),
        conv("d1_b2pw2", "d1_b2dw", 16, kk=1),
        concat("d1_cat", "d1_b1pw", "d1_b2pw2"),
        shuffle("d1_shuf", "d1_cat", groups=2),
        # basic unit: split 32 -> 16 + 16, transform one branch
        slice_ch("u1_keep", "d1_shuf", 0, 16),
        slice_ch("u1_in", "d1_shuf", 16, 32),
        conv("u1_pw1", "u1_in", 16, kk=1),
        dwconv("u1_dw", "u1_pw1"),
        conv("u1_pw2", "u1_dw", 16, kk=1),
        concat("u1_cat", "u1_keep", "u1_pw2"),
        shuffle("u1_shuf", "u1_cat", groups=2),
        global_avg("gap", "u1_shuf"),
        fc("fc", "gap", 10),
    ))

    def analytic() -> List[LayerGemm]:
        return [
            _conv("stem", 32, 3, 3, 16),
            _dw("d1_b1dw", 16, 16),
            _conv("d1_b1pw", 16, 16, 1, 16),
            _conv("d1_b2pw1", 32, 16, 1, 16),
            _dw("d1_b2dw", 16, 16),
            _conv("d1_b2pw2", 16, 16, 1, 16),
            _conv("u1_pw1", 16, 16, 1, 16),
            _dw("u1_dw", 16, 16),
            _conv("u1_pw2", 16, 16, 1, 16),
            LayerGemm("fc", 1, 32, 10),
        ]

    return ZooModel("shufflenet_mini", g, (32, 32), 10, analytic)


def _googlenet_mini() -> ZooModel:
    """A GoogleNet inception module at 32x32: four branches (1x1,
    1x1->3x3, 1x1->5x5, 3x3-maxpool->1x1) concatenated."""
    g = OpGraph((
        input_node(3),
        conv("stem", "input", 16),
        pool("stem.pool", "stem"),
        conv("i_1x1", "stem.pool", 8, kk=1),
        conv("i_3r", "stem.pool", 8, kk=1),
        conv("i_3", "i_3r", 16),
        conv("i_5r", "stem.pool", 4, kk=1),
        conv("i_5", "i_5r", 8, kk=5),
        pool("i_pool", "stem.pool", size=3, stride=1, padding="same"),
        conv("i_pp", "i_pool", 8, kk=1),
        concat("i_cat", "i_1x1", "i_3", "i_5", "i_pp"),
        global_avg("gap", "i_cat"),
        fc("fc", "gap", 10),
    ))

    def analytic() -> List[LayerGemm]:
        return [
            _conv("stem", 32, 3, 3, 16),
            _conv("i_1x1", 16, 16, 1, 8),
            _conv("i_3r", 16, 16, 1, 8),
            _conv("i_3", 16, 8, 3, 16),
            _conv("i_5r", 16, 16, 1, 4),
            _conv("i_5", 16, 4, 5, 8),
            _conv("i_pp", 16, 16, 1, 8),
            LayerGemm("fc", 1, 40, 10),
        ]

    return ZooModel("googlenet_mini", g, (32, 32), 10, analytic)


def _small_cnn() -> ZooModel:
    g = small_cnn_graph()

    def analytic() -> List[LayerGemm]:
        return [
            _conv("conv1", 16, 3, 3, 16),
            _conv("conv2", 8, 16, 3, 32),
            _conv("conv3", 4, 32, 3, 32),
            LayerGemm("fc", 1, 512, 10),
        ]

    return ZooModel("small_cnn", g, (16, 16), 10, analytic)


ZOO: Dict[str, ZooModel] = {m.name: m for m in (
    _resnet_mini(), _mobilenet_mini(), _shufflenet_mini(),
    _googlenet_mini(), _small_cnn())}

#: The four paper evaluation networks (Fig. 11 / Table 4) only.
PAPER_ZOO: Dict[str, ZooModel] = {
    k: v for k, v in ZOO.items() if k != "small_cnn"}

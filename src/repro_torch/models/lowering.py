"""General CNN lowering IR: op graphs lowered to im2col GEMMs + glue.

PyTorch counterpart of ``repro.models.lowering``.  HEANA consumes
convolution networks as GEMMs via the Toeplitz/im2col transform (paper
§2.1); everything *between* the GEMMs — pooling, residual adds, branch
concats, channel shuffles — is cheap digital glue handled by the
accelerator tile's post-GEMM units (Fig. 10).  The IR (``OpNode``,
``OpGraph``, shape inference, ``graph_gemms``) is the reference's, copied
as it is, so both packages plan the same GEMMs; the walkers run on torch
tensors in the reference's NHWC layout:

  * ``graph_forward`` — the executor's walk (each GEMM through a callback,
    a conv's operand handed over as a ``ConvOperand``: the NHWC input and
    the windows' geometry, whose ``matrix()`` is the im2col matrix);
  * ``graph_apply`` — the same walk with a plain matmul;
  * ``direct_forward`` — a reference that does not lower to GEMMs (torch
    convolutions), pinning the lowering itself.

Node kinds:

  ``input``           the graph input (carries C_in in ``cout``)
  ``conv``            kh x kw conv, stride/padding, -> im2col GEMM
                      with K = kh*kw*C_in, D = cout
  ``depthwise_conv``  per-channel kh x kw conv -> ONE block-diagonal
                      GEMM (K = kh*kw*C, D = C); accounted analytically
                      as ``count=C`` grouped (kh*kw, 1) GEMMs
  ``pool``            max / avg / global — glue, no GEMM
  ``residual_add``    elementwise sum of two same-shape producers
  ``concat``          channel concat of >= 2 producers
  ``shuffle``         ShuffleNet channel shuffle (``groups``)
  ``slice``           channel slice [c_lo, c_hi) (ShuffleNet split)
  ``fc``              flatten -> (K, D) GEMM
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Generator, List, Mapping, Optional,
                    Tuple)

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.types import resolve_device

GEMM_OPS = ("conv", "depthwise_conv", "fc")
GLUE_OPS = ("pool", "residual_add", "concat", "shuffle", "slice")
OPS = ("input",) + GEMM_OPS + GLUE_OPS
POOL_KINDS = ("max", "avg", "global")
PADDINGS = ("same", "valid")

#: Glue nodes that the graph walk (``graph_steps``) applied, by kind; the
#: global mean counts under ``"pool"``.  Like ``taom_gemm.OPERAND_LAUNCHES``
#: it counts walks, not forwards: a CUDA graph captures the walk and a
#: replay runs none of its Python, so a graphed forward counts at its
#: capture and adds nothing when it is replayed.
GLUE_CALLS = dict.fromkeys(GLUE_OPS, 0)


# ---------------------------------------------------------------------------
# Analytic GEMM record (the scheduler/perf-model currency)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LayerGemm:
    """One layer as an im2col GEMM: I (C x K) @ W (K x D), ``count``
    parallel instances (depthwise groups)."""
    name: str
    c: int      # output pixels (rows of I)
    k: int      # C_in * kh * kw (contraction)
    d: int      # output channels
    count: int = 1   # parallel instances (e.g. depthwise groups)

    @property
    def macs(self) -> int:
        return self.c * self.k * self.d * self.count

    @property
    def executed(self) -> Tuple[int, int, int]:
        """The (M, K, D) of the ONE GEMM the executor actually runs.

        This is the single home of the fusion convention: depthwise
        layers (count > 1, d == 1 — what graph_gemms emits for
        ``depthwise_conv`` nodes) are executed as one block-diagonal
        GEMM (depthwise_block_diag), so K and D scale by count; every
        other layer executes its analytic shape as-is.  The scheduler
        sizes kernel tiles and the executor reports traces against
        THESE dims — do not re-derive the convention elsewhere.
        """
        if self.count > 1 and self.d == 1:
            return (self.c, self.k * self.count, self.count)
        return (self.c, self.k, self.d)


@dataclasses.dataclass(frozen=True)
class OpNode:
    """One node of a lowered CNN graph.  Only the fields relevant to
    ``op`` are read; the rest keep their defaults (the builder helpers
    below construct well-formed nodes)."""
    name: str
    op: str
    inputs: Tuple[str, ...] = ()
    cout: int = 0          # conv/fc output channels; input: C_in
    kh: int = 3            # conv/depthwise kernel size
    kw: int = 3
    stride: int = 1        # conv/depthwise stride
    padding: str = "same"  # conv/depthwise/pool: 'same' | 'valid'
    relu: bool = False     # ReLU after the op (post-GEMM activation unit)
    pool: str = "max"      # pool kind: 'max' | 'avg' | 'global'
    pool_size: int = 2
    pool_stride: int = 2
    groups: int = 2        # shuffle groups
    c_lo: int = 0          # slice channel range [c_lo, c_hi)
    c_hi: int = 0


@dataclasses.dataclass(frozen=True)
class OpGraph:
    """Topologically-ordered node tuple; the last node is the output.

    Validated at construction: unique names, known ops, every input
    referencing an EARLIER node, per-op arity.  Hashable by value (all
    fields are frozen/hashable).
    """
    nodes: Tuple[OpNode, ...]

    def __post_init__(self):
        object.__setattr__(self, "nodes", tuple(self.nodes))
        if not self.nodes:
            raise ValueError("OpGraph needs at least one node")
        seen = set()
        for i, n in enumerate(self.nodes):
            if n.op not in OPS:
                raise ValueError(f"{n.name}: unknown op {n.op!r} "
                                 f"(known: {OPS})")
            if n.name in seen:
                raise ValueError(f"duplicate node name {n.name!r}")
            seen.add(n.name)
            if n.op == "input":
                if i != 0:
                    raise ValueError(
                        f"{n.name}: 'input' must be the first node")
                if n.inputs:
                    raise ValueError(f"{n.name}: 'input' takes no inputs")
                if n.cout < 1:
                    raise ValueError(
                        f"{n.name}: input node carries C_in in cout, "
                        f"got {n.cout}")
                continue
            want = (2 if n.op == "residual_add"
                    else None if n.op == "concat" else 1)
            if want is not None and len(n.inputs) != want:
                raise ValueError(
                    f"{n.name}: op {n.op!r} takes {want} input(s), "
                    f"got {len(n.inputs)}")
            if n.op == "concat" and len(n.inputs) < 2:
                raise ValueError(f"{n.name}: concat needs >= 2 inputs")
            for src in n.inputs:
                if src not in seen:
                    raise ValueError(
                        f"{n.name}: input {src!r} is not an earlier node "
                        f"(graphs are topologically ordered)")
            if n.op in ("conv", "depthwise_conv"):
                if n.kh < 1 or n.kw < 1 or n.stride < 1:
                    raise ValueError(
                        f"{n.name}: kernel {n.kh}x{n.kw} stride {n.stride} "
                        f"must all be >= 1")
                if n.padding not in PADDINGS:
                    raise ValueError(f"{n.name}: padding {n.padding!r} "
                                     f"not in {PADDINGS}")
            if n.op == "conv" and n.cout < 1:
                raise ValueError(f"{n.name}: conv needs cout >= 1")
            if n.op == "fc" and n.cout < 1:
                raise ValueError(f"{n.name}: fc needs cout >= 1")
            if n.op == "pool":
                if n.pool not in POOL_KINDS:
                    raise ValueError(f"{n.name}: pool kind {n.pool!r} "
                                     f"not in {POOL_KINDS}")
                if n.pool != "global" and (n.pool_size < 1
                                          or n.pool_stride < 1):
                    raise ValueError(
                        f"{n.name}: pool_size/pool_stride must be >= 1")
                if n.pool == "avg" and n.padding == "same" \
                        and n.pool_size > 1:
                    raise ValueError(
                        f"{n.name}: 'same'-padded avg pool is ambiguous "
                        f"(padding in the divisor) — use 'valid' or max")
            if n.op == "slice" and not 0 <= n.c_lo < n.c_hi:
                raise ValueError(
                    f"{n.name}: slice needs 0 <= c_lo < c_hi, got "
                    f"[{n.c_lo}, {n.c_hi})")
            if n.op == "shuffle" and n.groups < 1:
                raise ValueError(f"{n.name}: shuffle groups must be >= 1")

    @property
    def input(self) -> OpNode:
        return self.nodes[0]

    @property
    def output(self) -> OpNode:
        return self.nodes[-1]

    @property
    def gemm_nodes(self) -> Tuple[OpNode, ...]:
        return tuple(n for n in self.nodes if n.op in GEMM_OPS)

    def node(self, name: str) -> OpNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Builder helpers (terse, well-formed nodes)
# ---------------------------------------------------------------------------
def input_node(cin: int, name: str = "input") -> OpNode:
    return OpNode(name, "input", cout=cin)


def conv(name, src, cout, kk=3, stride=1, relu=True,
         padding="same") -> OpNode:
    return OpNode(name, "conv", (src,), cout=cout, kh=kk, kw=kk,
                  stride=stride, relu=relu, padding=padding)


def dwconv(name, src, kk=3, stride=1, relu=False,
           padding="same") -> OpNode:
    return OpNode(name, "depthwise_conv", (src,), kh=kk, kw=kk,
                  stride=stride, relu=relu, padding=padding)


def pool(name, src, kind="max", size=2, stride=2,
         padding="valid") -> OpNode:
    return OpNode(name, "pool", (src,), pool=kind, pool_size=size,
                  pool_stride=stride, padding=padding)


def global_avg(name, src) -> OpNode:
    return OpNode(name, "pool", (src,), pool="global")


def residual(name, a, b, relu=True) -> OpNode:
    return OpNode(name, "residual_add", (a, b), relu=relu)


def concat(name, *srcs) -> OpNode:
    return OpNode(name, "concat", tuple(srcs))


def shuffle(name, src, groups=2) -> OpNode:
    return OpNode(name, "shuffle", (src,), groups=groups)


def slice_ch(name, src, lo, hi) -> OpNode:
    return OpNode(name, "slice", (src,), c_lo=lo, c_hi=hi)


def fc(name, src, cout, relu=False) -> OpNode:
    return OpNode(name, "fc", (src,), cout=cout, relu=relu)


# ---------------------------------------------------------------------------
# Spatial arithmetic + shape inference
# ---------------------------------------------------------------------------
def spatial_dims(in_hw) -> Tuple[int, int]:
    """Normalize a spatial-size spec: int -> square, (H, W) -> as given.

    Validates explicitly — a bad spec used to surface as reshape noise
    deep inside the walk."""
    if isinstance(in_hw, (tuple, list)):
        if len(in_hw) != 2:
            raise ValueError(
                f"in_hw must be an int or an (H, W) pair, got "
                f"{tuple(in_hw)!r}")
        h, w = int(in_hw[0]), int(in_hw[1])
    else:
        h = w = int(in_hw)
    if h < 1 or w < 1:
        raise ValueError(f"in_hw must be positive, got {h}x{w}")
    return h, w


def conv_out_dim(size: int, k: int, stride: int, padding: str) -> int:
    """Output extent of one spatial axis (TF/XLA SAME/VALID semantics)."""
    if padding == "same":
        return -(-size // stride)
    if size < k:
        raise ValueError(
            f"'valid' window k={k} does not fit in extent {size} — pad "
            f"the input or use padding='same'")
    return (size - k) // stride + 1


def _pool_out(node: OpNode, h: int, w: int) -> Tuple[int, int]:
    if node.pool == "global":
        return 1, 1
    s, st = node.pool_size, node.pool_stride
    if node.padding == "same":
        return -(-h // st), -(-w // st)
    for dim, tag in ((h, "H"), (w, "W")):
        if dim < s or (dim - s) % st:
            raise ValueError(
                f"{node.name}: 'valid' {s}x{s}/{st} pool does not tile "
                f"{tag}={dim} (needs {tag} >= {s} and ({tag} - {s}) "
                f"divisible by {st}) — odd/indivisible dims must be "
                f"handled explicitly: use padding='same', a global pool, "
                f"or resize the input")
    return (h - s) // st + 1, (w - s) // st + 1


def infer_shapes(graph: OpGraph, in_hw,
                 params: Optional[dict] = None
                 ) -> Dict[str, Tuple[int, int, int]]:
    """Per-node output shapes (H, W, C) for a given input spatial size.

    Channels come from node attrs (``cout``); when ``params`` is given,
    every GEMM weight shape is validated against the inferred one with a
    clear error.
    """
    h, w = spatial_dims(in_hw)
    shapes: Dict[str, Tuple[int, int, int]] = {}
    for n in graph.nodes:
        if n.op == "input":
            shapes[n.name] = (h, w, n.cout)
            continue
        ih, iw, ic = shapes[n.inputs[0]]
        if n.op in ("conv", "depthwise_conv"):
            oh = conv_out_dim(ih, n.kh, n.stride, n.padding)
            ow = conv_out_dim(iw, n.kw, n.stride, n.padding)
            oc = ic if n.op == "depthwise_conv" else n.cout
            want = ((n.kh * n.kw, ic) if n.op == "depthwise_conv"
                    else (n.kh * n.kw * ic, oc))
            shapes[n.name] = (oh, ow, oc)
        elif n.op == "fc":
            oc = n.cout
            want = (ih * iw * ic, oc)
            shapes[n.name] = (1, 1, oc)
        elif n.op == "pool":
            oh, ow = _pool_out(n, ih, iw)
            shapes[n.name] = (oh, ow, ic)
        elif n.op == "residual_add":
            other = shapes[n.inputs[1]]
            if other != (ih, iw, ic):
                raise ValueError(
                    f"{n.name}: residual_add inputs disagree — "
                    f"{n.inputs[0]} is {(ih, iw, ic)} but {n.inputs[1]} "
                    f"is {other}")
            shapes[n.name] = (ih, iw, ic)
        elif n.op == "concat":
            cs = 0
            for src in n.inputs:
                sh, sw, sc = shapes[src]
                if (sh, sw) != (ih, iw):
                    raise ValueError(
                        f"{n.name}: concat inputs disagree spatially — "
                        f"{n.inputs[0]} is {ih}x{iw} but {src} is "
                        f"{sh}x{sw}")
                cs += sc
            shapes[n.name] = (ih, iw, cs)
        elif n.op == "shuffle":
            if ic % n.groups:
                raise ValueError(
                    f"{n.name}: shuffle groups={n.groups} does not divide "
                    f"C={ic}")
            shapes[n.name] = (ih, iw, ic)
        elif n.op == "slice":
            if n.c_hi > ic:
                raise ValueError(
                    f"{n.name}: slice [{n.c_lo}, {n.c_hi}) exceeds C={ic}")
            shapes[n.name] = (ih, iw, n.c_hi - n.c_lo)
        if n.op in GEMM_OPS and params is not None:
            got = tuple(params[n.name].shape)
            if got != want:
                raise ValueError(
                    f"{n.name}: weight shape {got} but the graph at this "
                    f"node implies {want} (in_hw mismatch, or params from "
                    f"a different graph)")
    return shapes


# ---------------------------------------------------------------------------
# im2col (NHWC, K ordered patch-position-major, channel-minor)
# ---------------------------------------------------------------------------
def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/XLA 'same' padding of one axis: (before, after) with
    before = total // 2."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_hw(x: torch.Tensor, kh: int, kw: int, stride: int,
            value: float = 0.0) -> torch.Tensor:
    """Pad an NHWC tensor's H and W the way 'same' padding does."""
    top, bottom = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def _windows(x: torch.Tensor, kh: int, kw: int, stride: int,
             oh: int, ow: int) -> List[torch.Tensor]:
    """The kh*kw strided window views of a padded NHWC tensor, in
    patch-position order (row-major over the window)."""
    return [x[:, i:i + (oh - 1) * stride + 1:stride,
              j:j + (ow - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "same") -> Tuple[torch.Tensor, Tuple[int, int]]:
    """NHWC -> ((N, OH*OW, kh*kw*C) patches, (OH, OW)).

    K is ordered patch-position-major, channel-minor — the layout
    ``weight_hwio`` expects (``F.unfold`` is channel-major, so it is not
    used).  'same' padding is asymmetric: the smaller half goes before.
    """
    n, h, w, c = x.shape
    oh = conv_out_dim(h, kh, stride, padding)
    ow = conv_out_dim(w, kw, stride, padding)
    if kh == kw == stride == 1:
        # One window with no padding: the patches are x itself (a view of
        # a contiguous x).
        return x.reshape(n, h * w, c), (oh, ow)
    if padding == "same":
        x = _pad_hw(x, kh, kw, stride)
    cols = torch.cat(_windows(x, kh, kw, stride, oh, ow), dim=-1)
    return cols.reshape(n, oh * ow, kh * kw * c), (oh, ow)


@dataclasses.dataclass(frozen=True, eq=False)
class ConvOperand:
    """A conv or depthwise node's GEMM operand before im2col: the NHWC
    input and the windows' geometry.  ``matrix()`` is ``im2col``'s
    (N*OH*OW, kh*kw*C) matrix; the TAOM kernels' fused route reads the
    windows from ``x`` instead (``kernels.ops.photonic_matmul``)."""
    x: torch.Tensor        # (N, H, W, C)
    kh: int
    kw: int
    stride: int
    padding: str

    @property
    def out_hw(self) -> Tuple[int, int]:
        return (conv_out_dim(self.x.shape[1], self.kh, self.stride,
                             self.padding),
                conv_out_dim(self.x.shape[2], self.kw, self.stride,
                             self.padding))

    @property
    def shape(self) -> Tuple[int, int]:
        """The (M, K) of the GEMM."""
        oh, ow = self.out_hw
        return (self.x.shape[0] * oh * ow,
                self.kh * self.kw * self.x.shape[3])

    @property
    def kind(self) -> str:
        """'view' where the matrix is x itself (1x1, stride 1), else
        'implicit'."""
        return "view" if self.kh == self.kw == self.stride == 1 \
            else "implicit"

    @property
    def windows(self) -> Tuple[int, ...]:
        """(kh, kw, stride, pad top, pad left, OH, OW): window (oy, ox)'s
        position (i, j) reads x[:, oy*stride + i - top, ox*stride + j -
        left], zero outside the image."""
        top = left = 0
        if self.padding == "same":
            top = _same_pads(self.x.shape[1], self.kh, self.stride)[0]
            left = _same_pads(self.x.shape[2], self.kw, self.stride)[0]
        return (self.kh, self.kw, self.stride, top, left, *self.out_hw)

    def matrix(self) -> torch.Tensor:
        cols, _ = im2col(self.x, self.kh, self.kw, self.stride,
                         self.padding)
        return cols.reshape(-1, cols.shape[-1])


def gemm_matrix(a) -> torch.Tensor:
    """A GEMM operand of ``graph_steps`` as its 2-D matrix."""
    return a.matrix() if isinstance(a, ConvOperand) else a


def depthwise_block_diag(w: torch.Tensor) -> torch.Tensor:
    """Expand a compact depthwise weight (kh*kw, C) into the block-
    diagonal GEMM operand (kh*kw*C, C) matching im2col's K layout
    (position-major, channel-minor): B[q*C + c, c] = w[q, c]."""
    kkq, c = w.shape
    eye = torch.eye(c, dtype=w.dtype, device=w.device)
    return (w[:, :, None] * eye[None, :, :]).reshape(kkq * c, c)


def weight_hwio(node: OpNode, w: torch.Tensor) -> torch.Tensor:
    """A node's GEMM weight as an HWIO tensor (the reference's layout)."""
    if node.op == "depthwise_conv":
        return w.reshape(node.kh, node.kw, 1, w.shape[-1])
    cin = w.shape[0] // (node.kh * node.kw)
    return w.reshape(node.kh, node.kw, cin, w.shape[-1])


# ---------------------------------------------------------------------------
# Parameters (weight shapes derived from the graph)
# ---------------------------------------------------------------------------
def init_params(graph: OpGraph, generator: torch.Generator, in_hw=32,
                dtype=torch.float32, device=None) -> Dict[str, torch.Tensor]:
    """Glorot-style init of every GEMM node's weight, shapes inferred.

    Draws come from ``generator`` (a CPU generator, so a seed gives the
    same weights on every device) and are then moved to ``device`` — the
    CUDA card unless the caller names another device."""
    device = resolve_device(device)
    shapes = infer_shapes(graph, in_hw)
    params: Dict[str, torch.Tensor] = {}
    for n in graph.gemm_nodes:
        ih, iw, ic = shapes[n.inputs[0]]
        if n.op == "conv":
            shape = (n.kh * n.kw * ic, n.cout)
        elif n.op == "depthwise_conv":
            shape = (n.kh * n.kw, ic)
        else:
            shape = (ih * iw * ic, n.cout)
        w = torch.randn(shape, generator=generator, dtype=dtype)
        params[n.name] = (w / math.sqrt(shape[0])).to(device)
    return params


def params_from_jax(params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """The reference package's params dict (as numpy arrays) as the port's:
    float32 tensors on ``device`` (the CUDA card unless named), same names
    and shapes — so both packages compute the same network."""
    device = resolve_device(device)
    return {name: torch.from_numpy(np.array(v, dtype=np.float32)
                                   ).to(device)
            for name, v in params.items()}


# ---------------------------------------------------------------------------
# Analytic GEMM table (what the scheduler/perf model plan against)
# ---------------------------------------------------------------------------
def graph_gemms(graph: OpGraph, in_hw,
                params: Optional[dict] = None) -> List[LayerGemm]:
    """The graph's GEMM-bearing nodes as paper-convention LayerGemms.

    conv:      (OH*OW, kh*kw*C_in, C_out)
    depthwise: count=C instances of (OH*OW, kh*kw, 1) — the paper's
               grouped accounting (models.cnn._dw); the executor fuses
               them into one block-diagonal GEMM, same MACs modulo the
               structural zeros it streams.
    fc:        (1, H*W*C, D)

    Order matches the executor's walk exactly — schedule_cnn over this
    list yields plans the executor consumes positionally.
    """
    shapes = infer_shapes(graph, in_hw, params=params)
    out: List[LayerGemm] = []
    for n in graph.gemm_nodes:
        ih, iw, ic = shapes[n.inputs[0]]
        oh, ow, oc = shapes[n.name]
        if n.op == "conv":
            out.append(LayerGemm(n.name, oh * ow, n.kh * n.kw * ic, oc))
        elif n.op == "depthwise_conv":
            out.append(LayerGemm(n.name, oh * ow, n.kh * n.kw, 1,
                                 count=ic))
        else:
            out.append(LayerGemm(n.name, 1, ih * iw * ic, oc))
    return out


# ---------------------------------------------------------------------------
# Forward walkers
# ---------------------------------------------------------------------------
def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W: a pairwise tree of elementwise adds over the
    positions, then a true division.  Each image's sum is taken in the
    same order whatever the batch; PyTorch's reductions on the card pick
    their order from the whole tensor's shape, so an image's mean would
    move by an ulp with the batch it is served in (a data-parallel shard
    against one device)."""
    n, h, w, c = x.shape
    t = x.reshape(n, h * w, c)
    while t.shape[1] > 1:
        half = t.shape[1] // 2
        pairs = t[:, :half] + t[:, half:2 * half]
        t = torch.cat([pairs, t[:, 2 * half:]], 1) if t.shape[1] % 2 \
            else pairs
    return t.reshape(n, 1, 1, c) / torch.full((), float(h * w),
                                              dtype=x.dtype, device=x.device)


def _apply_pool(node: OpNode, x: torch.Tensor) -> torch.Tensor:
    if node.pool == "global":
        return _mean_hw(x)
    s, st = node.pool_size, node.pool_stride
    oh, ow = _pool_out(node, x.shape[1], x.shape[2])
    fill = float("-inf") if node.pool == "max" else 0.0
    if node.padding == "same":
        x = _pad_hw(x, s, s, st, value=fill)
    # Explicit window walk from the reduction's init value, in window
    # order (as a reduce_window does), with 'same' pads of -inf for max.
    out = torch.full_like(x[:, :oh, :ow, :], fill)
    for win in _windows(x, s, s, st, oh, ow):
        out = torch.maximum(out, win) if node.pool == "max" else out + win
    if node.pool == "max":
        return out
    # A 0-dim tensor on x's device keeps this a true division on the card
    # (a Python scalar divisor becomes a reciprocal multiply there); made
    # by a fill, not a copy from the host, so that it captures in a CUDA
    # graph.
    return out / torch.full((), float(s * s), dtype=out.dtype,
                            device=out.device)


def _apply_shuffle(node: OpNode, x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    g = node.groups
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


def _apply_glue(node: OpNode, a: torch.Tensor,
                vals: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The non-GEMM ops, shared by both walkers (graph_forward and
    direct_forward)."""
    if node.op == "pool":
        return _apply_pool(node, a)
    if node.op == "residual_add":
        return a + vals[node.inputs[1]]
    if node.op == "concat":
        return torch.cat([vals[s] for s in node.inputs], dim=-1)
    if node.op == "shuffle":
        return _apply_shuffle(node, a)
    if node.op == "slice":
        return a[..., node.c_lo:node.c_hi]
    raise ValueError(f"unknown op {node.op!r}")    # pragma: no cover


def graph_steps(params: dict, x: torch.Tensor, graph: OpGraph
                ) -> Generator[tuple, torch.Tensor, Dict[str, torch.Tensor]]:
    """``graph_forward`` a GEMM at a time: a generator that yields
    ``(operand, weight, gemm_index, node)`` at every GEMM node, takes the
    GEMM's output back by ``send`` and returns every node's output by
    name.  The operand is a ``ConvOperand`` at a conv or depthwise node
    (``gemm_matrix`` makes it the im2col matrix) and the flattened 2-D
    input at an fc node.  The data-parallel executor steps one per shard,
    so that a GEMM can see every shard's operand before any of them
    runs."""
    n = x.shape[0]
    vals: Dict[str, torch.Tensor] = {}
    gi = 0
    for node in graph.nodes:
        if node.op == "input":
            vals[node.name] = x
            continue
        a = vals[node.inputs[0]]
        if node.op in ("conv", "depthwise_conv"):
            wgt = params[node.name]
            w2d = (depthwise_block_diag(wgt)
                   if node.op == "depthwise_conv" else wgt)
            operand = ConvOperand(a, node.kh, node.kw, node.stride,
                                  node.padding)
            out = yield operand, w2d, gi, node
            y = out.reshape(n, *operand.out_hw, w2d.shape[-1])
            gi += 1
        elif node.op == "fc":
            y = yield a.reshape(n, -1), params[node.name], gi, node
            gi += 1
        else:
            y = _apply_glue(node, a, vals)
            GLUE_CALLS[node.op] += 1
        if node.relu:
            y = torch.relu(y)
        vals[node.name] = y
    return vals


def graph_forward(params: dict, x: torch.Tensor, graph: OpGraph,
                  mm: Callable[[torch.Tensor, torch.Tensor, int, OpNode],
                               torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Walk the graph; returns every node's output by name.

    ``mm(operand, weight, gemm_index, node)`` runs one lowered GEMM
    (``graph_steps`` says what the operand is) — the executor plugs the
    photonic kernel + per-layer plan/noise generator in here;
    ``graph_apply`` plugs a plain (or photonic-reference) matmul on the
    im2col matrix.
    """
    steps = graph_steps(params, x, graph)
    try:
        gemm = next(steps)
        while True:
            gemm = steps.send(mm(*gemm))
    except StopIteration as done:
        return done.value


def graph_apply(params: dict, x: torch.Tensor, graph: OpGraph,
                matmul: Optional[Callable] = None) -> torch.Tensor:
    """Forward pass of a lowered graph with a plain ``matmul(a, w)``
    (default exact; pass the photonic simulation for noisy numerics)."""
    base = matmul or (lambda a, w: a @ w)
    vals = graph_forward(params, x, graph,
                         lambda a, w, i, node: base(gemm_matrix(a), w))
    return vals[graph.output.name]


def direct_forward(params: dict, x: torch.Tensor,
                   graph: OpGraph) -> torch.Tensor:
    """Reference forward that does NOT lower to GEMMs: convolutions via
    ``torch.nn.functional.conv2d`` (depthwise via ``groups``), on NHWC
    tensors with the same asymmetric 'same' padding.  On the card, compare
    it with TF32 off (``torch.backends.cudnn.allow_tf32 = False``)."""
    vals: Dict[str, torch.Tensor] = {}
    for node in graph.nodes:
        if node.op == "input":
            vals[node.name] = x
            continue
        a = vals[node.inputs[0]]
        if node.op in ("conv", "depthwise_conv"):
            w = weight_hwio(node, params[node.name]).permute(3, 2, 0, 1)
            if node.padding == "same":
                a = _pad_hw(a, node.kh, node.kw, node.stride)
            y = F.conv2d(a.permute(0, 3, 1, 2), w, stride=node.stride,
                         groups=(a.shape[-1] if node.op == "depthwise_conv"
                                 else 1)).permute(0, 2, 3, 1)
        elif node.op == "fc":
            y = a.reshape(a.shape[0], -1) @ params[node.name]
        else:
            y = _apply_glue(node, a, vals)
        if node.relu:
            y = torch.relu(y)
        vals[node.name] = y
    return vals[graph.output.name]

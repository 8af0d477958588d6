"""Plain PyTorch forward of a configuration's node records with the
photonic GEMM numerics of its operating point (HEANA, noise off).

Written from the configuration alone: it walks the node records, makes
its own patches with ``F.unfold``, and works out every quantize scale and
ADC full scale again.  Each GEMM node:

* quantizes its input rows per tensor and its weight per output column
  to ``bits`` (q = clamp(round(v / s), -qmax, qmax), s = max(|v|max,
  1e-12) * (1 / qmax), qmax = 2^bits - 1);
* sums the integer products.  Under analog carry (HEANA's BPCA) the N
  chunk sums of a row are added before the one ADC read, and with noise
  off every partial sum is an integer below 2^24, so the chunking leaves
  the sum as one dot product gives it;
* reads the sum through the mid-tread ADC over [-fs, fs] with
  ``adc_bits`` bits, fs = qmax^2 sqrt(K) 4/3 for the GEMM's executed K: a
  depthwise layer runs as one block-diagonal GEMM, so its K is
  kernel^2 * channels;
* rescales by the product of the two scales.

The glue: 'same' padding as TF/XLA pads (the smaller half first), max
pools over -inf padding, residual adds, channel concats, ShuffleNet's
channel shuffle (``groups``) and slice (``c_lo`` to ``c_hi``), ReLU, and
the global mean as a
pairwise tree of adds over the positions followed by a true division (the
order in which the served network sums an image, whatever its batch).

``dtype`` is the precision of the activations and of every step above;
the configuration states float32, and ``torch.bfloat16`` makes the
control.  Integer products are exact in float32 as long as K * qmax^2 <
2^24, which ``forward`` checks.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

QUANT_EPS = 1e-12
EXACT_LIMIT = 2 ** 24


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """NHWC ``x`` padded in H and W as 'same' pads a k-window."""
    top, bottom = same_pads(x.shape[1], k, stride)
    left, right = same_pads(x.shape[2], k, stride)
    return F.pad(x, (0, 0, left, right, top, bottom), value=value)


def patches(x: torch.Tensor, k: int, stride: int, padding: str
            ) -> Tuple[torch.Tensor, int, int]:
    """(N * OH * OW, k, k, C) windows of NHWC ``x``, and OH, OW."""
    if padding == "same":
        x = pad_same(x, k, stride)
    n, h, w, c = x.shape
    oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), k, stride=stride)  # N, C*k*k, L
    cols = cols.view(n, c, k * k, oh * ow).permute(0, 3, 2, 1)
    return cols.reshape(n * oh * ow, k * k, c), oh, ow


def quantize(v: torch.Tensor, bits: int, dim=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    qmax = (1 << bits) - 1
    absmax = v.abs().amax() if dim is None else \
        v.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(absmax, min=QUANT_EPS) * (1.0 / qmax)
    return torch.clamp(torch.round(v / scale), -qmax, qmax), scale


def adc(acc: torch.Tensor, k: int, bits: int, adc_bits: int
        ) -> torch.Tensor:
    """The one ADC read of analog carry, at the full scale calibrated for
    a K-long dot product."""
    qmax = float((1 << bits) - 1)
    fs = max(qmax ** 2 * math.sqrt(float(max(k, 1))) * (4.0 / 3.0), 1e-6)
    levels = (1 << adc_bits) - 1
    step = 2.0 * max(fs, 1e-12) / levels
    hi = levels // 2 + levels % 2
    return torch.clamp(torch.round(acc * (1.0 / step)), -hi, hi) * step


def gemm(rows: torch.Tensor, w: torch.Tensor, op: dict) -> torch.Tensor:
    """One photonic GEMM: (M, K) rows @ (K, D) weight."""
    bits = op["bits"]
    k = rows.shape[1]
    if k * ((1 << bits) - 1) ** 2 >= EXACT_LIMIT:
        raise ValueError(f"K {k} at {bits} bits leaves float32's integers")
    xq, sx = quantize(rows, bits)
    wq, sw = quantize(w, bits, dim=0)
    acc = adc(xq @ wq, k, bits, op["adc_bits"])
    return acc * (sx * sw)


def depthwise(win: torch.Tensor, w: torch.Tensor, op: dict) -> torch.Tensor:
    """One depthwise layer: (M, k*k, C) windows, (k*k, C) weight.  The
    port runs it as one block-diagonal GEMM with K = k*k*C; the zeros add
    nothing to a sum but set the ADC's full scale."""
    bits = op["bits"]
    m, kk, c = win.shape
    xq, sx = quantize(win, bits)
    wq, sw = quantize(w, bits, dim=0)
    acc = adc((xq * wq).sum(dim=1), kk * c, bits, op["adc_bits"])
    return acc * (sx * sw)


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W: pairwise adds over the positions, then a true
    division by H * W (a 0-dim tensor divisor)."""
    n, h, w, c = x.shape
    t = x.reshape(n, h * w, c)
    while t.shape[1] > 1:
        half = t.shape[1] // 2
        pairs = t[:, :half] + t[:, half:2 * half]
        t = torch.cat([pairs, t[:, 2 * half:]], 1) if t.shape[1] % 2 \
            else pairs
    return t.reshape(n, 1, 1, c) / torch.full((), float(h * w),
                                              dtype=x.dtype, device=x.device)


def max_pool(x: torch.Tensor, size: int, stride: int,
             padding: str) -> torch.Tensor:
    if padding == "same":
        x = pad_same(x, size, stride, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), size, stride)
    return y.permute(0, 2, 3, 1)


def forward(config: dict, params: Dict[str, torch.Tensor],
            x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Logits (N, classes) of the NHWC batch ``x``, in float32 whatever
    ``dtype`` computed them in.  The batch is one served batch: each GEMM
    quantizes its input with the batch's scale."""
    op = config["operating_point"]
    if op["backend"] != "heana" or op["noise"]:
        raise ValueError("the reference computes HEANA with noise off")
    vals: Dict[str, torch.Tensor] = {}
    for r in config["nodes"]:
        kind = r["op"]
        if kind == "input":
            vals[r["name"]] = x.to(dtype)
            continue
        a = vals[r["inputs"][0]]
        if kind == "conv":
            k, s = r["kernel"], r["stride"]
            win, oh, ow = patches(a, k, s, r["padding"])
            y = gemm(win.reshape(win.shape[0], -1),
                     params[r["name"]].to(dtype), op)
            y = y.reshape(a.shape[0], oh, ow, -1)
        elif kind == "depthwise_conv":
            k, s = r["kernel"], r["stride"]
            win, oh, ow = patches(a, k, s, r["padding"])
            y = depthwise(win, params[r["name"]].to(dtype), op)
            y = y.reshape(a.shape[0], oh, ow, -1)
        elif kind == "fc":
            y = gemm(a.reshape(a.shape[0], -1), params[r["name"]].to(dtype),
                     op)
        elif kind == "pool" and r["pool"] == "global":
            y = mean_hw(a)
        elif kind == "pool" and r["pool"] == "max":
            y = max_pool(a, r["size"], r["stride"], r["padding"])
        elif kind == "residual_add":
            y = a + vals[r["inputs"][1]]
        elif kind == "concat":
            y = torch.cat([vals[i] for i in r["inputs"]], dim=-1)
        elif kind == "shuffle":
            n, h, w, c = a.shape
            g = r["groups"]
            y = a.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(
                n, h, w, c)
        elif kind == "slice":
            y = a[..., r["c_lo"]:r["c_hi"]]
        else:
            raise ValueError(f"{r['name']}: the reference has no {kind!r}")
        if r.get("relu", False):
            y = torch.relu(y)
        vals[r["name"]] = y
    return vals[config["nodes"][-1]["name"]].reshape(x.shape[0], -1).float()


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: the worst logit's distance from
    the reference, as a share of the reference's largest logit."""
    scale = float(want.abs().max())
    return float((got.float() - want).abs().max()) / max(scale, 1e-30)


def forwards(config: dict, params: Dict[str, torch.Tensor],
             batches: Sequence[torch.Tensor], dtype=torch.float32):
    """``forward`` over several served batches, one at a time."""
    with torch.no_grad():
        return [forward(config, params, b, dtype) for b in batches]

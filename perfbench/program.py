"""The system under test, built from a configuration file: the port's
lowering graph, its operating point, the weights and the images.

This is the only module of the harness that imports ``repro_torch``; the
plain reference (``perfbench/reference``) reads the same node records
itself.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from repro_torch.core import hw
from repro_torch.core.types import Dataflow
from repro_torch.exec.serving import ServingEngine
from repro_torch.models import lowering as lw


def graph(config: dict) -> lw.OpGraph:
    """The configuration's node records as the port's op-graph IR."""
    nodes = []
    for r in config["nodes"]:
        k = r.get("kernel", 3)
        nodes.append(lw.OpNode(
            r["name"], r["op"], tuple(r.get("inputs", ())),
            cout=r.get("cout", 0), kh=k, kw=k, stride=r.get("stride", 1),
            padding=r.get("padding", "same"), relu=r.get("relu", False),
            pool=r.get("pool", "max"), pool_size=r.get("size", 2),
            pool_stride=r.get("stride", 2), groups=r.get("groups", 2),
            c_lo=r.get("c_lo", 0), c_hi=r.get("c_hi", 0)))
    return lw.OpGraph(tuple(nodes))


def operating_point(config: dict) -> hw.OperatingPoint:
    """The configuration's operating point, checked field by field against
    what the port derives from it."""
    o = config["operating_point"]
    if o["constructor"] != "equal_area":
        raise ValueError(f"unknown operating-point constructor "
                         f"{o['constructor']!r}")
    op = hw.OperatingPoint.equal_area(
        o["backend"], Dataflow(o["dataflow"]), o["data_rate_gsps"],
        noise_enabled=o["noise"])
    got = {"bits": op.bits, "dpe_size": op.n, "n_dpus": op.n_dpus,
           "adc_bits": op.adc_bits}
    want = {key: o[key] for key in got}
    if got != want:
        raise ValueError(f"the port derives {got} from the operating point, "
                         f"the configuration states {want}")
    return op


def gemms(config: dict, in_hw: int) -> List[lw.LayerGemm]:
    """The network's GEMMs at ``in_hw``, one image (the paper's table)."""
    return lw.graph_gemms(graph(config), in_hw)


def weights(config: dict, in_hw: int, gen: torch.Generator
            ) -> Dict[str, torch.Tensor]:
    """Every GEMM weight, drawn in one call on the generator's device:
    standard normal over one flat buffer, each layer's slice divided by
    sqrt(fan_in), float32."""
    g = graph(config)
    shapes = lw.infer_shapes(g, in_hw)
    want = []
    for n in g.gemm_nodes:
        ih, iw, ic = shapes[n.inputs[0]]
        want.append((n.name, (n.kh * n.kw * ic, n.cout) if n.op == "conv"
                     else (n.kh * n.kw, ic) if n.op == "depthwise_conv"
                     else (ih * iw * ic, n.cout)))
    total = sum(a * b for _, (a, b) in want)
    flat = torch.randn(total, generator=gen, device=gen.device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, (a, b) in want:
        out[name] = flat[at:at + a * b].view(a, b).mul_(1.0 / math.sqrt(a))
        at += a * b
    return out


def images(config: dict, in_hw: int, n: int, gen: torch.Generator
           ) -> torch.Tensor:
    """``n`` standard-normal NHWC float32 images on the generator's
    device, in one call."""
    c = config["input"]["channels"]
    return torch.randn((n, in_hw, in_hw, c), generator=gen,
                       device=gen.device, dtype=torch.float32)


def engine(config: dict, params: Dict[str, torch.Tensor], in_hw: int,
           max_batch: int, device, devices: Sequence = None
           ) -> ServingEngine:
    """The port's serving engine for this configuration: one device, or
    data-parallel over ``devices``."""
    return ServingEngine(params, operating_point(config),
                         lowering=graph(config), in_hw=in_hw,
                         max_batch=max_batch, device=device,
                         data_parallel=devices is not None and
                         len(devices) > 1,
                         devices=devices)

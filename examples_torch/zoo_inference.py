"""Executable model zoo demo: the paper's four evaluation CNNs as
reduced-scale runnable graphs, planned and executed end-to-end (port).

For each network: build params from the graph, auto-schedule dataflows
and tilings, run the compiled path (a CUDA graph over the TAOM kernels on
the card), and verify the output is bit-exact against the plain-version
oracle with zero warm-call recaptures.

``--smoke`` (the zoo-smoke gate) runs one ResNet + one MobileNet variant
and exits non-zero on any conformance violation — the graph execution
path cannot silently rot.

Run:  PYTHONPATH=src python examples_torch/zoo_inference.py [--smoke]
      [--device cpu]
"""
import argparse
import sys

import torch

from repro_torch.core import perf_model as pm
from repro_torch.core.types import (Backend, Dataflow, PhotonicConfig,
                                    resolve_device)
from repro_torch.exec import (PlanCache, execute_cnn, graph_summary,
                              plan_for_network, plan_table,
                              reference_forward, trace_count)
from repro_torch.models.zoo_cnn import PAPER_ZOO

HEANA = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)


def run_model(model, device, batch=2, seed=0, verbose=True) -> bool:
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    params = model.init_params(torch.Generator().manual_seed(seed),
                               device=device)
    x = torch.randn((batch, *model.in_hw, model.in_ch),
                    generator=torch.Generator().manual_seed(seed + 1)
                    ).to(device)
    plan = plan_for_network(params, HEANA, batch=batch, in_hw=model.in_hw,
                            lowering=model.graph, cache=PlanCache())
    res = execute_cnn(params, x, plan, cfg, impl="auto",
                      lowering=model.graph, device=device)
    ref = reference_forward(params, x, cfg, lowering=model.graph,
                            device=device)
    exact = bool(torch.all(res.logits == ref))
    before = trace_count()
    execute_cnn(params, x, plan, cfg, impl="auto", lowering=model.graph,
                device=device)
    no_retrace = trace_count() == before

    s = graph_summary(model.graph, model.name)
    if verbose:
        print(f"\n## {model.name}  ({s['n_nodes']} nodes, "
              f"{s['n_gemm_layers']} GEMM layers, ops={s['ops']})")
        print(f"   modeled fps={plan.fps:.1f}  mix={plan.mix()}  "
              f"logits={tuple(res.logits.shape)}")
        print(f"   bit-exact vs oracle: {exact}   "
              f"zero warm recaptures: {no_retrace}")
        print(plan_table(plan, max_rows=6))
    if not exact:
        print(f"FAIL {model.name}: compiled output != oracle",
              file=sys.stderr)
    if not no_retrace:
        print(f"FAIL {model.name}: warm call recaptured", file=sys.stderr)
    return exact and no_retrace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="gate: one ResNet + one MobileNet only")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = (["resnet_mini", "mobilenet_mini"] if args.smoke
             else list(PAPER_ZOO))
    ok = {n: run_model(PAPER_ZOO[n], device, verbose=not args.smoke)
          for n in names}
    if not all(ok.values()):
        sys.exit(1)
    print(f"\nzoo {'smoke ' if args.smoke else ''}conformance: "
          f"{len(names)}/{len(names)} networks bit-exact, no recaptures")
    return {"conformant": ok}


if __name__ == "__main__":
    main()

"""The execution engine end-to-end: plan, execute, report (on the port).

1. Auto-schedule per-layer dataflows for the paper's CNNs — on HEANA the
   plan keeps OS (or a free-latency WS swap on tiny layers); on the
   thermo-optic AMW baseline it mixes WS with IS for the fc layer.
2. Show the content-addressed plan cache: re-planning is all hits.
3. Execute a small CNN end-to-end through the TAOM kernel and check it
   against the plain-version forward bit-exactly (noise off), then run it
   with detection noise threaded per layer.

Run:  PYTHONPATH=src python examples_torch/autoflow_inference.py
      [--device cpu]
"""
import argparse

import torch

from repro_torch.core.perf_model import AcceleratorConfig, cnn_inference
from repro_torch.core.types import (Backend, Dataflow, PhotonicConfig,
                                    resolve_device)
from repro_torch.exec import (PlanCache, execute_cnn, plan_for_network,
                              plan_table, reference_forward, schedule_cnn)
from repro_torch.models.cnn import CNN_ZOO, build_small_cnn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"mix": {}}

    # 1 — per-layer dataflow auto-scheduling
    cache = PlanCache()
    print("== auto-scheduled dataflow mix (batch 1, 1 GS/s) ==")
    for be in ("heana", "amw"):
        acc = AcceleratorConfig.equal_area(be, Dataflow.OS, 1.0)
        for name, fn in CNN_ZOO.items():
            layers = fn()
            plan = schedule_cnn(layers, acc, batch=1, cache=cache)
            best_fixed = max(cnn_inference(
                layers, AcceleratorConfig.equal_area(be, f, 1.0)).fps
                for f in Dataflow)
            mix = plan.mix()
            out["mix"][f"{be}/{name}"] = (mix, plan.fps, best_fixed)
            print(f"  {be:6s} {name:14s} mix os/is/ws = "
                  f"{mix['os']}/{mix['is']}/{mix['ws']}   "
                  f"auto {plan.fps:12.1f} FPS  (best fixed "
                  f"{best_fixed:12.1f}, x{plan.fps / best_fixed:.3f})")

    # 2 — the plan cache makes re-planning free
    plan = schedule_cnn(CNN_ZOO["googlenet"](),
                        AcceleratorConfig.equal_area("heana", Dataflow.OS,
                                                     1.0),
                        batch=1, cache=cache)
    out["replan"] = (plan.cache_hits, plan.cache_misses)
    print(f"\n== re-plan googlenet: {plan.cache_hits} hits / "
          f"{plan.cache_misses} misses ({len(cache)} cached plans) ==")
    print("\n== googlenet plan, heaviest layers ==")
    print(plan_table(plan, max_rows=5))

    # 3 — end-to-end execution through the TAOM kernel
    gen = torch.Generator().manual_seed(0)
    params = build_small_cnn(gen, device=device)
    x = torch.randn((4, 16, 16, 3), generator=gen).to(device)
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    exec_plan = plan_for_network(params, acc, batch=4, cache=cache)

    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    res = execute_cnn(params, x, exec_plan, cfg, impl="auto", device=device)
    ref = reference_forward(params, x, cfg, device=device)
    out["bit_exact"] = bool(torch.all(res.logits == ref))
    print(f"\n== executed small CNN (TAOM kernel) vs plain reference: "
          f"bit-exact = {out['bit_exact']} ==")
    print(f"   modeled: {exec_plan.fps:.0f} FPS, "
          f"{exec_plan.latency_s * 1e9:.2f} ns/batch; per-layer flows: "
          f"{[t.dataflow for t in res.traces]}")

    cfg_noisy = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                               noise_enabled=True)
    noisy = execute_cnn(params, x, exec_plan, cfg_noisy, seed=7,
                        impl="auto", device=device)
    out["drift"] = float(torch.linalg.norm(noisy.logits - res.logits) /
                         torch.linalg.norm(res.logits))
    print(f"   with detection noise (per-layer seeds): rel logit drift "
          f"{out['drift']:.4f}")
    return out


if __name__ == "__main__":
    main()

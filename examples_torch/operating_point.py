"""One operating point, everything derived: the fan-out demo (port).

A single ``core.hw.OperatingPoint`` — (backend, dataflow, bits, data
rate) — is the only hardware knob you set.  Everything else follows from
the paper's own solvers:

  * DPE size N        <- scalability analysis (Eqs. 1-3, Fig. 9)
  * detection sigma   <- link budget + noise model (Eqs. 1-2)
  * per-event energy  <- Table 3 constants
  * kernel PhotonicConfig + scheduler AcceleratorConfig <- factories

The demo prints the derived physics for the three DPU organizations,
then executes a zoo network end-to-end (the TAOM kernel on the card) at
the HEANA equal-area point and shows the executed-trace energy/FPS/W
agreeing with the analytic perf-model prediction — and a deliberately
incoherent kernel config being rejected by the executor.

Run:  PYTHONPATH=src python examples_torch/operating_point.py
      [--device cpu]
"""
import argparse

import torch

from repro_torch.core import hw
from repro_torch.core import perf_model as pm
from repro_torch.core.types import Dataflow, resolve_device
from repro_torch.exec import PlanCache, execute_cnn, plan_for_network
from repro_torch.models.zoo_cnn import ZOO


def derived_points() -> list:
    """describe() of each backend's equal-area point at 1, 5, 10 GS/s."""
    return [hw.OperatingPoint.equal_area(be, Dataflow.OS, dr).describe()
            for be in ("heana", "amw", "maw") for dr in (1.0, 5.0, 10.0)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("## Derived operating points (B=4)\n")
    print("| backend | DR GS/s | N | DPUs | P_pd dBm | sigma_rel | ENOB |")
    print("|---|---|---|---|---|---|---|")
    points = derived_points()
    for d in points:
        print(f"| {d['backend']} | {d['data_rate_gsps']:g} | "
              f"{d['dpe_size']} | {d['n_dpus']} | "
              f"{d['pd_power_dbm']:.2f} | {d['noise_sigma_rel']:.4f} "
              f"| {d['enob']:.2f} |")

    model = ZOO["resnet_mini"]
    op = hw.OperatingPoint.equal_area("heana", Dataflow.OS, 1.0,
                                      noise_enabled=False)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    x = torch.randn((2, *model.in_hw, model.in_ch),
                    generator=torch.Generator().manual_seed(1)).to(device)
    plan = plan_for_network(params, op, batch=2, in_hw=model.in_hw,
                            lowering=model.graph, cache=PlanCache())
    res = execute_cnn(params, x, plan, op.kernel_config(), impl="auto",
                      lowering=model.graph, device=device)
    te = res.energy()
    ana = pm.cnn_inference(model.gemms(params), plan.acc, batch=2,
                           dataflows=list(plan.dataflows))
    gap = abs(te.fps_per_watt - ana.fps_per_watt) / ana.fps_per_watt
    print(f"\n## {model.name} executed at the HEANA equal-area point\n")
    print(f"   executed-trace: fps={te.fps:.1f}  fps/W="
          f"{te.fps_per_watt:.1f}  uJ/img={te.j_per_image * 1e6:.3f}")
    print(f"   analytic model: fps={ana.fps:.1f}  fps/W="
          f"{ana.fps_per_watt:.1f}")
    print(f"   coherent by construction: rel gap = {gap:.1e}")
    top = max(res.traces, key=lambda t: t.executed_energy_j)
    print(f"   hottest layer: {top.name} "
          f"({top.executed_energy_j * 1e6:.2f} uJ, "
          f"{top.adc_conversions} ADC conversions, {top.dataflow})")

    print("\n## Incoherent kernel configs are rejected\n")
    rejected = None
    try:
        execute_cnn(params, x, plan, op.kernel_config(bits=6),
                    impl="ref", lowering=model.graph, device=device)
    except ValueError as e:
        rejected = str(e).splitlines()[0]
        print("   " + rejected)
        print("   (full message names every disagreeing field and the "
              "OperatingPoint fix)")
    return {"points": points, "executed_fps": te.fps,
            "executed_fps_per_watt": te.fps_per_watt,
            "analytic_fps": ana.fps, "analytic_fps_per_watt":
            ana.fps_per_watt, "rel_gap": gap, "hottest": top.name,
            "rejected": rejected}


if __name__ == "__main__":
    main()

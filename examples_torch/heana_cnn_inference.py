"""The paper's own workload: CNN inference ON the simulated HEANA.

Trains a small CNN on a synthetic 10-class task, then runs its inference
with every conv/fc GEMM executed by the photonic simulation at the 8-bit
design point — HEANA (BPCA analog carry) vs MAW (per-chunk ADC) vs ideal
int8 — and reports the Table-4-style accuracy drops, plus the perf model's
FPS/FPS-per-W for the same accelerators on the paper's four CNNs.

On the card every photonic GEMM runs the TAOM kernel (at 8 bits its fused
route on two s8 planes; N = 2 for HEANA and N = 1 for MAW at 1 GS/s, both
through its small-chunk kernel).

  PYTHONPATH=src python examples_torch/heana_cnn_inference.py
  PYTHONPATH=src python examples_torch/heana_cnn_inference.py --device cpu
"""
import argparse

from _table4 import NUMERICS, evaluate, train_model
from repro_torch.core.perf_model import AcceleratorConfig, cnn_inference, gmean
from repro_torch.core.types import Dataflow, resolve_device
from repro_torch.models.cnn import CNN_ZOO


def fig11_ratios() -> dict:
    """HEANA-OS over the best fixed-dataflow baseline, gmean over the
    paper's four CNNs at 1 GS/s: {base: (FPS ratio, FPS/W ratio)}."""
    ratios_fps, ratios_w = {"amw": [], "maw": []}, {"amw": [], "maw": []}
    for fn in CNN_ZOO.values():
        layers = fn()
        h = cnn_inference(layers,
                          AcceleratorConfig.equal_area("heana", Dataflow.OS,
                                                       1.0))
        for base in ("amw", "maw"):
            bf = max(cnn_inference(layers, AcceleratorConfig.equal_area(
                base, f, 1.0)).fps for f in Dataflow)
            bw = max(cnn_inference(layers, AcceleratorConfig.equal_area(
                base, f, 1.0)).fps_per_watt for f in Dataflow)
            ratios_fps[base].append(h.fps / bf)
            ratios_w[base].append(h.fps_per_watt / bw)
    return {base: (gmean(ratios_fps[base]), gmean(ratios_w[base]))
            for base in ("amw", "maw")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("training reference CNN (exact numerics)...")
    params, losses = train_model(device=device)
    accs = {m: evaluate(params, m) for m in NUMERICS}
    print("\n== Table-4 proxy: top-1 under analog numerics ==")
    drops = {}
    for m, a in accs.items():
        drops[m] = 100 * (accs["exact"] - a)
        print(f"  {m:6s}: top-1 {a:.4f}   drop {drops[m]:+.2f}%")

    print("\n== Fig-11 headline: HEANA-OS vs best baseline (gmean, 4 CNNs,"
          " 1 GS/s) ==")
    ratios = fig11_ratios()
    for base, (fps, per_w) in ratios.items():
        print(f"  vs {base}: {fps:6.1f}x FPS   {per_w:5.1f}x FPS/W   "
              f"(paper: >=66x / >=84x)")
    return {"losses": losses, "top1": accs, "drop_pct": drops,
            "fig11": ratios, "params": params}


if __name__ == "__main__":
    main()

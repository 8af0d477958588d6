"""Quickstart: the paper's technique in five snippets, on the port.

1. Scalability analysis (Fig. 9): how large can a HEANA DPU be?
2. A photonic matmul: HEANA vs AMW vs exact numerics.
3. The TAOM kernel vs its oracle (``kernels/ref.py``).
4. System-level FPS/FPS-per-watt (Fig. 11) for ResNet50.
5. An LM forward pass running *through* the photonic backend.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import Backend, PhotonicConfig, max_dpe_size
from repro_torch.core.perf_model import AcceleratorConfig, cnn_inference
from repro_torch.core.photonic_gemm import design_point, generator_for
from repro_torch.core.types import Dataflow, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model_zoo as zoo
from repro_torch.models.cnn import CNN_ZOO
from repro_torch.models.layers import PhotonicCtx


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}

    # 1 — scalability (paper Fig. 9): the hitless TAOM arrangement lets
    # HEANA run much wider optical dot products than AMW/MAW.
    print("== DPU size N at 4-bit, 1 GS/s ==")
    out["dpe_size"] = {}
    for be in ("heana", "amw", "maw"):
        out["dpe_size"][be] = max_dpe_size(be, 4, 1.0)
        print(f"  {be:6s} N = {out['dpe_size'][be]}")

    # 2 — photonic numerics as a drop-in matmul
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 512), generator=gen).to(device)
    w = torch.randn((512, 64), generator=gen).to(device)
    exact = x @ w
    print("\n== photonic matmul rel-RMSE vs exact (4-bit design points) ==")
    out["rel_rmse"] = {}
    for be in (Backend.HEANA, Backend.AMW):
        cfg = design_point(be, bits=4, data_rate_gsps=1.0)
        got = ops.photonic_matmul(x, w, cfg,
                                  generator=generator_for(2, device))
        err = float(torch.linalg.norm(got - exact) /
                    torch.linalg.norm(exact))
        out["rel_rmse"][be.value] = err
        print(f"  {be.value:6s} N={cfg.dpe_size:3d}  rel-rmse={err:.4f}")

    # 3 — the TAOM kernel (the plain version on the CPU) agrees with the
    # oracle
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=8, dpe_size=128,
                         noise_enabled=False)
    a = ops.photonic_matmul(x, w, cfg, impl="auto")
    b = ops.photonic_matmul(x, w, cfg, impl="ref")
    out["kernel_vs_oracle"] = float(torch.max(torch.abs(a - b)))
    print(f"\n== TAOM kernel vs oracle max diff: "
          f"{out['kernel_vs_oracle']:.2e} ==")

    # 4 — system-level evaluation (paper Fig. 11, ResNet50 @ 1 GS/s)
    print("\n== ResNet50 FPS / FPS-per-W (equal-area, 1 GS/s) ==")
    layers = CNN_ZOO["resnet50"]()
    out["resnet50"] = {}
    for be, flow in (("heana", Dataflow.OS), ("amw", Dataflow.WS),
                     ("maw", Dataflow.WS)):
        r = cnn_inference(layers, AcceleratorConfig.equal_area(be, flow, 1.0))
        out["resnet50"][f"{be}-{flow.value}"] = (r.fps, r.fps_per_watt)
        print(f"  {be:6s}-{flow.value}: {r.fps:12.0f} FPS   "
              f"{r.fps_per_watt:8.2f} FPS/W")

    # 5 — an LM forward through the photonic backend
    cfg_lm = get_config("qwen2-0.5b", smoke=True)
    params = zoo.init_params(cfg_lm, 0, device)
    tokens = torch.randint(0, cfg_lm.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(0)
                           ).to(device)
    batch = {"tokens": tokens, "targets": tokens}
    out["lm_loss"] = {}
    for name, ctx in (("exact", PhotonicCtx()),
                      ("heana-8bit", PhotonicCtx(cfg=PhotonicConfig(
                          backend=Backend.HEANA, bits=8, adc_bits=12,
                          dpe_size=128, noise_enabled=False)))):
        with torch.no_grad():
            loss = float(zoo.loss_fn(params, batch, cfg_lm, ctx=ctx))
        out["lm_loss"][name] = loss
        print(f"  qwen2-0.5b(smoke) loss under {name:10s}: {loss:.4f}")
    return out


if __name__ == "__main__":
    main()

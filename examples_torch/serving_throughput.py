"""The compiled serving path: plan once, capture once, stream batches.

The port's counterpart of the reference's jit demo:

1. Plan the small CNN once (content-addressed plan cache).
2. ``compiled_forward`` returns the executable with the plan's tilings
   bound — on the card the first call captures the forward in a CUDA
   graph, every later call of that shape replays it: zero recaptures,
   zero per-layer host syncs.  (On the CPU it runs the eager body.)
3. Stream a few warm batches and measure sustained images/sec, graphed
   vs the eager op-by-op path.
4. Traces (per-layer numerics fingerprints) stay on the device and
   materialize lazily — only when actually read, after the stream.

Run:  PYTHONPATH=src python examples_torch/serving_throughput.py
      [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.perf_model import AcceleratorConfig
from repro_torch.core.types import (Backend, Dataflow, PhotonicConfig,
                                    resolve_device)
from repro_torch.exec import (PlanCache, compiled_forward, execute_cnn,
                              plan_for_network, trace_count)
from repro_torch.models.cnn import build_small_cnn

BATCH = 32
STREAM = 8


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    params = build_small_cnn(gen, device=device)
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)

    # 1 — plan once
    plan = plan_for_network(params, acc, batch=BATCH, cache=PlanCache())
    print(f"== plan: batch {BATCH}, flows "
          f"{[p.dataflow.value for p in plan.layers]}, tiles "
          f"{[(p.tile.block_m, p.tile.block_d) for p in plan.layers]} ==")

    # 2 — capture once (the cold call runs the body and captures it)
    fn = compiled_forward(plan, cfg)
    x0 = torch.randn((BATCH, 16, 16, 3), generator=gen).to(device)
    t0 = time.perf_counter()
    fn(params, x0, None)
    _sync(device)
    cold_s = time.perf_counter() - t0
    print(f"== cold call (warm run + capture): {cold_s:.2f} s ==")

    # 3 — stream warm batches
    traces_before = trace_count()
    xs = [torch.randn((BATCH, 16, 16, 3), generator=gen).to(device)
          for _ in range(STREAM)]
    _sync(device)
    t0 = time.perf_counter()
    last = None
    for x in xs:
        last = execute_cnn(params, x, plan, cfg, device=device)
    _sync(device)
    dt = time.perf_counter() - t0
    ips = STREAM * BATCH / dt
    retraces = trace_count() - traces_before
    print(f"== streamed {STREAM} warm batches: {ips:,.0f} images/s "
          f"(host clock), recaptures during stream: {retraces} ==")

    # eager baseline (the op-by-op body), one batch
    execute_cnn(params, x0, plan, cfg, compiled=False, device=device)
    _sync(device)
    t0 = time.perf_counter()
    execute_cnn(params, x0, plan, cfg, compiled=False, device=device)
    _sync(device)
    eager_s = time.perf_counter() - t0
    print(f"== eager baseline: {BATCH / eager_s:,.0f} images/s "
          f"-> compiled speedup {ips * eager_s / BATCH:,.1f}x ==")

    # 4 — traces materialize lazily, only now
    print("\n== per-layer trace of the last batch (lazy fingerprints) ==")
    for t in last.traces:
        print(f"   {t.name:6s} m={t.m:<6d} k={t.k:<4d} d={t.d:<4d} "
              f"{t.dataflow} tile=({t.block_m},{t.block_d}) "
              f"mean|out|={t.out_mean_abs:.4f}")
    print(f"\n   modeled (photonic perf model): {plan.fps:,.0f} FPS — "
          f"different machine, never compare to host img/s directly")
    return {"cold_s": cold_s, "ips": ips, "retraces": retraces,
            "eager_ips": BATCH / eager_s, "speedup": ips * eager_s / BATCH,
            "modeled_fps": plan.fps}


if __name__ == "__main__":
    main()

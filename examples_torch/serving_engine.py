"""The batched serving engine: buckets, warmup, micro-batching, stats.

Demonstrates exec.serving end to end on the port:

1. Build a ServingEngine for a zoo network: every power-of-two batch
   bucket gets its own auto-scheduled CnnPlan up front (shared plan
   cache), and ``warmup()`` captures every bucket's forward in a CUDA
   graph on the card — after it, no request ever pays a capture.
2. Serve mixed-size requests: each is padded to the smallest bucket that
   fits and sliced back (zero recaptures, bitwise equal to an exact-size
   batch).
3. Coalesce single-image requests through the thread-safe MicroBatcher
   (Futures resolve with each request's row of the batched logits).
4. Data-parallel serving over several devices is not ported yet
   (ROADMAP A9: ``ServingEngine(data_parallel=True)`` raises); the
   section says so and names the device count.
5. Print the serving metrics: p50/p99 latency, sustained throughput,
   padding overhead, cache stats.

Run:  PYTHONPATH=src python examples_torch/serving_engine.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.core.perf_model import AcceleratorConfig
from repro_torch.core.types import (Backend, Dataflow, PhotonicConfig,
                                    resolve_device)
from repro_torch.exec import MicroBatcher, ServingEngine, trace_count
from repro_torch.models.zoo_cnn import ZOO

NETWORK = "small_cnn"
MAX_BATCH = 8
REQUEST_SIZES = (1, 3, 5, 8, 2, 8, 4, 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    zoo = ZOO[NETWORK]
    gen = torch.Generator().manual_seed(0)
    params = zoo.init_params(gen, device=device)
    acc = AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)

    # 1 — bucketed plans + warmup (a CUDA graph per bucket on the card)
    engine = ServingEngine(params, acc, cfg, lowering=zoo.graph,
                           in_hw=zoo.in_hw, max_batch=MAX_BATCH,
                           device=device)
    cold = engine.warmup()
    print(f"== {NETWORK}: buckets {engine.buckets}, warmup "
          f"{ {b: round(s, 2) for b, s in cold.items()} } s ==")

    # 2 — mixed-size traffic, zero recaptures
    h, w = zoo.in_hw
    traces0 = trace_count()
    xs = [torch.randn((n, h, w, zoo.in_ch), generator=gen).to(device)
          for n in REQUEST_SIZES]
    t0 = time.perf_counter()
    for x in xs:
        logits = engine.infer(x)
        assert logits.shape == (x.shape[0], zoo.num_classes)
    dt = time.perf_counter() - t0
    retraces = trace_count() - traces0
    n_imgs = sum(REQUEST_SIZES)
    print(f"== served {len(REQUEST_SIZES)} mixed-size requests "
          f"({n_imgs} images) in {dt:.2f} s — recaptures: {retraces} ==")

    # 3 — micro-batched single-image traffic
    singles = [torch.randn((h, w, zoo.in_ch), generator=gen).to(device)
               for _ in range(12)]
    with MicroBatcher(engine, max_delay_s=0.01) as mb:
        futs = [mb.submit(img) for img in singles]
        outs = [f.result(timeout=60) for f in futs]
    assert all(o.shape == (zoo.num_classes,) for o in outs)
    mb_stats = mb.stats()
    print(f"== micro-batcher coalesced 12 single-image requests: "
          f"{mb_stats} ==")

    # 4 — data-parallel path: not ported (ROADMAP A9)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"== data-parallel skipped ({n_dev} device(s) visible; "
          f"ServingEngine(data_parallel=True) is not ported yet, "
          f"ROADMAP A9) ==")

    # 5 — serving metrics
    s = engine.stats()
    print("\n== serving stats ==")
    print(f"   requests {s['requests']}, images {s['images']}, "
          f"batches {s['batches']}")
    print(f"   latency p50 {s['latency_p50_s'] * 1e3:.1f} ms, "
          f"p99 {s['latency_p99_s'] * 1e3:.1f} ms; sustained "
          f"{s['sustained_ips']:,.0f} img/s (host clock)")
    print(f"   padding overhead {100 * s['padding_fraction']:.1f}% of "
          f"executed slots; recaptures since warmup "
          f"{s['retraces_since_warmup']}")
    print(f"   plan cache {s['plan_cache']['hits']}h/"
          f"{s['plan_cache']['misses']}m; compiled wrappers "
          f"{s['compile_cache']['entries']}")
    return {"buckets": list(engine.buckets), "warmup_s": cold,
            "retraces": retraces, "microbatcher": mb_stats,
            "n_devices": n_dev, "stats": s}


if __name__ == "__main__":
    main()

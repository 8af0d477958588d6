#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught or skipped):

  1. build    — compile the TAOM GEMM kernel from ``src/repro_torch/kernels/
                csrc/taom_gemm.cu`` with nvcc (sm_90a) and print the time;
  2. kernel   — hold the kernel against its plain PyTorch version on the
                card: both policies (HEANA analog carry, AMW chunk-ADC),
                noise on and off, bits 6 and 8, every resnet_mini GEMM of
                the served bucket-32 plan at the tile that plan gives it
                (N=83), plus a ragged C>=3 shape; bit-equal wherever the
                integer psums stay below 2^24 (asserted on the inputs); one
                shape at two tilings; then time the kernel, its plain
                version and torch.matmul at those shapes and tiles with
                noise off, as served (device time from CUDA graph replay,
                and time per eager call) beside the bound;
  3. serving  — ServingEngine for resnet_mini (seeded random weights, the
                paper's equal-area HEANA point, 6-bit, noise off,
                max_batch 64) warms up and serves requests of 1, 3, 17, 64
                and 100 images; the logits must equal the plain-version
                path (``execute_cnn(impl="ref")``) bit for bit, and the
                kernel must have launched 13 times per bucket forward; one
                noisy request served twice from one seed must be finite
                and identical; then bucket-32 requests on the host clock
                and under ``torch.profiler`` (the device's busy time by
                kernel, its idle share, the TAOM kernel's time per
                request);
  4. report   — the kernels' JSON line, the card's name and power limit,
                and the result line.

Needs one CUDA card and the repository around it (``src/repro_torch``);
imports neither JAX nor the reference package.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # the same, f32 outside the tensor cores
EXACT_LIMIT = 2.0 ** 24
BATCH = 32                       # the bucket whose shapes phase 2 uses
REQUESTS = 20                    # bucket-32 requests timed and profiled


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 50) -> float:
    """Time per eager call of fn() over ``iters`` back-to-back calls (CUDA
    events), after 5 warm-up calls: the larger of the host's cost to issue
    the call and the device's time to run it."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of fn(): ``iters`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events — the
    host's cost of issuing each call is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def profile_requests(serve) -> dict:
    """Serve ``REQUESTS`` requests under torch.profiler and split the
    device's time: busy (sum of kernel times), idle share of the span from
    the first kernel's start to the last one's end, and the TAOM kernel's
    share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / REQUESTS * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert kernels, "the profiler saw no device activity"
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels) -
               min(e.time_range.start for e in kernels))
    taom = [e for e in kernels if "taom_gemm" in e.name]
    taom_us = sum(e.time_range.elapsed_us() for e in taom)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "top_kernels_ms_per_request": [[name[:60], us / REQUESTS / 1e3]
                                       for name, us in top],
        "profiled_wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_us / REQUESTS / 1e3,
        "device_idle_share": 1.0 - busy_us / span_us,
        "device_kernels_per_request": len(kernels) / REQUESTS,
        "taom_kernel_ms_per_request": taom_us / REQUESTS / 1e3,
        "taom_launches_per_request": len(taom) / REQUESTS,
        "taom_share_of_device_busy": taom_us / busy_us,
    }


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script — run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this check runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import perf_model as pm
    from repro_torch.core.taom import quantize
    from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
    from repro_torch.exec import ServingEngine, execute_cnn
    from repro_torch.kernels import ref, taom_gemm
    from repro_torch.models.zoo_cnn import ZOO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib, build_log = taom_gemm.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # -- 2. kernel vs plain version on the card -------------------------------
    # The main path: the served engine's bucket-32 plan gives every GEMM's
    # shape (batch folded into M) and the tile it is launched with.
    model = ZOO["resnet_mini"]
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    acc = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    main_cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                              noise_enabled=False)
    engine = ServingEngine(params, acc, main_cfg, lowering=model.graph,
                           in_hw=model.in_hw, max_batch=64, device=dev)
    path = [(lp.name, lp.c, lp.k, lp.d, lp.tile.block_m, lp.tile.block_d)
            for lp in engine.plans[BATCH].layers]
    n_gemms = len(model.graph.gemm_nodes)
    assert len(path) == n_gemms, (len(path), n_gemms)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def operands(m, k, d, bits):
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, d), generator=gen, device=dev)
        xq, _ = quantize(x, bits)
        wq, _ = quantize(w, bits, axis=0)
        bound = (xq.abs().double() @ wq.abs().double()).max().item()
        assert bound < EXACT_LIMIT, (m, k, d, bits, bound)
        return xq.contiguous(), wq.contiguous()

    def noise_for(cfg, m, k, d):
        c = -(-k // cfg.dpe_size)
        shape = (c, m, d) if cfg.backend == Backend.AMW else (m, d)
        return torch.randn(shape, generator=gen, device=dev)

    max_err = 0.0
    cases = sorted({((m, k, d), 83, (bm, bd)) for _, m, k, d, bm, bd in path})
    cases.append(((1000, 200, 37), 36, (128, 128)))
    n_cases = 0
    for (m, k, d), n, (bm, bd) in cases:
        for backend in (Backend.HEANA, Backend.AMW):
            for bits in (6, 8):
                cfg = PhotonicConfig(backend=backend, bits=bits, dpe_size=n,
                                     noise_enabled=True)
                xq, wq = operands(m, k, d, bits)
                fs = taom_gemm.calibrated_adc_fs(k, cfg)
                for noise in (noise_for(cfg, m, k, d), None):
                    got = taom_gemm.taom_gemm_quantized(
                        xq, wq, noise, cfg, fs, block_m=bm, block_d=bd)
                    want = ref.taom_gemm_reference(xq, wq, noise, cfg, fs)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    max_err = max(max_err, err)
                    assert err == 0.0, (m, k, d, n, backend, bits, err)
                    n_cases += 1
    log(f"[kernel] {n_cases} cases bit-equal to the plain version "
        f"(max |kernel - plain| = {max_err})")
    _, m, k, d, bm, bd = max(path, key=lambda p: (-(-p[2] // 83), p[1]))
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=True)
    xq, wq = operands(m, k, d, 6)
    noise = noise_for(cfg, m, k, d)
    fs = taom_gemm.calibrated_adc_fs(k, cfg)
    tiles = [taom_gemm.taom_gemm_quantized(xq, wq, noise, cfg, fs,
                                           block_m=tm, block_d=td)
             for tm, td in ((bm, bd), (16, 8))]
    assert torch.equal(tiles[0], tiles[1]), "numerics depend on the tile"
    log(f"[kernel] ({m}, {k}, {d}) equal at tile widths "
        f"{taom_gemm.kernel_tile(d, bd)} and {taom_gemm.kernel_tile(d, 8)}")

    # Times at the main path's shapes, tiles and config (6-bit HEANA,
    # noise off: no noise tensor is read, as on the path).
    rows = []
    for name, m, k, d, bm, bd in path:
        xq, wq = operands(m, k, d, 6)
        fs = taom_gemm.calibrated_adc_fs(k, main_cfg)
        nbytes = 4 * (m * k + k * d + m * d)
        kernel = lambda: taom_gemm.taom_gemm_quantized(      # noqa: E731
            xq, wq, None, main_cfg, fs, block_m=bm, block_d=bd)
        plain = lambda: ref.taom_gemm_reference(              # noqa: E731
            xq, wq, None, main_cfg, fs)
        matmul = lambda: torch.matmul(xq, wq)                 # noqa: E731
        row = {
            "gemm": name, "m": m, "k": k, "d": d, "chunks": -(-k // 83),
            "width": taom_gemm.kernel_tile(d, bd),
            "kernel_ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "matmul_ms": device_ms(matmul),
            "kernel_call_ms": call_ms(kernel), "plain_call_ms": call_ms(plain),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": 2.0 * m * k * d / F32_FLOPS_PER_S * 1e3,
        }
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        rows.append(row)
        log("[kernel] {gemm} M={m} K={k} D={d} C={chunks} width={width}: "
            "kernel_ms={kernel_ms:.5f} plain_ms={plain_ms:.5f} "
            "library_ms(torch.matmul, the nearest single PyTorch call, not "
            "the same function)={matmul_ms:.5f} bound_ms={bound_ms:.5f} "
            "(device times, CUDA graph replay); per eager call: kernel "
            "{kernel_call_ms:.5f} plain {plain_call_ms:.5f}".format(**row))

    # -- 3. serving: the main path --------------------------------------------
    img_gen = torch.Generator(device=dev)
    img_gen.manual_seed(2)
    sizes = (1, 3, 17, 64, 100)
    requests = [torch.randn((n, *model.in_hw, model.in_ch), generator=img_gen,
                            device=dev) for n in sizes]
    taom_gemm.LAUNCHES = 0
    cold = engine.warmup()
    served = [engine.infer(x) for x in requests]
    torch.cuda.synchronize()
    launches = taom_gemm.LAUNCHES
    stats = engine.stats()
    forwards = len(cold) + stats["batches"]
    assert launches == n_gemms * forwards, (launches, n_gemms, forwards)
    log(f"[serving] {launches} kernel launches = {n_gemms} x {forwards} "
        f"bucket forwards (warmup {len(cold)} + served {stats['batches']})")
    for x, got in zip(requests, served):
        want = []
        for lo in range(0, x.shape[0], engine.max_bucket):
            chunk = x[lo:lo + engine.max_bucket]
            n = chunk.shape[0]
            bucket = next(b for b in engine.buckets if b >= n)
            xb = torch.cat([chunk, chunk.new_zeros((bucket - n,) +
                                                   tuple(chunk.shape[1:]))])
            res = execute_cnn(params, xb, engine.plans[bucket], main_cfg,
                              impl="ref", lowering=model.graph, device=dev)
            want.append(res.logits[:n])
        want = torch.cat(want)
        assert got.shape == (x.shape[0], model.num_classes), got.shape
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want), (
            x.shape[0], (got - want).abs().max().item())
    log(f"[serving] logits of {list(sizes)}-image requests bit-equal to "
        f"execute_cnn(impl='ref')")
    noisy_cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                               noise_enabled=True)
    noisy = ServingEngine(params, acc, noisy_cfg, lowering=model.graph,
                          in_hw=model.in_hw, max_batch=8, device=dev)
    a = noisy.infer(requests[2][:5], seed=1234)
    b = noisy.infer(requests[2][:5], seed=1234)
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    quiet = engine.infer(requests[2][:5])          # same bucket, noise off
    assert not torch.equal(a, quiet), "noise had no effect"
    log("[serving] noisy request: finite and identical from one seed")
    log("[serving] stats " + json.dumps(engine.stats(), sort_keys=True))

    # Bucket-32 requests: host clock, then where the device's time goes.
    x32 = requests[4][:BATCH]
    for _ in range(3):
        engine.infer(x32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REQUESTS):
        engine.infer(x32)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / REQUESTS * 1e3
    split = profile_requests(lambda: engine.infer(x32))
    log(f"[serving] bucket-32 request, {REQUESTS} runs: {wall_ms:.4f} ms "
        f"host clock unprofiled; " + json.dumps(split, sort_keys=True))
    log(f"[serving] TAOM kernel per bucket-32 forward: "
        f"{split['taom_kernel_ms_per_request']:.5f} ms on the path "
        f"(profiler, {split['taom_launches_per_request']:g} launches) vs "
        f"{sum(r['kernel_ms'] for r in rows):.5f} ms in phase 2 (CUDA "
        f"graph replay at the same shapes and tiles)")

    # -- 4. report ------------------------------------------------------------
    entry = {
        "name": "taom_gemm_quantized",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/taom_gemm.cu",
        "replaces": "src/repro/kernels/taom_gemm.py:120",
        "launches": launches,
        "max_abs_err": max_err,
        # Per resnet_mini forward at batch 32: the sum over its 13 GEMMs at
        # the plan's tiles, device time (CUDA graph replay); call_ms adds
        # the host's cost of issuing each eager call; path_ms is the
        # profiler's time of the same 13 launches inside served requests.
        "ms": sum(r["kernel_ms"] for r in rows),
        "call_ms": sum(r["kernel_call_ms"] for r in rows),
        "path_ms": split["taom_kernel_ms_per_request"],
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("bytes" if sum(r["bytes_ms"] for r in rows) >=
                     sum(r["ops_ms"] for r in rows) else "operations"),
        # No single PyTorch call computes this function (quantized GEMM
        # with per-chunk noise and ADC rounding).
        "library_ms": None,
        "matmul_ms": sum(r["matmul_ms"] for r in rows),
        "matmul_note": "torch.matmul of the same f32 operands: the nearest "
                       "single PyTorch call, not the same function",
        "per": "one resnet_mini forward at batch 32 (13 GEMMs)",
    }
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

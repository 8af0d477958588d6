#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught or skipped):

  1. build    — compile the three kernels, ``src/repro_torch/kernels/
                csrc/taom_gemm.cu``, ``ssd_scan.cu`` and
                ``flash_attention.cu``, with nvcc (sm_90a), the three nvcc
                processes started together, and print the times;
  2. kernel   — hold the TAOM kernels against their plain PyTorch
                versions on the card.  The float32 body: both policies
                (HEANA analog carry, AMW chunk-ADC), noise on and off, bits
                6 and 8, every resnet_mini GEMM of the served bucket-32
                plan at the tile that plan gives it (N=83), plus a ragged
                C>=3 shape; bit-equal wherever the integer psums stay below
                2^24 (asserted on the inputs); one shape at two tilings.
                The fused int8 route (quantize, GEMM, rescale in two
                kernels): both policies, noise on and off, float32 and bf16
                x, at every plan shape and the photonic mamba2-130m GEMMs
                (M cut to 512), bit-equal to ``ref.photonic_gemm_reference``.
                Then time, per plan GEMM (noise off, as served) and at the
                photonic LM's two GEMMs (M 4000, bf16): the fused route
                (with the profiler's split between its absmax and int8
                kernels), the float32 body with PyTorch's quantize and
                rescale, that body alone, the plain route and torch.matmul
                (device time from CUDA graph replay, and time per eager
                call) beside the bound (x, w and the output once at 3.35
                TB/s against 2 M K D operations at 1,979 TOP/s int8);
  3. serving  — ServingEngine for resnet_mini (seeded random weights, the
                paper's equal-area HEANA point, 6-bit, noise off,
                max_batch 64) warms up and serves requests of 1, 3, 17, 64
                and 100 images; the logits must equal the plain-version
                path (``execute_cnn(impl="ref")``) bit for bit, and the
                TAOM wrapper must have been called 13 times per bucket
                forward; one noisy request served twice from one seed must
                be finite and identical; then bucket-32 requests on the
                host clock and under ``torch.profiler`` (the device's busy
                time by kernel, its idle share, kernels per request, the
                TAOM route's two kernels per request);
  4. ssd      — hold the SSD scan's three kernels (chunk state, state
                pass, chunk out) against their plain PyTorch version
                (``ops._ssd_chunked``) on the card within rtol 1e-4 and
                atol 1e-4 * max|plain|: the mamba2-130m width (BH 96, L
                1024, P 64, S 128, Q 128), the smoke config's (P 16, S 16,
                Q 8), zamba2's (P 64, S 64), a ragged L (1000) through
                ``ops.ssd_scan``, the largest head (P 128), Q 100, a single
                chunk (L == Q) and a fast decay (a ~ -30); then time the
                kernels and the plain version at the full width (CUDA graph
                replay) beside the bound, split the kernels' time by kernel
                (torch.profiler), and print each kernel's resident blocks
                an SM and the workspace's bytes;
  5. mamba    — serve mamba2-130m at its full width through
                ``launch/serve.serve`` (24 layers, d_model 768, seeded
                random bf16 weights, batch 4, prompt 1000, 16 greedy
                tokens): tokens in range, the SSD wrapper called once per
                layer in the prefill (three kernels each: 72 in the
                profile) and never in decode; in a float32 copy
                of the config the kernel's prefill and 4 decode steps agree
                with the plain version's; a prefill under a HEANA photonic
                ctx (6-bit, noise off) is bit-equal between the TAOM
                kernels and their plain version, and is profiled (device
                busy, the TAOM route's share, 96 kernels); prefill/decode
                times on the host clock and a profile of one prefill and
                one decode step;
  6. flash    — hold the flash-attention kernel against its plain PyTorch
                version (``ops._flash_blocked``) on the card: qwen2-0.5b's
                served shape (BH 64 = batch 4 x 16 padded heads, S 1000, D
                64, causal) in bf16 and float32, h2o-danube3's head (D 120,
                window 4096, S 5000), gemma3's (D 240, window 1024, S
                2048), a non-causal shape (S 1500, D 64) and a tiny ragged
                one (S 37, D 16), then the bf16 tensor-core kernel's edges
                (non-causal, D 24 and 40, D 36 without TMA, one token, a
                key one past a tile, a window starting inside a key tile);
                float32 within rtol 1e-5 and atol 1e-5 * max|plain|, bf16
                within one bf16 ulp of max|plain|'s binade; then time
                kernel, plain version and PyTorch's
                scaled_dot_product_attention (the yardstick; the port never
                calls it) at qwen2's shape (CUDA graph replay) beside the
                bound, with the kernel/SDPA ratio and the kernel's TFLOP/s
                over the function's flops, and the bf16 kernel alone at
                h2o-danube3's and gemma3's shapes;
  7. qwen2    — serve qwen2-0.5b at its full width through
                ``launch/serve.serve`` (24 layers, d_model 896, 14 of 16
                padded heads, GQA over 2 KV heads, QKV bias, seeded random
                bf16 weights, batch 4, prompt 1000, 16 greedy tokens):
                tokens in range, the flash kernel launched once per layer
                in the prefill and never in decode; in a float32 copy of
                the config the kernel's prefill and 4 decode steps agree
                with the plain version's (logits and KV caches within 1e-4
                of max|plain|); prefill/decode times on the host clock and
                a profile of one prefill and one decode step;
  8. report   — the kernels' JSON line, the card's name and power limit,
                and the result line.

Needs one CUDA card and the repository around it (``src/repro_torch``);
imports neither JAX nor the reference package.
"""
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # the same, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # the same, bf16 dense on the tensor cores
INT8_OPS_PER_S = 1979e12         # the same, int8 dense on the tensor cores
EXACT_LIMIT = 2.0 ** 24
BATCH = 32                       # the bucket whose shapes phase 2 uses
REQUESTS = 20                    # bucket-32 requests timed and profiled
LM_ARCH = "mamba2-130m"          # phase 5's model, at its full width
LM_BATCH, LM_PROMPT, LM_GEN = 4, 1000, 16
# The photonic mamba2-130m prefill's two GEMMs (batch x prompt rows, bf16):
# in_proj d_model -> 2 d_inner + 2 ngroups d_state + nheads, out_proj
# d_inner -> d_model.  Phase 5 checks them against the model's weights.
TAOM_LM_SHAPES = (("in_proj", LM_BATCH * LM_PROMPT, 768, 3352),
                  ("out_proj", LM_BATCH * LM_PROMPT, 1536, 768))
SSD_TOL = 1e-4                   # rtol, and atol as a share of max|plain|
# Phase 4's shapes (BH, L, P, S, Q, decay): mamba2-130m at LM_BATCH (the
# shape timed), the smoke config's, zamba2's head and state, a ragged L,
# the largest head, a chunk that is not a multiple of 4, a single chunk,
# and a = -30 exp(N(0, 1)) (exp underflows inside a chunk).
SSD_SHAPES = ((96, 1024, 64, 128, 128, 1.0), (8, 64, 16, 16, 8, 1.0),
              (24, 512, 64, 64, 128, 1.0), (96, 1000, 64, 128, 128, 1.0),
              (4, 256, 128, 128, 128, 1.0), (4, 300, 64, 128, 100, 1.0),
              (8, 128, 64, 128, 128, 1.0), (96, 1024, 64, 128, 128, 30.0))
QWEN_ARCH = "qwen2-0.5b"         # phase 7's model, at its full width
FLASH_TOL = 1e-5                 # float32: rtol, and atol * max|plain|
# Phase 6's shapes (BH, S, D, causal, window, dtype): qwen2-0.5b's served
# prefill (batch 4 x 16 padded heads; the shape timed) in both dtypes,
# h2o-danube3's and gemma3's heads with their windows (also timed in
# bf16), a non-causal shape and a tiny ragged one; then the bf16 kernel's
# edges: non-causal, D 24 and 40 (TMA zero-fills the 64-column atom), D 36
# (D % 8 != 0: plain loads, no TMA), one token, a key one past a tile, a
# window that starts inside a key tile.
FLASH_SHAPES = ((64, 1000, 64, True, 0, "bfloat16"),
                (64, 1000, 64, True, 0, "float32"),
                (4, 5000, 120, True, 4096, "bfloat16"),
                (4, 2048, 240, True, 1024, "bfloat16"),
                (4, 2048, 240, True, 1024, "float32"),
                (8, 1500, 64, False, 0, "float32"),
                (3, 37, 16, True, 0, "float32"),
                (3, 37, 16, True, 0, "bfloat16"),
                (8, 1500, 64, False, 0, "bfloat16"),
                (4, 300, 24, True, 0, "bfloat16"),
                (4, 300, 40, False, 0, "bfloat16"),
                (4, 300, 36, True, 0, "bfloat16"),
                (2, 1, 64, True, 0, "bfloat16"),
                (4, 65, 64, True, 0, "bfloat16"),
                (4, 1000, 64, True, 40, "bfloat16"))


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


def profile(fn, runs: int, kernel: str, split=()) -> dict:
    """Run fn() ``runs`` times under torch.profiler and split the device's
    time per run: busy (sum of kernel times), idle share of the span from
    the first kernel's start to the last one's end, the time and launches
    of the kernels whose name holds ``kernel``, and the time of those whose
    name holds each of ``split``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / runs * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert kernels, "the profiler saw no device activity"
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels) -
               min(e.time_range.start for e in kernels))
    ours = [e for e in kernels if kernel in e.name]
    ours_us = sum(e.time_range.elapsed_us() for e in ours)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "top_kernels_ms_per_run": [[name[:60], us / runs / 1e3]
                                   for name, us in top],
        "profiled_wall_ms_per_run": wall_ms,
        "device_busy_ms_per_run": busy_us / runs / 1e3,
        "device_idle_share": 1.0 - busy_us / span_us,
        "device_kernels_per_run": len(kernels) / runs,
        "kernel_ms_per_run": ours_us / runs / 1e3,
        "kernel_launches_per_run": len(ours) / runs,
        "kernel_share_of_device_busy": ours_us / busy_us,
        "split_ms_per_run": {
            part: sum(e.time_range.elapsed_us() for e in ours
                      if part in e.name) / runs / 1e3 for part in split},
    }


def taom_bound(m: int, k: int, d: int, elt_bytes: int,
               noise_floats: int = 0) -> dict:
    """Least time for one photonic GEMM: x (M, K) and w (K, D) read once
    and the (M, D) output written once in the operands' type (plus the
    float32 noise when it is on), against 2 M K D operations at the int8
    tensor-core rate."""
    nbytes = elt_bytes * (m * k + k * d + m * d) + 4 * noise_floats
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * k * d / INT8_OPS_PER_S * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def taom_times(name, x, w, cfg, block_m: int, block_d: int,
               unaligned: bool = False) -> dict:
    """One photonic GEMM (noise off, as served) three ways: the fused int8
    route (two kernels; the profiler splits them), the float32 body with
    PyTorch's quantize and rescale around it (the unfused route, which
    8-bit operands still take), and the plain route; device times from
    CUDA graph replay beside the bound.  The first two must agree bit for
    bit with the plain route.  ``unaligned`` also times the fused route on
    a copy of x one element off a 16-byte boundary, which it reads with
    synchronous loads instead of cp.async."""
    import torch
    from repro_torch.core.taom import quantize
    from repro_torch.kernels import ref, taom_gemm
    m, k = x.shape
    d = w.shape[1]
    fs = taom_gemm.calibrated_adc_fs(k, cfg)
    xq, sx = quantize(x.float(), cfg.bits)
    wq, sw = quantize(w.float(), cfg.bits, axis=0)
    xq, wq = xq.contiguous(), wq.contiguous()

    def fused():
        return taom_gemm.taom_gemm_fused(x, w, None, cfg, fs,
                                         block_m=block_m, block_d=block_d)

    def f32_body():
        return taom_gemm.taom_gemm_quantized(xq, wq, None, cfg, fs,
                                             block_m=block_m, block_d=block_d)

    def f32_route():
        xq_, sx_ = quantize(x.float(), cfg.bits)
        wq_, sw_ = quantize(w.float(), cfg.bits, axis=0)
        acc = taom_gemm.taom_gemm_quantized(
            xq_.contiguous(), wq_.contiguous(), None, cfg, fs,
            block_m=block_m, block_d=block_d)
        return (acc * (sx_ * sw_)).to(x.dtype)

    def plain():
        return ref.photonic_gemm_reference(x, w, None, cfg, fs)

    want = plain()
    for route in (fused, f32_route):
        got = route()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (name, route.__name__, (
            got.float() - want.float()).abs().max().item())
    split = profile(fused, 20, "taom_gemm", split=taom_gemm.KERNELS)
    assert split["kernel_launches_per_run"] == 2, split
    row = {"gemm": name, "m": m, "k": k, "d": d,
           "chunks": -(-k // cfg.dpe_size), "dtype": str(x.dtype)[6:],
           "plan": {key: taom_gemm.int8_plan(m, k, d, cfg.dpe_size,
                                             block_d)[key]
                    for key in ("width", "warps", "tile_m", "grid")},
           "fused_ms": device_ms(fused),
           "split_ms": split["split_ms_per_run"],
           "f32_route_ms": device_ms(f32_route),
           "f32_body_ms": device_ms(f32_body),
           "plain_ms": device_ms(plain),
           "matmul_ms": device_ms(lambda: torch.matmul(x, w)),
           "fused_call_ms": call_ms(fused),
           "f32_route_call_ms": call_ms(f32_route)}
    if unaligned:
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        x_off = buf[1:].view(m, k).copy_(x)
        assert x_off.data_ptr() % 16
        sync = lambda: taom_gemm.taom_gemm_fused(             # noqa: E731
            x_off, w, None, cfg, fs, block_m=block_m, block_d=block_d)
        assert torch.equal(sync(), want), name
        row["fused_sync_ms"] = device_ms(sync)
    row.update(taom_bound(m, k, d, x.element_size()))
    log("[kernel] {gemm} M={m} K={k} D={d} C={chunks} {dtype} plan={plan}: "
        "fused_ms={fused_ms:.5f} (split {split_ms}) f32_route_ms="
        "{f32_route_ms:.5f} (f32 body alone {f32_body_ms:.5f}) plain_ms="
        "{plain_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
        "library_ms(torch.matmul, the nearest single PyTorch call, not "
        "the same function)={matmul_ms:.5f} (device times, CUDA graph "
        "replay); per eager call: fused {fused_call_ms:.5f} f32 route "
        "{f32_route_call_ms:.5f}".format(**row))
    if unaligned:
        log(f"[kernel] {name}: fused route on x one element off a 16-byte "
            f"boundary (synchronous loads, no cp.async for x): "
            f"{row['fused_sync_ms']:.5f} ms")
    return row


def ssd_bound(bh: int, l: int, p: int, s: int, q: int) -> dict:
    """Least time for one SSD scan: each input read once, each output
    written once (bytes), and the chunked algorithm's float32 flops with
    the scores and their product with x over the causal triangle s <= t
    only (the rest is masked to 0), plus the inter-chunk product and the
    carry."""
    nbytes = 4 * bh * (l * (2 * p + 1 + 2 * s) + p * s)
    tri = q * (q + 1) // 2
    flops = bh * (l // q) * (2 * tri * (s + p) + 4 * q * p * s)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def ssd_phase(dev) -> dict:
    """Phase 4: the SSD kernel against its plain version, then timed."""
    import torch
    from repro_torch.kernels import ops, ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def inputs(bh, l, p, s, decay=1.0):
        x = torch.randn((bh, l, p), generator=gen, device=dev)
        dt = torch.logaddexp(torch.randn((bh, l), generator=gen, device=dev),
                             torch.zeros((), device=dev))
        a = -decay * torch.exp(torch.randn((bh,), generator=gen, device=dev))
        b = torch.randn((bh, l, s), generator=gen, device=dev)
        c = torch.randn((bh, l, s), generator=gen, device=dev)
        return x, dt, a, b, c

    max_err = 0.0
    for bh, l, p, s, q, decay in SSD_SHAPES:
        args = inputs(bh, l, p, s, decay)
        got = ops.ssd_scan(*args, chunk=q, impl="kernel")
        want = ops.ssd_scan(*args, chunk=q, impl="ref")
        torch.cuda.synchronize()
        for name, g, w in zip(("y", "state"), got, want):
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            ok = (torch.allclose(g, w, rtol=SSD_TOL, atol=SSD_TOL * scale)
                  and bool(torch.isfinite(g).all()))
            log(f"[ssd] BH={bh} L={l} P={p} S={s} Q={q} a*{decay:g} {name}: "
                f"max |kernel - plain| = {err:.3e} (max |plain| "
                f"{scale:.3e}; rtol {SSD_TOL}, atol {SSD_TOL} * max|plain|)")
            assert ok, (bh, l, p, s, q, decay, name, err, scale)
            max_err = max(max_err, err)
    bh, l, p, s, q, _ = SSD_SHAPES[0]
    args = inputs(bh, l, p, s)
    kernel = lambda: ssd_scan.ssd_scan_chunked(*args, chunk=q)  # noqa: E731
    plain = lambda: ops._ssd_chunked(*args, q)                  # noqa: E731
    row = {"max_abs_err": max_err,
           "ms": device_ms(kernel, iters=10, replays=5),
           "plain_ms": device_ms(plain, iters=5, replays=4),
           **ssd_bound(bh, l, p, s, q)}
    log("[ssd] BH={} L={} P={} S={} Q={}: kernel_ms={ms:.5f} "
        "plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}; "
        "bytes {bytes_ms:.5f}, operations {ops_ms:.5f}) per call of the "
        "three kernels (device times, CUDA graph replay); library_ms: none "
        "(no single PyTorch call computes the scan)".format(bh, l, p, s, q,
                                                            **row))
    split = profile(kernel, 20, "ssd_scan", split=ssd_scan.KERNELS)
    assert split["kernel_launches_per_run"] == len(ssd_scan.KERNELS), split
    row["split_ms"] = split["split_ms_per_run"]
    row["profiled_ms"] = split["kernel_ms_per_run"]
    log(f"[ssd] per-kernel device ms per call (torch.profiler, 20 eager "
        f"calls; {row['profiled_ms']:.5f} ms together): " +
        json.dumps(row["split_ms"], sort_keys=True))
    blocks = {w: ssd_scan.occupancy(w) for w in (p, 128)}
    workspace = 4 * ssd_scan.workspace_floats(bh, l, p, s, q)
    log(f"[ssd] resident blocks an SM (cudaOccupancyMaxActiveBlocksPer"
        f"Multiprocessor) by head width: " + json.dumps(blocks, sort_keys=True)
        + f"; workspace {workspace} bytes at the served shape")
    return row


def lm_phase(dev) -> dict:
    """Phase 5: mamba2-130m served at its full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import Backend, PhotonicConfig
    from repro_torch.kernels import ssd_scan, taom_gemm
    from repro_torch.launch.serve import serve
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.layers import PhotonicCtx

    cfg = get_config(LM_ARCH)
    seed = 0
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(5))

    # The launch split: one SSD launch per layer in the prefill, none in
    # decode.
    params = zoo.init_params(cfg, seed, dev)
    caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    ssd_scan.LAUNCHES = 0
    logits, state = zoo.prefill_fn(params, {"tokens": prompts.to(dev)}, cfg,
                                   caches, ssm_impl="kernel")
    torch.cuda.synchronize()
    in_prefill = ssd_scan.LAUNCHES
    tok = logits[:, -1].float().argmax(-1)[:, None]
    for i in range(3):
        assert bool(torch.isfinite(logits).all()), i
        logits, state = zoo.decode_fn(params, tok, LM_PROMPT + i, cfg, state)
        tok = logits[:, -1].float().argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert logits.shape == (LM_BATCH, 1, cfg.vocab_size), logits.shape
    in_decode = ssd_scan.LAUNCHES - in_prefill
    assert in_prefill == cfg.num_layers and in_decode == 0, (in_prefill,
                                                             in_decode)
    log(f"[mamba] SSD wrapper launches: {in_prefill} in one prefill "
        f"({cfg.num_layers} layers), {in_decode} in 3 decode steps; "
        f"bf16 logits finite")

    # float32 copy of the config: the kernel's prefill + 4 decode steps
    # against the plain version's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = zoo.init_params(cfg32, seed, dev)
    runs = {}
    for impl in ("kernel", "ref"):
        caches = zoo.init_caches(cfg32, LM_BATCH, LM_PROMPT + 4, device=dev)
        lg, st = zoo.prefill_fn(params32, {"tokens": prompts.to(dev)}, cfg32,
                                caches, ssm_impl=impl)
        outs = [(lg, st)]
        tok = lg[:, -1].argmax(-1)[:, None]
        for i in range(4):
            lg, st = zoo.decode_fn(params32, tok, LM_PROMPT + i, cfg32, st)
            outs.append((lg, st))
            tok = lg[:, -1].argmax(-1)[:, None]
        runs[impl] = outs
    f32_err = 0.0
    for step, ((lk, sk), (lr, sr)) in enumerate(zip(runs["kernel"],
                                                    runs["ref"])):
        pairs = [("logits", lk, lr)] + [
            (key, sk["layers"]["mamba"][key], sr["layers"]["mamba"][key])
            for key in ("conv", "ssm")]
        for name, g, w in pairs:
            assert bool(torch.isfinite(g).all()), (step, name)
            rel = (g - w).abs().max().item() / w.abs().max().item()
            f32_err = max(f32_err, rel)
            assert rel <= SSD_TOL, (step, name, rel)
    log(f"[mamba] float32 config, prefill + 4 decode steps: kernel vs "
        f"plain SSD max |diff| / max |plain| = {f32_err:.3e} over logits "
        f"and both caches (tolerance {SSD_TOL})")
    del params32, runs

    # Photonic ctx: the TAOM kernel on the LM's GEMMs (K up to d_inner).
    pcfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                          noise_enabled=False)
    k_max = cfg.ssm.expand * cfg.d_model
    assert pcfg.qmax ** 2 * k_max < EXACT_LIMIT, (pcfg.qmax, k_max)
    phot = {}
    for impl in ("kernel", "ref"):
        caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT, device=dev)
        taom_gemm.LAUNCHES = 0
        phot[impl] = zoo.prefill_fn(params, {"tokens": prompts.to(dev)}, cfg,
                                    caches,
                                    ctx=PhotonicCtx(cfg=pcfg, impl=impl),
                                    ssm_impl="kernel")
        torch.cuda.synchronize()
        want = 2 * cfg.num_layers if impl == "kernel" else 0
        assert taom_gemm.LAUNCHES == want, (impl, taom_gemm.LAUNCHES)
    (lk, sk), (lr, sr) = phot["kernel"], phot["ref"]
    assert torch.equal(lk, lr), (lk.float() - lr.float()).abs().max().item()
    for key in ("conv", "ssm"):
        assert torch.equal(sk["layers"]["mamba"][key],
                           sr["layers"]["mamba"][key]), key
    layer = params["mamba"]["stack"]["mamba"]
    shapes = [(LM_BATCH * LM_PROMPT,) + tuple(layer[key]["w"].shape[-2:])
              for key in ("in_proj", "out_proj")]
    assert shapes == [row[1:] for row in TAOM_LM_SHAPES], shapes
    log(f"[mamba] photonic ctx (HEANA, 6-bit, N=83, noise off) prefill of "
        f"{tuple(prompts.shape)} tokens: bit-equal between the TAOM kernels "
        f"({2 * cfg.num_layers} wrapper calls, (M, K, D) {shapes}) and "
        f"the plain version (|psum| <= {pcfg.qmax}^2 * 83 < 2^24)")

    # Profile of one photonic prefill through the TAOM kernels (the fused
    # int8 route: two kernels a GEMM).
    def photonic_prefill():
        caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT, device=dev)
        zoo.prefill_fn(params, {"tokens": prompts.to(dev)}, cfg, caches,
                       ctx=PhotonicCtx(cfg=pcfg, impl="kernel"),
                       ssm_impl="kernel")

    photonic = profile(photonic_prefill, 3, "taom_gemm",
                       split=taom_gemm.KERNELS)
    assert photonic["kernel_launches_per_run"] == 4 * cfg.num_layers, (
        photonic)
    log("[mamba] one photonic prefill under torch.profiler (3 runs): " +
        json.dumps(photonic, sort_keys=True))
    log(f"[mamba] photonic prefill: TAOM route "
        f"{photonic['kernel_ms_per_run']:.5f} ms "
        f"({photonic['kernel_share_of_device_busy']:.1%} of "
        f"{photonic['device_busy_ms_per_run']:.3f} ms device busy; "
        f"{photonic['kernel_launches_per_run']:g} kernels)")

    # Profile of one bf16 prefill (the served one, kernel SSD).
    def prefill():
        caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                                 device=dev)
        zoo.prefill_fn(params, {"tokens": prompts.to(dev)}, cfg, caches,
                       ssm_impl="kernel")

    prefill()
    split = profile(prefill, 3, "ssd_scan", split=ssd_scan.KERNELS)
    log("[mamba] one prefill under torch.profiler (3 runs): " +
        json.dumps(split, sort_keys=True))
    kernels = len(ssd_scan.KERNELS) * cfg.num_layers
    assert split["kernel_launches_per_run"] == kernels, split
    log(f"[mamba] the profiler counts {split['kernel_launches_per_run']:g} "
        f"ssd_scan kernels a prefill ({len(ssd_scan.KERNELS)} per wrapper "
        f"call x {cfg.num_layers} layers)")
    step = profile(lambda: zoo.decode_fn(params, tok, LM_PROMPT + 3, cfg,
                                         state), 3, "ssd_scan")
    log("[mamba] one decode step under torch.profiler (3 runs): " +
        json.dumps(step, sort_keys=True))
    del params

    # The main path: serve() end to end; the warm-up call pays one-time
    # costs (cuBLAS handles, allocator growth).
    serve(LM_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
          gen=LM_GEN, seed=seed, device=dev)
    ssd_scan.LAUNCHES = taom_gemm.LAUNCHES = 0
    res = serve(LM_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
                gen=LM_GEN, seed=seed, device=dev)
    launches = ssd_scan.LAUNCHES
    # Exact numerics: the TAOM kernel is not on this path.
    assert launches == cfg.num_layers and taom_gemm.LAUNCHES == 0, (
        launches, taom_gemm.LAUNCHES)
    toks = res.tokens
    assert toks.shape == (LM_BATCH, LM_PROMPT + LM_GEN), toks.shape
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"[mamba] serve({LM_ARCH}, batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"gen {LM_GEN}): prefill {res.prefill_s * 1e3:.3f} ms, decode "
        f"{res.decode_s * 1e3:.3f} ms for {LM_GEN - 1} steps "
        f"({res.tokens_per_s:.1f} tokens/s), host clock, synchronized; "
        f"{launches} SSD wrapper calls")
    return {"launches": launches, "profile": split, "photonic": photonic}


def flash_bound(bh: int, s: int, d: int, causal: bool, window: int,
                elt_bytes: int) -> dict:
    """Least time for one flash-attention call: q, k, v read once and o
    written once (bytes); and 4 D flops per (query, key) pair the mask
    lets through (Q K^T and P V; masked pairs need no work), over the
    card's rate for the inputs' type: bf16 on the tensor cores, float32
    on the CUDA cores.  ``f32_floor_ms`` is the same flops at the float32
    CUDA-core rate, the least time for the kernel's float32 instance,
    which computes there."""
    pairs = sum((qi + 1 if causal else s) -
                (max(0, qi - window + 1) if window else 0)
                for qi in range(s))
    flops = 4.0 * bh * d * pairs
    bytes_ms = 4.0 * bh * s * d * elt_bytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOPS_PER_S if elt_bytes == 2 else F32_FLOPS_PER_S
    ops_ms = flops / rate * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "f32_floor_ms": flops / F32_FLOPS_PER_S * 1e3,
            "gflop": flops / 1e9, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def bf16_ulp(x: float) -> float:
    """One bf16 ulp in the binade of x (> 0): 2^(floor(log2 x) - 7)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def flash_phase(dev) -> dict:
    """Phase 6: the flash-attention kernel against its plain version, then
    timed beside its bound and PyTorch's SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)

    def inputs(bh, s, d, dtype):
        return [torch.randn((bh, s, d), generator=gen, device=dev)
                .to(getattr(torch, dtype)) for _ in range(3)]

    max_err = 0.0
    for bh, s, d, causal, window, dtype in FLASH_SHAPES:
        q, k, v = inputs(bh, s, d, dtype)
        before = flash_attention.LAUNCHES
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="kernel")
        want = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   impl="ref")
        torch.cuda.synchronize()
        assert flash_attention.LAUNCHES == before + 1
        assert got.dtype == q.dtype and got.shape == q.shape
        assert bool(torch.isfinite(got).all())
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == "float32":
            tol = f"rtol {FLASH_TOL}, atol {FLASH_TOL} * max|plain|"
            ok = torch.allclose(got, want, rtol=FLASH_TOL,
                                atol=FLASH_TOL * scale)
        else:
            tol = f"one bf16 ulp of max|plain| = {bf16_ulp(scale):.3e}"
            ok = err <= bf16_ulp(scale)
        log(f"[flash] BH={bh} S={s} D={d} causal={causal} window={window} "
            f"{dtype}: max |kernel - plain| = {err:.3e} (max |plain| "
            f"{scale:.3e}; {tol})")
        assert ok, (bh, s, d, causal, window, dtype, err, scale)
        max_err = max(max_err, err)

    bh, s, d, causal, window, dtype = FLASH_SHAPES[0]
    q, k, v = inputs(bh, s, d, dtype)
    kernel = lambda: flash_attention.flash_attention_fwd(  # noqa: E731
        q, k, v, causal=causal)
    plain = lambda: ops._flash_blocked(q, k, v, causal)     # noqa: E731
    # SDPA on the same tensors viewed as (batch, heads, S, D), the layout
    # its fused kernels take (3-D input sends it to its unfused path).
    q4, k4, v4 = (t.view(LM_BATCH, bh // LM_BATCH, s, d) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(          # noqa: E731
        q4, k4, v4, is_causal=True)
    lib_err = (sdpa().reshape(bh, s, d).float() -
               plain().float()).abs().max().item()
    q32, k32, v32 = (t.float() for t in (q, k, v))
    kernel32 = lambda: flash_attention.flash_attention_fwd(  # noqa: E731
        q32, k32, v32, causal=causal)
    row = {"max_abs_err": max_err,
           "ms": device_ms(kernel, iters=20, replays=5),
           "plain_ms": device_ms(plain, iters=5, replays=4),
           "library_ms": device_ms(sdpa, iters=20, replays=5),
           "f32_ms": device_ms(kernel32, iters=10, replays=5),
           **flash_bound(bh, s, d, causal, window, 2)}
    log("[flash] BH={} S={} D={} causal bf16: kernel_ms={ms:.5f} "
        "plain_ms={plain_ms:.5f} library_ms(scaled_dot_product_attention)="
        "{library_ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}; bytes "
        "{bytes_ms:.5f}, bf16 tensor-core operations {ops_ms:.5f}, float32 "
        "CUDA-core floor {f32_floor_ms:.5f}, {gflop:.3f} GFLOP) per launch; "
        "float32 kernel_ms={f32_ms:.5f} (device times, CUDA graph replay)"
        .format(bh, s, d, **row))
    log(f"[flash] SDPA vs plain at that shape: max |diff| = {lib_err:.3e}")
    row["sdpa_ratio"] = row["ms"] / row["library_ms"]
    row["tflops"] = row["gflop"] / row["ms"]       # GFLOP per ms
    log("[flash] bf16 kernel / SDPA = {sdpa_ratio:.3f}; the kernel computes "
        "the function's {gflop:.3f} GFLOP at {tflops:.1f} TFLOP/s ({share:.1%}"
        " of the 989 TFLOP/s bf16 peak; the P split adds half again on the "
        "tensor cores)".format(share=row["tflops"] * 1e12 / BF16_FLOPS_PER_S,
                               **row))
    # The windowed bf16 heads (h2o-danube3, gemma3): two and four 64-column
    # atoms, the other instances of the kernel.
    for bh, s, d, causal, window, dtype in FLASH_SHAPES[2:4]:
        q, k, v = inputs(bh, s, d, dtype)
        ms = device_ms(lambda: flash_attention.flash_attention_fwd(
            q, k, v, causal=causal, window=window), iters=10, replays=5)
        b = flash_bound(bh, s, d, causal, window, 2)
        log(f"[flash] BH={bh} S={s} D={d} window={window} bf16: kernel_ms="
            f"{ms:.5f} bound_ms={b['bound_ms']:.5f} ({b['bound_by']}), "
            f"{b['gflop'] / ms:.1f} TFLOP/s (device time, CUDA graph replay)")
    return row


def qwen_phase(dev) -> dict:
    """Phase 7: qwen2-0.5b served at its full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan, taom_gemm
    from repro_torch.launch.serve import serve
    from repro_torch.models import model_zoo as zoo

    cfg = get_config(QWEN_ARCH)
    seed = 0
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(7))

    def counts():
        return (flash_attention.LAUNCHES, ssd_scan.LAUNCHES,
                taom_gemm.LAUNCHES)

    # The launch split: one flash launch per layer in the prefill (the
    # default attn_impl, 'auto'), none in decode.
    params = zoo.init_params(cfg, seed, dev)
    caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                             torch.bfloat16, dev)
    flash_attention.LAUNCHES = ssd_scan.LAUNCHES = taom_gemm.LAUNCHES = 0
    logits, state = zoo.prefill_fn(params, {"tokens": prompts.to(dev)}, cfg,
                                   caches)
    torch.cuda.synchronize()
    in_prefill = counts()
    tok = logits[:, -1].float().argmax(-1)[:, None]
    for i in range(3):
        assert bool(torch.isfinite(logits).all()), i
        logits, state = zoo.decode_fn(params, tok, LM_PROMPT + i, cfg, state)
        tok = logits[:, -1].float().argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    assert logits.shape == (LM_BATCH, 1, cfg.vocab_size), logits.shape
    in_decode = tuple(b - a for a, b in zip(in_prefill, counts()))
    assert in_prefill == (cfg.num_layers, 0, 0) and in_decode == (0, 0, 0), (
        in_prefill, in_decode)
    log(f"[qwen2] flash kernel launches: {in_prefill[0]} in one prefill "
        f"({cfg.num_layers} layers), {in_decode[0]} in 3 decode steps; "
        f"bf16 logits finite")

    # float32 copy of the config: the kernel's prefill + 4 decode steps
    # against the plain version's.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = zoo.init_params(cfg32, seed, dev)
    runs = {}
    for impl in ("kernel", "ref"):
        caches = zoo.init_caches(cfg32, LM_BATCH, LM_PROMPT + 4,
                                 torch.float32, dev)
        lg, st = zoo.prefill_fn(params32, {"tokens": prompts.to(dev)}, cfg32,
                                caches, attn_impl=impl)
        outs = [(lg, st)]
        tok = lg[:, -1].argmax(-1)[:, None]
        for i in range(4):
            lg, st = zoo.decode_fn(params32, tok, LM_PROMPT + i, cfg32, st)
            outs.append((lg, st))
            tok = lg[:, -1].argmax(-1)[:, None]
        runs[impl] = outs
    f32_err = 0.0
    for step, ((lk, sk), (lr, sr)) in enumerate(zip(runs["kernel"],
                                                    runs["ref"])):
        body_k, body_r = sk["layers"]["body"], sr["layers"]["body"]
        assert torch.equal(body_k["pos"], body_r["pos"]), step
        for name, g, w in (("logits", lk, lr), ("k", body_k["k"], body_r["k"]),
                           ("v", body_k["v"], body_r["v"])):
            assert bool(torch.isfinite(g).all()), (step, name)
            rel = (g - w).abs().max().item() / w.abs().max().item()
            f32_err = max(f32_err, rel)
            assert rel <= SSD_TOL, (step, name, rel)
    log(f"[qwen2] float32 config, prefill + 4 decode steps: kernel vs "
        f"plain flash attention max |diff| / max |plain| = {f32_err:.3e} "
        f"over logits and the KV caches (tolerance {SSD_TOL})")
    del params32, runs

    # Profile of one bf16 prefill (the served one) and one decode step.
    def prefill():
        caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                                 torch.bfloat16, dev)
        zoo.prefill_fn(params, {"tokens": prompts.to(dev)}, cfg, caches)

    prefill()
    split = profile(prefill, 3, "flash_attention_fwd_kernel")
    log("[qwen2] one prefill under torch.profiler (3 runs): " +
        json.dumps(split, sort_keys=True))
    step = profile(lambda: zoo.decode_fn(params, tok, LM_PROMPT + 3, cfg,
                                         state), 3,
                   "flash_attention_fwd_kernel")
    log("[qwen2] one decode step under torch.profiler (3 runs): " +
        json.dumps(step, sort_keys=True))
    del params, state

    # The main path: serve() end to end; the warm-up call pays one-time
    # costs (cuBLAS handles, allocator growth).
    serve(QWEN_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
          gen=LM_GEN, seed=seed, device=dev)
    flash_attention.LAUNCHES = ssd_scan.LAUNCHES = taom_gemm.LAUNCHES = 0
    res = serve(QWEN_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
                gen=LM_GEN, seed=seed, device=dev)
    launches = counts()
    # Exact numerics, attention only: neither the TAOM nor the SSD kernel
    # is on this path.
    assert launches == (cfg.num_layers, 0, 0), launches
    toks = res.tokens
    assert toks.shape == (LM_BATCH, LM_PROMPT + LM_GEN), toks.shape
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"[qwen2] serve({QWEN_ARCH}, batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"gen {LM_GEN}): prefill {res.prefill_s * 1e3:.3f} ms, decode "
        f"{res.decode_s * 1e3:.3f} ms for {LM_GEN - 1} steps "
        f"({res.tokens_per_s:.1f} tokens/s), host clock, synchronized; "
        f"{launches[0]} flash kernel launches")
    return {"launches": launches[0], "profile": split}


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
    from repro_torch.kernels import flash_attention, ref, ssd_scan, taom_gemm
    from repro_torch.models.zoo_cnn import ZOO

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. build: one nvcc per source, started together ----------------------
    def timed_build(mod):
        t0 = time.perf_counter()
        lib, build_log = mod.build()
        return lib, build_log, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = list(pool.map(timed_build,
                               (taom_gemm, ssd_scan, flash_attention)))
    for lib, build_log, secs in builds:
        log(f"[build] {lib.name} in {secs:.1f} s")
        for line in build_log.splitlines():
            if any(w in line for w in ("properties for", "registers",
                                      "spill", "arning", "Performance")):
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

    # The fused int8 route (bits <= 7) against its plain version
    # (quantize, chunked GEMM, rescale): every plan shape and the photonic
    # LM's, both policies, noise on and off, float32 and bf16 x.
    fused_cases = sorted({(m, k, d, bd) for _, m, k, d, _, bd in path})
    fused_cases += [(512, k, d, 128) for _, _, k, d in TAOM_LM_SHAPES]
    n_fused = 0
    for m, k, d, bd in fused_cases:
        for backend in (Backend.HEANA, Backend.AMW):
            cfg = PhotonicConfig(backend=backend, bits=6, dpe_size=83,
                                 noise_enabled=True)
            assert cfg.qmax ** 2 * min(k, 83) < EXACT_LIMIT
            fs = taom_gemm.calibrated_adc_fs(k, cfg)
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                w = torch.randn((k, d), generator=gen, device=dev).to(dtype)
                for noise in (noise_for(cfg, m, k, d), None):
                    got = taom_gemm.taom_gemm_fused(x, w, noise, cfg, fs,
                                                    block_d=bd)
                    want = ref.photonic_gemm_reference(x, w, noise, cfg, fs)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    max_err = max(max_err, err)
                    assert err == 0.0, (m, k, d, backend, dtype, err)
                    n_fused += 1
    log(f"[kernel] fused int8 route: {n_fused} cases bit-equal to the "
        f"plain version (quantize, chunked GEMM, rescale)")

    # Times at the main path's shapes, tiles and config (6-bit HEANA,
    # noise off: no noise tensor is read, as on the path), then at the
    # photonic LM's (bf16, the default tile).
    rows = []
    for name, m, k, d, bm, bd in path:
        x = torch.randn((m, k), generator=gen, device=dev)
        w = torch.randn((k, d), generator=gen, device=dev)
        rows.append(taom_times(name, x, w, main_cfg, bm, bd))
    lm_rows = []
    for name, m, k, d in TAOM_LM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        w = torch.randn((k, d), generator=gen, device=dev).bfloat16()
        lm_rows.append(taom_times(name, x, w, main_cfg, 128, 128,
                                  unaligned=True))
    per_forward = {key: sum(r[key] for r in rows) for key in (
        "fused_ms", "f32_route_ms", "f32_body_ms", "plain_ms", "matmul_ms",
        "bound_ms", "bytes_ms", "ops_ms", "fused_call_ms",
        "f32_route_call_ms")}
    per_forward["split_ms"] = {part: sum(r["split_ms"][part] for r in rows)
                               for part in taom_gemm.KERNELS}
    log("[kernel] per batch-32 resnet_mini forward (13 GEMMs): " +
        json.dumps(per_forward, sort_keys=True))

    # -- 3. serving: the main path --------------------------------------------
    img_gen = torch.Generator(device=dev)
    img_gen.manual_seed(2)
    sizes = (1, 3, 17, 64, 100)
    requests = [torch.randn((n, *model.in_hw, model.in_ch), generator=img_gen,
                            device=dev) for n in sizes]
    taom_gemm.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0
    cold = engine.warmup()
    served = [engine.infer(x) for x in requests]
    torch.cuda.synchronize()
    launches = taom_gemm.LAUNCHES
    assert ssd_scan.LAUNCHES == flash_attention.LAUNCHES == 0, (
        ssd_scan.LAUNCHES, flash_attention.LAUNCHES)
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
    split = profile(lambda: engine.infer(x32), REQUESTS, "taom_gemm",
                    split=taom_gemm.KERNELS)
    log(f"[serving] bucket-32 request, {REQUESTS} runs: {wall_ms:.4f} ms "
        f"host clock unprofiled; per request under the profiler: " +
        json.dumps(split, sort_keys=True))
    assert split["kernel_launches_per_run"] == 2 * n_gemms, split
    log(f"[serving] {split['device_kernels_per_run']:g} device kernels per "
        f"bucket-32 request; the TAOM route's "
        f"{split['kernel_launches_per_run']:g} (2 per GEMM) take "
        f"{split['kernel_ms_per_run']:.5f} ms on the path (profiler; "
        f"absmax {split['split_ms_per_run']['taom_gemm_absmax']:.5f}, "
        f"int8 GEMM {split['split_ms_per_run']['taom_gemm_int8']:.5f}) vs "
        f"{per_forward['fused_ms']:.5f} ms in phase 2 (CUDA graph replay "
        f"at the same shapes and tiles)")

    # -- 4. SSD kernel vs plain version on the card ---------------------------
    ssd = ssd_phase(dev)

    # -- 5. mamba2-130m served at full width ----------------------------------
    lm = lm_phase(dev)

    # -- 6. flash-attention kernel vs plain version on the card ---------------
    flash = flash_phase(dev)

    # -- 7. qwen2-0.5b served at full width: this slice's path ---------------
    qwen = qwen_phase(dev)

    # -- 8. report ------------------------------------------------------------
    entry = {
        "name": "taom_gemm_quantized",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/taom_gemm.cu",
        "replaces": "src/repro/kernels/taom_gemm.py:120",
        "launches": launches,
        "max_abs_err": max_err,
        # Per resnet_mini forward at batch 32: the sum over its 13 GEMMs
        # at the plan's tiles of the fused int8 route (two kernels a GEMM;
        # split_ms by kernel from the profiler), device time (CUDA graph
        # replay); call_ms adds the host's cost of issuing each eager call;
        # path_ms is the profiler's time of the same 26 kernels inside
        # served requests.  f32_route_ms is the float32 body with PyTorch's
        # quantize and rescale around it (the route before this design,
        # and still 8-bit operands'); f32_body_ms that kernel alone.
        "ms": per_forward["fused_ms"],
        "split_ms": per_forward["split_ms"],
        "call_ms": per_forward["fused_call_ms"],
        "path_ms": split["kernel_ms_per_run"],
        "path_split_ms": split["split_ms_per_run"],
        "plain_ms": per_forward["plain_ms"],
        "bound_ms": per_forward["bound_ms"],
        "bound_by": ("bytes" if per_forward["bytes_ms"] >=
                     per_forward["ops_ms"] else "operations"),
        "f32_route_ms": per_forward["f32_route_ms"],
        "f32_body_ms": per_forward["f32_body_ms"],
        # No single PyTorch call computes this function (quantized GEMM
        # with per-chunk noise and ADC rounding).
        "library_ms": None,
        "matmul_ms": per_forward["matmul_ms"],
        "matmul_note": "torch.matmul of the same operands: the nearest "
                       "single PyTorch call, not the same function",
        "per": "one resnet_mini forward at batch 32 (13 GEMMs)",
        # The photonic mamba2-130m GEMMs, per call (bf16, M 4000).
        "lm": {r["gemm"]: {key: r[key] for key in (
            "m", "k", "d", "fused_ms", "split_ms", "fused_sync_ms",
            "f32_route_ms",
            "f32_body_ms", "plain_ms", "bound_ms", "bound_by")}
            for r in lm_rows},
        "lm_prefill_ms": lm["photonic"]["kernel_ms_per_run"],
    }
    bh, l, p, s, q, _ = SSD_SHAPES[0]
    ssd_entry = {
        "name": "ssd_scan_chunked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:81",
        "launches": lm["launches"],
        "max_abs_err": ssd["max_abs_err"],
        # Per wrapper call (three kernels) at the full-width shape, device
        # time (CUDA graph replay); split_ms is the profiler's time of each
        # kernel per call; path_ms is the profiler's SSD time in one served
        # prefill divided by its wrapper calls.
        "ms": ssd["ms"],
        "split_ms": ssd["split_ms"],
        "path_ms": lm["profile"]["kernel_ms_per_run"] / lm["launches"],
        "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"],
        # No single PyTorch call computes the SSD scan.
        "library_ms": None,
        "per": f"one call at BH={bh}, L={l}, P={p}, S={s}, Q={q} (one "
               f"{LM_ARCH} layer's prefill at batch {LM_BATCH}, prompt "
               f"{LM_PROMPT} padded to {l})",
    }
    bh, s, d, causal, window, dtype = FLASH_SHAPES[0]
    flash_entry = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:75",
        "launches": qwen["launches"],
        "max_abs_err": flash["max_abs_err"],
        # Per launch at qwen2-0.5b's served shape in bf16, device time
        # (CUDA graph replay); path_ms is the profiler's flash time in one
        # served prefill divided by its launches; library_ms is PyTorch's
        # scaled_dot_product_attention on the same tensors (never called
        # by the port).
        "ms": flash["ms"],
        "path_ms": (qwen["profile"]["kernel_ms_per_run"] /
                    qwen["profile"]["kernel_launches_per_run"]),
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "f32_floor_ms": flash["f32_floor_ms"],
        "float32_ms": flash["f32_ms"],
        "library_ratio": flash["sdpa_ratio"],
        "tflops": flash["tflops"],
        "per": f"one launch at BH={bh} ({LM_BATCH} x 16 padded heads), "
               f"S={s}, D={d}, causal, {dtype} (one {QWEN_ARCH} layer's "
               f"prefill at batch {LM_BATCH}, prompt {LM_PROMPT})",
    }
    print(json.dumps({"kernels": [entry, ssd_entry, flash_entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

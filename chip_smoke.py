#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --dist-serving   # phase 14(c) alone, every card

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
                max_batch 64) warms up — capturing each of its 7 buckets'
                forwards in a CUDA graph (``executor.compiled_forward``;
                the memory the graphs hold is printed) — and serves
                requests of 1, 3, 17, 64 and 100 images by graph replay;
                the logits must equal the eager plain-version path
                (``execute_cnn(impl="ref", compiled=False)``) bit for bit,
                7 captures and ``retraces_since_warmup == 0``; the TAOM
                wrapper must have been called 26 times per bucket at
                warmup (eager warm run + capture) and never by a replayed
                request; one noisy request served twice from one seed must
                be finite, identical and bit-equal to the eager forward
                from that seed; a MicroBatcher coalesces 64 single-image
                submits (and, queued before it starts, resolves them
                bit-equal to the rows of one 64-image request); then
                bucket-32 requests on the host clock and under
                ``torch.profiler`` (the device's busy time by
                kernel, its idle share, kernels per request, the TAOM
                route's two kernels per GEMM, which the profiler sees
                inside a graph), graphed beside the eager forward;
  4. ssd      — hold the SSD scan's three kernels (chunk state, state
                pass, chunk out) against their plain PyTorch version
                (``ops._ssd_chunked``) on the card within rtol 1e-4 and
                atol 1e-4 * max|plain|: the mamba2-130m width (BH 96, L
                1024, P 64, S 128, Q 128), the smoke config's (P 16, S 16,
                Q 8), zamba2's (P 64, S 64), a ragged L (1000) through
                ``ops.ssd_scan``, the largest head (P 128), Q 100, a single
                chunk (L == Q), a fast decay (a ~ -30) and zamba2-7b's
                served prefill (BH 448, L 1000, P 64, S 64); then time the
                kernels and the plain version at zamba2's served shape and
                at the full mamba2 width (CUDA graph replay) beside the
                bound, split the kernels' time by kernel (torch.profiler),
                and print each kernel's resident blocks an SM and the
                workspace's bytes;
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
                busy, the TAOM route's share, 96 kernels); a profile of one
                prefill and one eager decode step; one decode step
                captured in a CUDA graph (``launch/serve.DecodeGraph``:
                capture time, memory held, a replay's host clock and
                profile; a prefill's host clock after nothing, first
                after one more capture and first after emptying the
                allocator's cache, over five interleaved rounds);
                then ``serve()`` (prefill, the step's capture,
                15 graph replays) on the host clock, its greedy tokens
                equal to an eager decode loop's;
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
                h2o-danube3's and gemma3's shapes; then the served prefill
                shapes of phases 8-10 (zamba2-7b: BH 128, S 1000, D 112,
                causal; llava: BH 64, S 3072, D 128, causal; whisper's
                encoder: BH 24, S 1500, D 64, non-causal), each held in
                bf16 and timed with the plain version and SDPA beside the
                bound; and deepseek-v2-236b's MLA prefill (BH 512 = batch 4
                x 128 heads, S 1000, D 192 = nope 128 + rope 64, causal;
                the bound and SDPA on the function's V width, 128, the
                kernel on V zero-padded to 192 as the model pads it);
  7. qwen2    — serve qwen2-0.5b at its full width through
                ``launch/serve.serve`` (24 layers, d_model 896, 14 of 16
                padded heads, GQA over 2 KV heads, QKV bias, seeded random
                bf16 weights, batch 4, prompt 1000, 16 greedy tokens):
                tokens in range, the flash kernel launched once per layer
                in the prefill and never in decode; in a float32 copy of
                the config the kernel's prefill and 4 decode steps agree
                with the plain version's (logits and KV caches within 1e-4
                of max|plain|); a profile of one prefill and one eager
                decode step; a decode step as a CUDA graph and ``serve()``
                as in phase 5, its greedy tokens equal to eager ones;
  8-10.       — serve zamba2-7b (81 mamba layers + one shared attention
  families      block every 6: 13 superblocks and a tail of 3; d_model
                3584, 32 heads of 112, state 64; batch 4, prompt 1000),
                llava-next-mistral-7b (32 layers, d_model 4096, GQA 32:8,
                D 128, 2880 image positions of zero patches + 192 text;
                batch 2, prompt 3072) and whisper-tiny (4 + 4 layers,
                d_model 384, 6 heads unpadded, 1500 zero frames; batch 4,
                prompt 64) at full width through ``launch/serve.serve``
                (seeded random bf16 weights, 16 greedy tokens), one model
                at a time: the launch counts of the whole call (counts set
                to 0 just before it) — SSD wrapper 81 and flash 13 for
                zamba2, flash 32 for llava, flash 8 (4 non-causal) for
                whisper — tokens in range; the params drawn again (host
                clock timed), an eager decode loop's greedy tokens equal
                to serve()'s graphed ones, with the launches split between
                its prefill and its decode steps (none there); profiles of
                a prefill and an eager decode step, the decode step as a
                CUDA graph (capture, memory, replay; for whisper, halving
                the graph's static enc_out moves its logits and restoring
                it gives them back bit for bit); a float32 copy cut in
                depth (zamba2: one superblock + its tail; llava: 2 layers;
                whisper whole) whose prefill (llava with seeded random
                patches) + 4 decode steps with the kernels agree with the
                plain versions within 1e-4 of max|plain| (logits and every
                state leaf); a 6-bit HEANA photonic prefill of the cut at
                M = 512 rows bit-equal between the TAOM kernels and their
                plain version;
  11. moe     — serve deepseek-v2-236b at its full width (d_model 5120,
                128 heads, MLA kv_lora 512 / q_lora 1536 / rope 64 / nope
                128 / v 128, 160 routed experts of 1536 with top-6 and 2
                shared) cut in depth to 1 dense + 2 MoE layers (~9.3 G
                parameters, bf16, seeded random; ``serve(repeats=...)``),
                batch 4, prompt 1000, 16 greedy tokens, as phases 8-10:
                flash 3 in the prefill, none in decode, no SSD or TAOM
                launch; eager greedy tokens equal to graphed; profiles and
                the decode graph.  Then a float32 cut (1 dense + 1 MoE
                layer; the served params' first layers in float32) held
                sublayer by sublayer, kernel route against plain route,
                each fed the plain route's input: outputs within 1e-4 of
                max|plain| on every token whose routing (top-k set, kept
                experts) agrees, every token whose routing differs a
                near-tie of the plain run (the k-th and (k+1)-th
                probabilities within 1e-5 of the k-th; counted and
                printed), ckv and kr within 1e-4, pos equal; and a 6-bit
                HEANA photonic prefill of that cut in bf16 at M = 512
                (attention on the dense route on both sides, 9 TAOM calls
                a layer) bit-equal between the TAOM kernels and their
                plain version.  With v2's params freed, deepseek-v3-671b
                (d_model 7168, 128 heads, the same MLA widths, 256 routed
                experts of 2048 with top-8 and 1 shared; the MTP head
                drawn, not run when serving) cut to 1 dense + 1 MoE layer
                (~14.6 G parameters, ~29 GB in bf16), served as v2 (batch
                4, prompt 1000, 16 greedy tokens: flash 2 in the prefill,
                graphed tokens equal to eager, profiles, the decode graph),
                with the memory held and the routing of one served prefill
                (near-ties, dropped slots) printed;
  12. train   — train through ``launch/train.train`` on the card:
                mamba2-130m at its full width (seeded random bf16 weights,
                20 steps of batch 8 x seq 256 on the synthetic pipeline,
                remat on, checkpoints at steps 10 and 20): the loss falls,
                the warm step's host time, tokens/s and peak memory, no
                kernel of the port launched (under grad the SSD scan takes
                its plain route); step 10's checkpoint restored into a new
                run reproduces steps 10-19's losses and the final params
                bit for bit; one more step profiled (device busy, idle
                share, kernels), every param leaf's gradient finite and
                the SSD's upstream weights' (in_proj, conv_w, a_log,
                dt_bias) non-zero.  C1: a 2-layer float32 cut's gradients
                through ``transformer.forward`` under the default routes
                bit-equal to the plain routes', and ssm_impl='kernel'
                under grad raising.  Photonic QAT (photonic_heana: 8-bit
                HEANA, N 128), 5 steps: 480 TAOM launches (the forward's
                48 photonic GEMMs and the remat recompute's, a step),
                losses and final params bit-equal to impl='ref'; the TAOM
                kernel timed at QAT's two GEMM shapes beside the bound.
                qwen2-0.5b at its full width, 5 steps: loss, step time,
                peak memory, one more step profiled;
  13. examples — the ten ``examples_torch`` scripts on the card, each
                imported from that folder and called through
                ``main(argv)`` with the launch counts set to 0 just before
                it (nothing caught):
                quickstart (TAOM and flash launched; the TAOM kernel ==
                its oracle), the five CNN scripts (TAOM launched, no SSD or
                flash; autoflow bit-exact, zoo's four networks
                conformant, the engine's and the stream's zero
                recaptures, operating_point coherent), heana_cnn_inference
                (150 SGD steps with the loss falling, then evaluate for
                exact, int8, heana and maw: 12 TAOM launches; the four
                top-1s and drops), serve_lm --full for qwen2-0.5b (flash
                24) and mamba2-130m (SSD 24), train_lm at full width for 3
                steps and resumed for 3 more from its checkpoint (no
                kernel under grad), photonic_qat cut to 20 steps (TAOM
                launched); each script's host-clock seconds.  While a
                script runs, the first call of each kernel wrapper at each
                distinct signature keeps copies of its inputs and output;
                after it, each is held against the plain version on the
                same inputs (TAOM bit-equal, SSD within 1e-4 of max|plain|,
                flash within 1e-5 in float32 and one bf16 ulp of each query
                row's max|plain| in bf16), and every signature a CUDA graph
                captured must also have run eagerly.  Then the
                Table-4 columns on evaluate's 512 images (8 bits: the TAOM
                float32 body at N = 83, 2 and 1): the kernel route's logits
                bit-equal to impl='ref' with the same noise, each GEMM's
                largest integer sum beside 2^24, each GEMM timed against
                the plain route and the bound (operations at the bf16
                rate: 8-bit operands do not fit int8);
  14. dist    — distribution on torch.distributed (the card is one, so
                the paths run at world size 1 and in two processes on it):
                (a) a world of one over NCCL (``launch/mesh.
                make_local_mesh``), mesh (1, 1), qwen2-0.5b at full width
                (bf16, batch 4, prompt 1000): ``prefill_fn(dist)`` with
                the flash kernel (24 launches) and 16 greedy steps through
                ``decode_fn(dist)``, which takes ``flash_decode_gqa`` (360
                calls); a LOCAL run fed the same tokens: logits within
                2^-5 of max|LOCAL| (the tests' bf16 bound), read and held
                from the weights of seeds 0-3 (the greedy tokens LOCAL
                would pick otherwise are counted: the bound already holds
                them); in a float32 copy the greedy tokens equal LOCAL's
                and the logits are within 1e-4; decode steps timed (host clock) and profiled;
                one ``loss_fn(dist)`` step (8 x 256 tokens, the vocab-
                sharded CE) in float32 against LOCAL (loss rtol 1e-5,
                gradients 1e-4 of the largest), timed in bf16; then
                ``allreduce_compressed`` of those gradients over the group
                of one bit-equal to ``decompress(compress(g))``; and
                ``pipeline_forward`` at one stage equal to its layer.
                (b) two processes on the one card over gloo (NCCL takes
                one rank a card; if this gloo has no CUDA all-reduce the
                ranks copy through the host, and say so):
                deepseek-v2-236b's MoE layer at full width (d 5120, 160
                experts of 1536, top-6, 2 shared; seeded weights drawn on
                the card; batch 4 x 1000 tokens), experts split 80/80,
                every rank's all-reduced output bit-equal to the two
                shard bodies summed here; qwen2-0.5b's decode attention
                over 1016 slots split in 2, the ranks equal and within
                2^-7 of one rank's max; the sharded CE with qwen2's vocab
                split in 2 (float32, 8 x 256), loss within 1e-5 and
                gradients within 1e-4 of one rank's; each timed per rank.
                (c) ``ServingEngine(data_parallel=True, devices=[cuda,
                cuda])`` on resnet_mini (6-bit HEANA, noise off,
                max_batch 64): an 83-image request and 1, 3, 17 and 64
                bit-equal to the one-device engine and to the plain route
                (``execute_cnn(impl="ref", compiled=False)``), every TAOM
                call of the path (shard shapes, the pinned row) recorded
                and held bit-equal to its plain version, no capture after
                warmup; requests timed (host clock) and profiled beside
                the one-device engine.  ``--dist-serving`` runs (c) alone,
                over two entries of card 0 and then over every visible
                card;
  15. report  — the kernels' JSON line (each kernel's launches summed over
                the served, trained, example and distributed paths, and
                per path), the card's name and power limit, and the
                result line.

Needs one CUDA card and the repository around it (``src/repro_torch``);
imports neither JAX nor the reference package.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
EXAMPLES = os.path.join(ROOT, "examples_torch")

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
# a = -30 exp(N(0, 1)) (exp underflows inside a chunk), and zamba2-7b's
# served prefill (batch 4 x 112 heads, prompt 1000; also timed, padded to
# 1024 as ops.ssd_scan pads it).
SSD_SHAPES = ((96, 1024, 64, 128, 128, 1.0), (8, 64, 16, 16, 8, 1.0),
              (24, 512, 64, 64, 128, 1.0), (96, 1000, 64, 128, 128, 1.0),
              (4, 256, 128, 128, 128, 1.0), (4, 300, 64, 128, 100, 1.0),
              (8, 128, 64, 128, 128, 1.0), (96, 1024, 64, 128, 128, 30.0),
              (448, 1000, 64, 64, 128, 1.0))
ZAMBA_SSD = (448, 1024, 64, 64, 128)
QWEN_ARCH = "qwen2-0.5b"         # phase 7's model, at its full width
# Phase 11's model: deepseek-v2-236b at its full width, cut in depth to 1
# dense + 2 MoE layers (~9.3 G parameters, ~18.7 GB in bf16).
MOE_ARCH = "deepseek-v2-236b"
MOE_REPEATS = {"dense_head": 1, "moe_body": 2}
MOE_BATCH, MOE_PROMPT = 4, 1000
NEAR_TIE = 1e-5                  # phase 11's routing: a near-tie's gap
# Phase 11's second model: deepseek-v3-671b at its full width, cut in depth
# to 1 dense + 1 MoE layer (~14.6 G parameters with the MTP head, which is
# drawn and not run when serving; ~29 GB in bf16), served after v2's params
# are freed.
MOE_V3_ARCH = "deepseek-v3-671b"
MOE_V3_REPEATS = {"dense_head": 1, "moe_body": 1}
# Phases 8-10's models at their full widths: (tag, arch, batch, prompt).
FAMILIES = (("zamba2", "zamba2-7b", 4, 1000),
            ("llava", "llava-next-mistral-7b", 2, 3072),
            ("whisper", "whisper-tiny", 4, 64))
# Phase 12's training runs: mamba2-130m at its full width (as the
# reference's examples/train_lm.py trains it), batch 8 x seq 256 tokens a
# step, bf16 as configured; photonic QAT at photonic_heana (8-bit HEANA, N
# 128: the TAOM kernel's float32 body); qwen2-0.5b for the dense family.
TRAIN_ARCH = "mamba2-130m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, QAT_STEPS = 8, 256, 20, 5
DENSE_TRAIN_ARCH, DENSE_TRAIN_STEPS = "qwen2-0.5b", 5
# Weights the SSD scan's gradient has to reach (C1: a forward-only kernel
# under grad would leave them without one).
SSD_UPSTREAM = ("in_proj", "conv_w", "a_log", "dt_bias")
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
# The served prefills of phases 8-11 give the kernel five more shapes,
# each held against the plain version in bf16 and timed beside SDPA:
# (batch, heads, S, D, causal, the function's V width) — zamba2-7b's
# shared block (D 112), llava-next-mistral-7b's layers (D 128, K and V
# expanded from 8 to 32 heads), whisper-tiny's encoder (non-causal over
# 1500 frames) and its decoder's prompt (causal, 64 tokens), and
# deepseek-v2-236b's MLA (one head of nope 128 + rope 64 = 192, V of 128
# zero-padded to 192 for the kernel).
FAMILY_FLASH = ((4, 32, 1000, 112, True, 112), (2, 32, 3072, 128, True, 128),
                (4, 6, 1500, 64, False, 64), (4, 6, 64, 64, True, 64),
                (4, 128, 1000, 192, True, 128))
FLASH_SHAPES += tuple((b * h, s, d, causal, 0, "bfloat16")
                      for b, h, s, d, causal, _ in FAMILY_FLASH)


# Phase 13: photonic_qat's steps a run (the script's default is 200), and
# the Table-4 GEMMs' timing loop (a MAW call at N = 1 draws 0.6 GB of
# noise at conv2).
QAT_EXAMPLE_STEPS = 20
TABLE4_ITERS, TABLE4_REPLAYS = 5, 3


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


def profile(fn, runs: int, kernel, split=()) -> dict:
    """Run fn() ``runs`` times under torch.profiler and split the device's
    time per run: busy (sum of kernel times), idle share of the span from
    the first kernel's start to the last one's end, the time and launches
    of the kernels whose name holds ``kernel`` (a name, or a tuple of
    names), and the time and launches of those whose name holds each of
    ``split``.

    The profiler can drop a session's device records (on the H100 machine
    a session now and then shows part of a kernel's launches, or none),
    and never adds any; fn's kernels are the same in every session.  So
    the block is profiled until two sessions see the same number of
    device kernels (at most four), and the session that sees the most is
    read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    sessions = []
    while len(sessions) < 4:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / runs * 1e3
        sessions.append(([e for e in prof.events()
                          if e.device_type == DeviceType.CUDA], wall_ms))
        counts = [len(k) for k, _ in sessions]
        if counts.count(max(counts)) >= 2:
            break
    kernels, wall_ms = max(sessions, key=lambda s: len(s[0]))
    assert kernels, "the profiler saw no device activity"
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels) -
               min(e.time_range.start for e in kernels))
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    ours = [e for e in kernels if any(n in e.name for n in names)]
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
        "split_launches_per_run": {
            part: sum(part in e.name for e in ours) / runs for part in split},
    }


def taom_bound(m: int, k: int, d: int, elt_bytes: int,
               noise_floats: int = 0, int8: bool = True) -> dict:
    """Least time for one photonic GEMM: x (M, K) and w (K, D) read once
    and the (M, D) output written once in the operands' type (plus the
    float32 noise when it is on), against 2 M K D operations at the
    tensor-core rate of the narrowest type that holds the quantized
    operands: int8 for the fused route (bits <= 7), bf16 for 8-bit
    operands (the float32 body; qmax 255 does not fit int8, and an 8-bit
    integer is exact in bf16)."""
    nbytes = elt_bytes * (m * k + k * d + m * d) + 4 * noise_floats
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rate = INT8_OPS_PER_S if int8 else BF16_FLOPS_PER_S
    ops_ms = 2.0 * m * k * d / rate * 1e3
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
    bh, l, p, s, q = ZAMBA_SSD
    args = inputs(bh, l, p, s)
    zamba = {"ms": device_ms(lambda: ssd_scan.ssd_scan_chunked(
                 *args, chunk=q), iters=5, replays=4),
             "plain_ms": device_ms(lambda: ops._ssd_chunked(*args, q),
                                   iters=2, replays=3),
             **ssd_bound(bh, l, p, s, q)}
    log("[ssd] zamba2-7b's served shape BH={} L={} P={} S={} Q={}: "
        "kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms={bound_ms:.5f} "
        "({bound_by}; bytes {bytes_ms:.5f}, operations {ops_ms:.5f}) per "
        "call (device times, CUDA graph replay)".format(bh, l, p, s, q,
                                                        **zamba))
    del args
    bh, l, p, s, q, _ = SSD_SHAPES[0]
    args = inputs(bh, l, p, s)
    kernel = lambda: ssd_scan.ssd_scan_chunked(*args, chunk=q)  # noqa: E731
    plain = lambda: ops._ssd_chunked(*args, q)                  # noqa: E731
    row = {"max_abs_err": max_err,
           "ms": device_ms(kernel, iters=10, replays=5),
           "plain_ms": device_ms(plain, iters=5, replays=4),
           "zamba2": zamba, **ssd_bound(bh, l, p, s, q)}
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


def counts() -> tuple:
    """The three kernel wrappers' launch counts: (TAOM, SSD, flash)."""
    from repro_torch.kernels import flash_attention, ssd_scan, taom_gemm
    return taom_gemm.LAUNCHES, ssd_scan.LAUNCHES, flash_attention.LAUNCHES


def zero_counts() -> None:
    from repro_torch.kernels import flash_attention, ssd_scan, taom_gemm
    taom_gemm.LAUNCHES = ssd_scan.LAUNCHES = flash_attention.LAUNCHES = 0


def eager_decode(cfg, prompts, gen: int, dev, params=None) -> tuple:
    """What ``serve()`` computes for these prompts (its seed-0 params —
    drawn here unless given —, its request batch, the default impls,
    greedy picks), with every decode step eager: returns (tokens (B,
    prompt + gen) on the CPU, decode seconds on the host clock,
    synchronized, the launch counts (TAOM, SSD, flash) of the prefill and
    of the decode steps)."""
    import torch
    from repro_torch.launch.serve import request_batch
    from repro_torch.models import model_zoo as zoo
    if params is None:
        params = zoo.init_params(cfg, 0, dev)
    b, p = prompts.shape
    caches = zoo.init_caches(cfg, b, p + gen, getattr(torch, cfg.dtype), dev)
    zero_counts()
    logits, state = zoo.prefill_fn(params, request_batch(cfg, prompts.to(dev)),
                                   cfg, caches)
    in_prefill = counts()
    tok = torch.argmax(logits[:, -1].float(), -1)[:, None]
    out = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, state = zoo.decode_fn(params, tok, p + i, cfg, state)
        tok = torch.argmax(logits[:, -1].float(), -1)[:, None]
        out.append(tok)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    in_decode = tuple(b - a for a, b in zip(in_prefill, counts()))
    return (torch.cat([prompts] + [t.cpu() for t in out], dim=1), secs,
            in_prefill, in_decode)


def held_memory() -> tuple:
    """(allocated, reserved) bytes on the card after a synchronize and
    ``empty_cache()``: what live tensors and graph pools hold, without the
    allocator's cached free blocks."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def prefill_ms(prefill) -> float:
    """One ``prefill()``'s host clock in ms, synchronized."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def decode_graph_profile(tag, params, cfg, state, tok, index, dev,
                         kernel, prefill) -> dict:
    """Capture one decode step over ``state`` (``DecodeGraph``), then its
    capture time, the memory it holds, a replay's host clock and a
    replay under the profiler; and, given ``prefill``, the host clock of
    ``prefill()`` after nothing, first after another capture, and first
    after ``empty_cache()``."""
    import torch
    from repro_torch.launch.serve import DecodeGraph
    mem0 = held_memory()
    t0 = time.perf_counter()
    step = DecodeGraph(params, cfg, state, tok)
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    mem1 = held_memory()
    for _ in range(3):
        step(tok, index)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step(tok, index)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    prof = profile(lambda: step(tok, index), 3, kernel)
    row = {"capture_ms": capture_ms, "replay_wall_ms": wall_ms,
           "allocated_mib": (mem1[0] - mem0[0]) / 2**20,
           "reserved_mib": (mem1[1] - mem0[1]) / 2**20, "profile": prof}
    log(f"[{tag}] one decode step as a CUDA graph: capture "
        f"{capture_ms:.3f} ms; holds {row['allocated_mib']:.2f} MiB "
        f"allocated, {row['reserved_mib']:.2f} MiB reserved (its static "
        f"state and its pool; the cache emptied before each reading); a "
        f"replay {wall_ms:.4f} ms host clock "
        f"(20 replays, synchronized); under torch.profiler (3 replays): " +
        json.dumps(prof, sort_keys=True))
    if prefill is None:
        return row
    # A capture must leave the allocator's cache warm for the eager work
    # after it (torch.cuda.graph empties it on entry; the port's capture
    # does not): the prefill's host clock after nothing, first after one
    # more capture, and first after emptying the cache, interleaved over
    # five rounds.
    prefill()
    arms = {"after_nothing": [], "after_capture": [],
            "after_empty_cache": []}
    for _ in range(5):
        arms["after_nothing"].append(prefill_ms(prefill))
        DecodeGraph(params, cfg, state, tok)
        arms["after_capture"].append(prefill_ms(prefill))
        torch.cuda.empty_cache()
        arms["after_empty_cache"].append(prefill_ms(prefill))
    row["prefill_ms"] = arms
    med = {arm: sorted(v)[2] for arm, v in arms.items()}
    log(f"[{tag}] prefill host clock, median of 5 interleaved rounds: "
        f"{med['after_nothing']:.3f} ms after nothing, "
        f"{med['after_capture']:.3f} ms first after one more decode-step "
        f"capture, "
        f"{med['after_empty_cache']:.3f} ms first after "
        f"torch.cuda.empty_cache(); each round's " +
        json.dumps(arms, sort_keys=True))
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
    from repro_torch.models.transformer import tree_map

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
        # A decode step updates the state in place: keep each step's copy.
        outs = [(lg, tree_map(torch.clone, st))]
        tok = lg[:, -1].argmax(-1)[:, None]
        for i in range(4):
            lg, st = zoo.decode_fn(params32, tok, LM_PROMPT + i, cfg32, st)
            outs.append((lg, tree_map(torch.clone, st)))
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
    log("[mamba] one eager decode step under torch.profiler (3 runs): " +
        json.dumps(step, sort_keys=True))
    graphed = decode_graph_profile("mamba", params, cfg, state, tok,
                                   LM_PROMPT + 3, dev, "ssd_scan", prefill)
    del params, state

    # The main path: serve() end to end; the warm-up call pays one-time
    # costs (cuBLAS handles, allocator growth).
    serve(LM_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
          gen=LM_GEN, seed=seed, device=dev)
    zero_counts()
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
        f"gen {LM_GEN}): prefill {res.prefill_s * 1e3:.3f} ms, decode-step "
        f"capture {res.capture_s * 1e3:.3f} ms, decode "
        f"{res.decode_s * 1e3:.3f} ms for {LM_GEN - 1} graph replays "
        f"({res.decode_s * 1e3 / (LM_GEN - 1):.4f} ms a step, "
        f"{res.tokens_per_s:.1f} tokens/s), host clock, synchronized; "
        f"{launches} SSD wrapper calls")
    eager_toks, eager_s, _, _ = eager_decode(cfg, toks[:, :LM_PROMPT], LM_GEN,
                                             dev)
    assert torch.equal(eager_toks, toks), "graphed tokens != eager tokens"
    log(f"[mamba] graphed greedy tokens equal eager greedy tokens "
        f"({LM_GEN} per request); eager decode {eager_s * 1e3:.3f} ms for "
        f"{LM_GEN - 1} steps ({eager_s * 1e3 / (LM_GEN - 1):.4f} ms a step, "
        f"{LM_BATCH * (LM_GEN - 1) / eager_s:.1f} tokens/s)")
    return {"launches": launches, "profile": split, "photonic": photonic,
            "graphed": graphed}


def flash_bound(bh: int, s: int, d: int, causal: bool, window: int,
                elt_bytes: int, dv: int = 0) -> dict:
    """Least time for one flash-attention call: q, k, v read once and o
    written once (bytes); and 2 (D + Dv) flops per (query, key) pair the
    mask lets through (Q K^T and P V; masked pairs need no work), over the
    card's rate for the inputs' type: bf16 on the tensor cores, float32
    on the CUDA cores.  ``dv`` is the function's V width (MLA: 128 under
    a 192-wide head; 0 = D): the kernel's zero-padded V columns are work
    the function does not need.  ``f32_floor_ms`` is the same flops at the
    float32 CUDA-core rate, the least time for the kernel's float32
    instance, which computes there."""
    dv = dv or d
    pairs = sum((qi + 1 if causal else s) -
                (max(0, qi - window + 1) if window else 0)
                for qi in range(s))
    flops = 2.0 * bh * (d + dv) * pairs
    bytes_ms = 2.0 * bh * s * (d + dv) * elt_bytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOPS_PER_S if elt_bytes == 2 else F32_FLOPS_PER_S
    ops_ms = flops / rate * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "f32_floor_ms": flops / F32_FLOPS_PER_S * 1e3,
            "gflop": flops / 1e9, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def bf16_row_err(got, want) -> tuple:
    """The bf16 check of phase 6, one query row at a time: max |kernel -
    plain| over each row against one bf16 ulp of that row's max|plain|,
    2^(floor(log2 max) - 7).  Both keep P in float32 (the kernel to
    2^-17) and round the output once, so an element moves by at most one
    ulp of its own binade; a causal row late in the sequence averages
    many values and is small, so a global max|plain| (row 0's, o_0 =
    v_0) would let a wrong normalization there pass.  Returns (max error,
    largest error / row ulp)."""
    import torch
    err = (got.float() - want.float()).abs().amax(-1)
    row_max = want.float().abs().amax(-1).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    return err.max().item(), (err / ulp).max().item()


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
            _, ratio = bf16_row_err(got, want)
            tol = (f"one bf16 ulp of each query row's max|plain|: worst "
                   f"row at {ratio:.3f} of its ulp")
            ok = ratio <= 1.0
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
    # The hybrid's, the VLM's, the encoder-decoder's and the moe family's
    # served shapes: kernel, plain version and SDPA (on the same tensors as
    # (batch, heads, S, D); for MLA on V's own 128 columns, the kernel on
    # V zero-padded to D as the model pads it) beside the bound.
    row["families"] = []
    for b, h, s, d, causal, dv in FAMILY_FLASH:
        q, k, v = inputs(b * h, s, d, "bfloat16")
        v[..., dv:] = 0
        q4, k4, v4 = (t.view(b, h, s, d) for t in (q, k, v))
        v4 = v4[..., :dv]
        shape = {"bh": b * h, "s": s, "d": d, "dv": dv, "causal": causal,
                 "ms": device_ms(lambda: flash_attention.flash_attention_fwd(
                     q, k, v, causal=causal), iters=10, replays=5),
                 "plain_ms": device_ms(lambda: ops._flash_blocked(
                     q, k, v, causal), iters=2, replays=3),
                 "library_ms": device_ms(
                     lambda: F.scaled_dot_product_attention(
                         q4, k4, v4, is_causal=causal), iters=10, replays=5),
                 **flash_bound(b * h, s, d, causal, 0, 2, dv)}
        shape["sdpa_ratio"] = shape["ms"] / shape["library_ms"]
        row["families"].append(shape)
        log("[flash] served BH={bh} S={s} D={d} Dv={dv} causal={causal} "
            "bf16: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms("
            "scaled_dot_product_attention)={library_ms:.5f} (kernel / SDPA "
            "{sdpa_ratio:.3f}) bound_ms={bound_ms:.5f} ({bound_by}; bytes "
            "{bytes_ms:.5f}, operations {ops_ms:.5f}), {tflops:.1f} TFLOP/s "
            "(device times, CUDA graph replay)".format(
                tflops=shape["gflop"] / shape["ms"], **shape))
    return row


def qwen_phase(dev) -> dict:
    """Phase 7: qwen2-0.5b served at its full width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan, taom_gemm
    from repro_torch.launch.serve import serve
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import tree_map

    cfg = get_config(QWEN_ARCH)
    seed = 0
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator().manual_seed(7))

    # The launch split: one flash launch per layer in the prefill (the
    # default attn_impl, 'auto'), none in decode.
    params = zoo.init_params(cfg, seed, dev)
    caches = zoo.init_caches(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                             torch.bfloat16, dev)
    zero_counts()
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
    assert in_prefill == (0, 0, cfg.num_layers) and in_decode == (0, 0, 0), (
        in_prefill, in_decode)
    log(f"[qwen2] flash kernel launches: {in_prefill[2]} in one prefill "
        f"({cfg.num_layers} layers), {in_decode[2]} in 3 decode steps; "
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
        # A decode step updates the caches in place: keep each step's copy.
        outs = [(lg, tree_map(torch.clone, st))]
        tok = lg[:, -1].argmax(-1)[:, None]
        for i in range(4):
            lg, st = zoo.decode_fn(params32, tok, LM_PROMPT + i, cfg32, st)
            outs.append((lg, tree_map(torch.clone, st)))
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
    log("[qwen2] one eager decode step under torch.profiler (3 runs): " +
        json.dumps(step, sort_keys=True))
    decode_graph_profile("qwen2", params, cfg, state, tok, LM_PROMPT + 3,
                         dev, "flash_attention_fwd_kernel", prefill)
    del params, state

    # The main path: serve() end to end; the warm-up call pays one-time
    # costs (cuBLAS handles, allocator growth).
    serve(QWEN_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
          gen=LM_GEN, seed=seed, device=dev)
    zero_counts()
    res = serve(QWEN_ARCH, smoke=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
                gen=LM_GEN, seed=seed, device=dev)
    launches = counts()
    # Exact numerics, attention only: neither the TAOM nor the SSD kernel
    # is on this path.
    assert launches == (0, 0, cfg.num_layers), launches
    toks = res.tokens
    assert toks.shape == (LM_BATCH, LM_PROMPT + LM_GEN), toks.shape
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"[qwen2] serve({QWEN_ARCH}, batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"gen {LM_GEN}): prefill {res.prefill_s * 1e3:.3f} ms, decode-step "
        f"capture {res.capture_s * 1e3:.3f} ms, decode "
        f"{res.decode_s * 1e3:.3f} ms for {LM_GEN - 1} graph replays "
        f"({res.decode_s * 1e3 / (LM_GEN - 1):.4f} ms a step, "
        f"{res.tokens_per_s:.1f} tokens/s), host clock, synchronized; "
        f"{launches[2]} flash kernel launches")
    eager_toks, eager_s, _, _ = eager_decode(cfg, toks[:, :LM_PROMPT], LM_GEN,
                                             dev)
    assert torch.equal(eager_toks, toks), "graphed tokens != eager tokens"
    log(f"[qwen2] graphed greedy tokens equal eager greedy tokens "
        f"({LM_GEN} per request); eager decode {eager_s * 1e3:.3f} ms for "
        f"{LM_GEN - 1} steps ({eager_s * 1e3 / (LM_GEN - 1):.4f} ms a step, "
        f"{LM_BATCH * (LM_GEN - 1) / eager_s:.1f} tokens/s)")
    return {"launches": launches[2], "profile": split}


def cut_config(cfg):
    """Phases 8-11's float32 and photonic copies: the hybrid cut to one
    superblock and its tail, the VLM to 2 layers, the moe family to 1
    dense + 1 MoE layer, whisper (4 + 4 layers) whole; every width
    kept."""
    import dataclasses
    from repro_torch.launch.serve import cfg_with_repeats
    if cfg.family == "hybrid":
        p = cfg.shared_attn_period
        return dataclasses.replace(cfg, num_layers=p + cfg.num_layers % p)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, num_layers=2)
    if cfg.family == "moe":
        return cfg_with_repeats(cfg, {"dense_head": 1, "moe_body": 1})
    return cfg


def family_launches(cfg) -> tuple:
    """(TAOM, SSD, flash) launches of one exact prefill of ``cfg``: the SSD
    wrapper once a mamba layer, the flash kernel once an attention layer
    (the hybrid's shared block once a superblock; whisper's encoder and
    decoder layers; each MLA layer)."""
    if cfg.family == "hybrid":
        return 0, cfg.num_layers, cfg.num_layers // cfg.shared_attn_period
    if cfg.family == "audio":
        return 0, 0, cfg.encoder_layers + cfg.num_layers
    return 0, 0, cfg.num_layers


def photonic_gemms(cfg) -> int:
    """TAOM wrapper calls of one photonic prefill: every dense (in_proj
    and out_proj a mamba layer; wq, wk, wv, wo and the MLP's an attention
    layer; MLA's wq_a, wq, wkv_a, wk_b, wv_b and wo and the dense MLP's or
    the shared experts' three; the projector; whisper's frame projection,
    self- and cross-attention and non-gated MLP); the logits' head and
    the routed experts stay exact."""
    if cfg.family == "hybrid":
        return 2 * cfg.num_layers + 7 * (cfg.num_layers //
                                         cfg.shared_attn_period)
    if cfg.family == "audio":
        return 1 + 6 * cfg.encoder_layers + 10 * cfg.num_layers
    if cfg.mla is not None:
        return 9 * cfg.num_layers
    return 7 * cfg.num_layers + (1 if cfg.vision_embed_dim else 0)


def served_phase(dev, tag: str, arch: str, cfg, batch: int, prompt: int,
                 repeats=None) -> tuple:
    """The served part of phases 8-11: ``arch`` (``cfg``: its full width,
    cut in depth by ``repeats``) through ``launch/serve.serve`` with
    seeded random bf16 weights, the counts zeroed just before it; the
    params drawn again (timed); an eager decode loop's tokens against
    serve()'s graphed ones; profiles of a prefill and an eager decode step
    and the decode graph.  Returns (row, params, prompts)."""
    import torch
    from repro_torch.launch.serve import DecodeGraph, request_batch, serve
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import tree_leaves

    want = family_launches(cfg)
    names = ("ssd_scan", "flash_attention_fwd_kernel")

    # The main path: serve() end to end, the counts zeroed just before it
    # and read just after.
    zero_counts()
    res = serve(arch, smoke=False, batch=batch, prompt_len=prompt,
                gen=LM_GEN, seed=0, device=dev, repeats=repeats)
    launches = counts()
    assert launches == want, (arch, launches, want)
    toks = res.tokens
    assert toks.shape == (batch, prompt + LM_GEN), toks.shape
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"[{tag}] serve({arch}, batch {batch}, prompt {prompt}, gen "
        f"{LM_GEN}): prefill {res.prefill_s * 1e3:.3f} ms, decode-step "
        f"capture {res.capture_s * 1e3:.3f} ms, decode "
        f"{res.decode_s * 1e3:.3f} ms for {LM_GEN - 1} graph replays "
        f"({res.decode_s * 1e3 / (LM_GEN - 1):.4f} ms a step, "
        f"{res.tokens_per_s:.1f} tokens/s), host clock, synchronized "
        f"(the first call of this model); launches (TAOM, SSD, flash) "
        f"{launches}")
    torch.cuda.empty_cache()

    # The same params again (serve() dropped its own), drawn on the host.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = zoo.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    held = held_memory()[0]
    log(f"[{tag}] init_params: {n_params} parameters ({n_params / 1e9:.3f} "
        f"B) in {init_s:.3f} s host clock (layers.ParamMaker: float32 "
        f"draws on the host, one stream a parameter, the layers of a stack "
        f"on threads; then bf16 on the card); {held / 2**30:.2f} GiB held "
        f"on the card (memory_allocated)")
    prompts = toks[:, :prompt]
    eager_toks, eager_s, in_prefill, in_decode = eager_decode(
        cfg, prompts, LM_GEN, dev, params)
    assert in_prefill == want and in_decode == (0, 0, 0), (in_prefill,
                                                           in_decode)
    assert torch.equal(eager_toks, toks), "graphed tokens != eager tokens"
    log(f"[{tag}] graphed greedy tokens equal eager greedy tokens "
        f"({LM_GEN} per request); eager decode {eager_s * 1e3:.3f} ms for "
        f"{LM_GEN - 1} steps ({eager_s * 1e3 / (LM_GEN - 1):.4f} ms a step, "
        f"{batch * (LM_GEN - 1) / eager_s:.1f} tokens/s); launches (TAOM, "
        f"SSD, flash) {in_prefill} in the prefill, {in_decode} in "
        f"{LM_GEN - 1} decode steps")

    # Profiles of one bf16 prefill and one eager decode step, then the
    # decode step as a CUDA graph.  serve() feeds the VLM zero patches, as
    # the reference's serve() does; projected, they stay zero through every
    # layer (no projector bias; RMSNorm, causal attention over zero K and V
    # and the SiLU MLP map 0 to 0), so the image positions carry no data.
    # The profiles and the timed prefills below draw seeded random patches.
    inputs = request_batch(cfg, prompts.to(dev))

    def prefill():
        caches = zoo.init_caches(cfg, batch, prompt + LM_GEN, torch.bfloat16,
                                 dev)
        return zoo.prefill_fn(params, inputs, cfg, caches)

    prefill_host = {}
    if cfg.family == "vlm":
        prefill()                                   # warm
        prefill_host["zero_patches_ms"] = prefill_ms(prefill)
        inputs["patches"] = torch.randn(
            inputs["patches"].shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(10)).bfloat16()
    logits, state = prefill()
    prefill_host["ms"] = prefill_ms(prefill)
    zero_ms = prefill_host.get("zero_patches_ms")
    log(f"[{tag}] one bf16 prefill_fn, host clock, synchronized, after a "
        f"warm call: {prefill_host['ms']:.3f} ms" + (
            f" with seeded random patches, {zero_ms:.3f} ms with serve()'s "
            f"zero patches" if zero_ms else ""))
    split = profile(prefill, 3, names, split=names)
    log(f"[{tag}] one prefill under torch.profiler (3 runs): " +
        json.dumps(split, sort_keys=True))
    assert split["split_launches_per_run"] == {
        "ssd_scan": 3 * want[1], "flash_attention_fwd_kernel": want[2]}, (
        split["split_launches_per_run"])
    tok = logits[:, -1].float().argmax(-1)[:, None]
    step = profile(lambda: zoo.decode_fn(params, tok, prompt, cfg, state), 3,
                   names)
    log(f"[{tag}] one eager decode step under torch.profiler (3 runs): " +
        json.dumps(step, sort_keys=True))
    assert step["kernel_launches_per_run"] == 0, step
    graphed = decode_graph_profile(tag, params, cfg, state, tok, prompt, dev,
                                   names, None)
    if cfg.family == "audio":
        # The graph reads the encoder output it holds as static state on
        # every replay: halving it changes the logits, restoring it gives
        # them back bit for bit (each replay at one index rewrites that
        # index's KV slot before reading it).
        graph = DecodeGraph(params, cfg, state, tok)
        before = graph(tok, prompt).clone()
        enc_out = graph.state["enc_out"]
        saved = enc_out.clone()
        enc_out.mul_(0.5)
        halved = graph(tok, prompt).clone()
        enc_out.copy_(saved)
        again = graph(tok, prompt)
        assert not torch.equal(before, halved), "enc_out is not read"
        assert torch.equal(before, again)
        log(f"[{tag}] the decode graph reads its static enc_out "
            f"{tuple(enc_out.shape)}: halved it moves the logits by "
            f"{(halved - before).float().abs().max().item():.3e}; restored "
            f"they are bit-equal")
        del graph
    del state, logits, inputs
    torch.cuda.empty_cache()
    return {"launches": launches, "serve": {
        "prefill_ms": res.prefill_s * 1e3, "capture_ms": res.capture_s * 1e3,
        "decode_step_ms": res.decode_s * 1e3 / (LM_GEN - 1),
        "tokens_per_s": res.tokens_per_s,
        "eager_step_ms": eager_s * 1e3 / (LM_GEN - 1)},
        "init_s": init_s, "n_params": n_params, "held_bytes": held,
        "prefill_host": prefill_host, "profile": split, "step": step,
        "graphed": graphed}, params, prompts


def photonic_cut_check(tag: str, cfgp, paramsp, prompts, dev,
                     attn_impl: str = "auto") -> None:
    """A photonic prefill (HEANA, 6-bit, N=83, noise off) of the cut model
    ``cfgp`` in bf16, at M = 512 rows as phase 2 cuts the LM GEMMs
    (whisper: 512 frames, a 64-token prompt; llava: 448 image positions of
    a 512-token prompt): the TAOM kernels bit-equal to their plain
    version, logits and every state leaf."""
    import torch
    from repro_torch.core.types import Backend, PhotonicConfig
    from repro_torch.launch.serve import request_batch
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.layers import PhotonicCtx
    from repro_torch.models.transformer import tree_leaves
    rows = 64 if cfgp.family == "audio" else 512
    inputsp = request_batch(cfgp, prompts[:1, :rows].to(dev))
    gen = torch.Generator(device=dev).manual_seed(9)
    if cfgp.family == "audio":
        inputsp["frames"] = torch.randn(
            (1, min(512, cfgp.encoder_seq), inputsp["frames"].shape[2]),
            generator=gen, device=dev).bfloat16()
    if cfgp.family == "vlm":
        inputsp["patches"] = torch.randn(
            (1, 448, cfgp.vision_embed_dim), generator=gen,
            device=dev).bfloat16()
    pcfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                          noise_enabled=False)
    phot = {}
    for impl in ("kernel", "ref"):
        caches = zoo.init_caches(cfgp, 1, rows, torch.bfloat16, dev)
        zero_counts()
        phot[impl] = zoo.prefill_fn(paramsp, inputsp, cfgp, caches,
                                    ctx=PhotonicCtx(cfg=pcfg, impl=impl),
                                    attn_impl=attn_impl)
        torch.cuda.synchronize()
        expect = photonic_gemms(cfgp) if impl == "kernel" else 0
        assert counts()[0] == expect, (impl, counts(), expect)
    (lk, sk), (lr, sr) = phot["kernel"], phot["ref"]
    for (key, g), (_, w) in zip(tree_leaves({"logits": lk, **sk}),
                                tree_leaves({"logits": lr, **sr})):
        assert torch.equal(g, w), (key, (g.float() - w.float()).abs().max())
    log(f"[{tag}] photonic ctx (HEANA, 6-bit, N=83, noise off) prefill of "
        f"the {cfgp.num_layers}-layer cut at M = {rows} rows, attention "
        f"attn_impl={attn_impl!r}: bit-equal "
        f"between the TAOM kernels ({photonic_gemms(cfgp)} wrapper calls) "
        f"and the plain version, logits and every state leaf")


def family_phase(dev, tag: str, arch: str, batch: int, prompt: int) -> dict:
    """Phases 8-10: ``arch`` served at its full width (``served_phase``),
    then its float32 copy cut in depth against the plain versions and a
    photonic prefill against the TAOM plain version."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import request_batch
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models.transformer import tree_leaves, tree_map

    cfg = get_config(arch)
    row, params, prompts = served_phase(dev, tag, arch, cfg, batch, prompt)
    del params
    torch.cuda.empty_cache()

    # float32 copy cut in depth: prefill + 4 decode steps with the kernels
    # against the plain versions (VLM patches seeded random, not zero).
    cfg32 = cut_config(dataclasses.replace(cfg, dtype="float32"))
    params32 = zoo.init_params(cfg32, 0, dev)
    inputs32 = request_batch(cfg32, prompts.to(dev))
    if cfg.family == "vlm":
        inputs32["patches"] = torch.randn(
            inputs32["patches"].shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(8))
    runs = {}
    for impl in ("kernel", "ref"):
        caches = zoo.init_caches(cfg32, batch, prompt + 4, torch.float32, dev)
        lg, st = zoo.prefill_fn(params32, inputs32, cfg32, caches,
                                ssm_impl=impl, attn_impl=impl)
        # A decode step updates the state in place: keep each step's copy.
        outs = [(lg, tree_map(torch.clone, st))]
        tk = lg[:, -1].argmax(-1)[:, None]
        for i in range(4):
            lg, st = zoo.decode_fn(params32, tk, prompt + i, cfg32, st)
            outs.append((lg, tree_map(torch.clone, st)))
            tk = lg[:, -1].argmax(-1)[:, None]
        runs[impl] = outs
    f32_err = 0.0
    for n, ((lk, sk), (lr, sr)) in enumerate(zip(runs["kernel"],
                                                 runs["ref"])):
        for (key, g), (_, w) in zip(tree_leaves({"logits": lk, **sk}),
                                    tree_leaves({"logits": lr, **sr})):
            assert bool(torch.isfinite(g.float()).all()), (n, key)
            if key[-1] == "pos":
                assert torch.equal(g, w), (n, key)
                continue
            rel = (g - w).abs().max().item() / w.abs().max().item()
            f32_err = max(f32_err, rel)
            assert rel <= SSD_TOL, (n, key, rel)
    log(f"[{tag}] float32 config cut to {cfg32.num_layers} layers, prefill "
        f"+ 4 decode steps: kernels vs plain versions max |diff| / max "
        f"|plain| = {f32_err:.3e} over the logits and every state leaf "
        f"(tolerance {SSD_TOL})")
    del runs

    # The photonic prefill of the cut in bf16 (the bf16 init is the
    # float32 draw rounded).
    paramsp = tree_map(lambda t: t.to(torch.bfloat16), params32)
    del params32
    photonic_cut_check(tag, dataclasses.replace(cfg32, dtype="bfloat16"),
                     paramsp, prompts, dev)
    del paramsp
    torch.cuda.empty_cache()
    row["f32_err"] = f32_err
    return row


@contextlib.contextmanager
def recorded_routes():
    """While open, ``moe.route`` records each call's (router_w, xf, top_e)
    into the list it yields; the real ``moe.route`` is put back on exit."""
    from repro_torch.models import moe
    routes = []
    real_route = moe.route

    def recording_route(router_w, xf, mcfg):
        top_p, top_e = real_route(router_w, xf, mcfg)
        routes.append((router_w, xf, top_e))
        return top_p, top_e

    moe.route = recording_route
    try:
        yield routes
    finally:
        moe.route = real_route


def near_ties(router_w, xf, k: int):
    """Tokens whose k-th and (k+1)-th router probabilities lie within
    ``NEAR_TIE`` of the k-th (a bool per token)."""
    import torch
    from repro_torch.models import moe
    top = torch.topk(moe.router_probs(router_w, xf), k + 1, -1).values
    return (top[:, k - 1] - top[:, k]) < NEAR_TIE * top[:, k - 1]


def routing_stats(routes, mcfg) -> dict:
    """Tokens, near-ties and dropped slots over recorded routes."""
    from repro_torch.models import moe
    out = {"tokens": 0, "near_ties": 0, "dropped_slots": 0}
    for router_w, xf, top_e in routes:
        _, keep, _ = moe.slot_positions(top_e, mcfg)
        out["tokens"] += xf.shape[0]
        out["near_ties"] += int(near_ties(router_w, xf,
                                          mcfg.experts_per_token).sum())
        out["dropped_slots"] += int((~keep).sum())
    return out


def moe_phase(dev) -> dict:
    """Phase 11: deepseek-v2-236b at its full width, cut in depth to 1
    dense + 2 MoE layers, served (``served_phase``); then a float32 cut
    (1 dense + 1 MoE layer: the served params' first layers in float32)
    held sublayer by sublayer, kernel route against plain route, each fed
    the plain route's input, with the routing compared token by token;
    then a photonic prefill of that cut in bf16 against the TAOM plain
    version."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cfg_with_repeats
    from repro_torch.models.transformer import tree_map

    cfg = cfg_with_repeats(get_config(MOE_ARCH), MOE_REPEATS)
    row, params, prompts = served_phase(dev, "moe", MOE_ARCH, cfg,
                                        MOE_BATCH, MOE_PROMPT, MOE_REPEATS)

    # float32 cut: the bf16 params' values held in float32 (no third draw).
    cfg32 = cut_config(dataclasses.replace(cfg, dtype="float32"))
    params32 = {key: tree_map(lambda t: (t[:1] if key == "moe_body" else t)
                              .float(), sub) for key, sub in params.items()}
    del params
    torch.cuda.empty_cache()
    with recorded_routes() as routes:
        worst, routing = _moe_f32_cut(dev, cfg32, params32, prompts,
                                      routes)
    log(f"[moe] float32 cut (1 dense + 1 MoE layer), prefill of batch "
        f"{prompts.shape[0]}, prompt {prompts.shape[1]}, sublayer by "
        f"sublayer, each fed the plain route's input: kernel route vs "
        f"plain route max |diff| / max |plain| = {worst['out']:.3e} over "
        f"the tokens whose routing agrees, {worst['cache']:.3e} over ckv "
        f"and kr, pos equal (tolerance {SSD_TOL})")

    # The photonic prefill of the cut in bf16 (the served params' values),
    # attention on the reference's dense route on both sides.
    paramsp = tree_map(lambda t: t.to(torch.bfloat16), params32)
    del params32
    photonic_cut_check("moe", dataclasses.replace(cfg32, dtype="bfloat16"),
                     paramsp, prompts, dev, attn_impl="dense")
    del paramsp
    torch.cuda.empty_cache()
    row.update(f32_err=worst["out"], f32_cache_err=worst["cache"],
               routing=routing)
    return row


def _moe_f32_cut(dev, cfg32, params32, prompts, routes) -> tuple:
    """``moe_phase``'s float32 cut, sublayer by sublayer, kernel route
    against plain route, each fed the plain route's input, with ``routes``
    (``recorded_routes``) compared token by token.  Returns (worst
    relative errors, the routing's counts)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.transformer import tree_map
    b, s = prompts.shape
    k = cfg32.moe.experts_per_token
    x = L.embed(params32["embed"], prompts.to(dev))
    positions = T.prompt_positions(b, s, dev)
    caches = zoo.init_caches(cfg32, b, s, torch.float32, dev)
    worst = {"out": 0.0, "cache": 0.0}
    routing = {}
    for g in T.layer_plan(cfg32):
        for r in range(g.repeats):
            layer_p = tree_map(lambda a: a[r], params32[g.name]["stack"])
            layer_c = tree_map(lambda a: a[r], caches[g.name])
            runs = {}
            for impl in ("kernel", "ref"):
                routes.clear()
                zero_counts()
                out, cache = T._run_sublayer(
                    layer_p, x, positions, cfg32, g.kind, -1, L.EXACT_CTX,
                    g.name, layer_c, None, attn_impl=impl, return_state=True)
                torch.cuda.synchronize()
                assert counts() == (0, 0, int(impl == "kernel")), counts()
                runs[impl] = (out, cache, list(routes))
            (yk, ck, rk), (yr, cr, rr) = runs["kernel"], runs["ref"]
            assert bool(torch.isfinite(yk).all())
            agree = torch.ones(b * s, dtype=torch.bool, device=dev)
            if g.kind == "attn_moe":
                # Top-k sets and kept experts per token; a token whose
                # routing differs must be a near-tie of the plain run.
                (_, _, ek), (w, xr, er) = rk[0], rr[0]
                kept = []
                for e in (ek, er):
                    _, keep, _ = moe.slot_positions(e, cfg32.moe)
                    kept.append(torch.sort(torch.where(
                        keep.reshape(-1, k), e, -1), -1).values)
                differ = ((torch.sort(ek, -1).values !=
                           torch.sort(er, -1).values).any(-1) |
                          (kept[0] != kept[1]).any(-1))
                near = near_ties(w, xr, k)
                assert not bool((differ & ~near).any()), (
                    "routing differs away from a near-tie")
                agree = ~differ
                routing = {**routing_stats(rr, cfg32.moe),
                           "routing_differs": int(differ.sum())}
                log(f"[moe] float32 {g.name}[{r}] routing, kernel route vs "
                    f"plain route: " + json.dumps(routing, sort_keys=True) +
                    f" (near-tie: the plain run's k-th and (k+1)-th "
                    f"probabilities within {NEAR_TIE:g} of the k-th)")
            diff = (yk - yr).abs().reshape(b * s, -1).amax(-1)
            rel = diff[agree].max().item() / yr.abs().max().item()
            assert rel <= SSD_TOL, (g.name, r, rel)
            worst["out"] = max(worst["out"], rel)
            for key in ("ckv", "kr", "pos"):
                if key == "pos":
                    assert torch.equal(ck[key], cr[key])
                    continue
                crel = ((ck[key] - cr[key]).abs().max().item() /
                        cr[key].abs().max().item())
                assert crel <= SSD_TOL, (g.name, r, key, crel)
                worst["cache"] = max(worst["cache"], crel)
            x = yr
    return worst, routing


def moe_v3_phase(dev) -> dict:
    """Phase 11, second model: deepseek-v3-671b at its full width, cut in
    depth to 1 dense + 1 MoE layer, served (``served_phase``: graphed
    tokens equal to eager, profiles, the decode graph); then the routing
    of one served bf16 prefill: tokens, near-ties (the k-th and (k+1)-th
    router probabilities within ``NEAR_TIE`` of the k-th) and dropped
    slots."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cfg_with_repeats, request_batch
    from repro_torch.models import model_zoo as zoo

    gc.collect()
    held = held_memory()[0]
    log(f"[moe-v3] before the draw: {held / 2**30:.2f} GiB held on the card "
        f"(deepseek-v2's params freed)")
    cfg = cfg_with_repeats(get_config(MOE_V3_ARCH), MOE_V3_REPEATS)
    row, params, prompts = served_phase(dev, "moe-v3", MOE_V3_ARCH, cfg,
                                        MOE_BATCH, MOE_PROMPT,
                                        MOE_V3_REPEATS)
    b, s = prompts.shape
    caches = zoo.init_caches(cfg, b, s, torch.bfloat16, dev)
    with recorded_routes() as routes:
        zoo.prefill_fn(params, request_batch(cfg, prompts.to(dev)), cfg,
                       caches)
    k = cfg.moe.experts_per_token
    routing = routing_stats(routes, cfg.moe)
    assert len(routes) == MOE_V3_REPEATS["moe_body"], len(routes)
    log(f"[moe-v3] routing of one served bf16 prefill (batch {b}, prompt "
        f"{s}, top-{k} of {cfg.moe.num_experts}): " +
        json.dumps(routing, sort_keys=True))
    del params, caches, routes
    gc.collect()
    torch.cuda.empty_cache()
    row["routing"] = routing
    return row


def qat_times(dev, cfg, gemms) -> list:
    """The TAOM kernel at photonic QAT's shapes (bf16 activations and
    weights, the photonic_heana config, noise off): the route a training
    step's forward takes (PyTorch's quantize, the float32 body,
    rescale: ``ops.photonic_matmul(impl="kernel")``), the body alone and
    the plain route, device times (CUDA graph replay) beside the bound —
    x, w and the output read or written once in bf16, 2 M K D operations
    at the bf16 tensor-core rate (an 8-bit operand is exact in bf16).
    The kernel route must equal the plain one bit for bit: each chunk's
    psum is exact (qmax^2 N < 2^24) and both sum the chunks in order."""
    import torch
    from repro_torch.core.taom import quantize
    from repro_torch.kernels import ops, taom_gemm
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for name, m, k, d in gemms:
        x = torch.randn((m, k), generator=gen, device=dev).bfloat16()
        w = torch.randn((k, d), generator=gen, device=dev).bfloat16()
        fs = taom_gemm.calibrated_adc_fs(k, cfg)
        xq, _ = quantize(x.float(), cfg.bits)
        wq, _ = quantize(w.float(), cfg.bits, axis=0)
        xq, wq = xq.contiguous(), wq.contiguous()
        assert cfg.qmax ** 2 * cfg.dpe_size < EXACT_LIMIT
        route = lambda: ops.photonic_matmul(x, w, cfg,   # noqa: E731
                                            impl="kernel")
        plain = lambda: ops.photonic_matmul(x, w, cfg,   # noqa: E731
                                            impl="ref")
        body = lambda: taom_gemm.taom_gemm_quantized(    # noqa: E731
            xq, wq, None, cfg, fs)
        with torch.no_grad():
            assert torch.equal(route(), plain()), name
            row = {"gemm": name, "m": m, "k": k, "d": d,
                   "chunks": -(-k // cfg.dpe_size),
                   "route_ms": device_ms(route), "body_ms": device_ms(body),
                   "plain_ms": device_ms(plain),
                   "matmul_ms": device_ms(lambda: torch.matmul(x, w))}
        row.update(taom_bound(m, k, d, 2, int8=taom_gemm.int8_route(cfg)))
        log("[train] TAOM at QAT's {gemm} M={m} K={k} D={d} C={chunks} "
            "(8-bit HEANA, bf16 operands): route_ms={route_ms:.5f} (float32 "
            "body alone {body_ms:.5f}) plain_ms={plain_ms:.5f} bound_ms="
            "{bound_ms:.5f} ({bound_by}) torch.matmul_ms={matmul_ms:.5f} "
            "(device times, CUDA graph replay); kernel route == plain "
            "route bit for bit".format(**row))
        rows.append(row)
    return rows


def train_phase(dev) -> dict:
    """Phase 12: training on the card through ``launch/train.train`` —
    exact mamba2-130m at full width (the loss falls, step time, profile,
    every leaf's gradient), exact resume, C1's guard (gradients through
    the default routes equal the plain routes'), photonic QAT through the
    TAOM kernel bit-equal to its plain route, and qwen2-0.5b."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_source
    from repro_torch.launch import train as T
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import transformer
    from repro_torch.models.layers import EXACT_CTX
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import optimizer as opt

    cfg = get_config(TRAIN_ARCH)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    kw = dict(smoke=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev,
              log_every=5)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        # Exact training, 20 steps, checkpoints at steps 10 and 20.
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        full = T.train(TRAIN_ARCH, steps=TRAIN_STEPS,
                       ckpt_dir=os.path.join(root, "a"), ckpt_every=10, **kw)
        wall = time.perf_counter() - t0
        launched = counts()
        peak = torch.cuda.max_memory_allocated()
        assert launched == (0, 0, 0), launched
        assert all(math.isfinite(x) for x in full.losses), full.losses
        assert full.final_loss < full.first_loss, full.losses
        warm = sorted(full.step_s[3:])
        step_ms = warm[len(warm) // 2] * 1e3
        out["exact"] = {"losses": full.losses, "step_ms": step_ms,
                        "tokens_per_s": tokens_per_step / step_ms * 1e3,
                        "loop_tokens_per_s": full.tokens_per_s,
                        "wall_s": wall, "peak_bytes": peak,
                        "launches": launched}
        log(f"[train] {TRAIN_ARCH} exact, {TRAIN_STEPS} steps of "
            f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens (bf16, remat): loss "
            f"{full.first_loss:.4f} -> {full.final_loss:.4f}; warm step "
            f"{step_ms:.2f} ms (median of steps 3-{TRAIN_STEPS - 1}, host "
            f"clock, loss read back), {out['exact']['tokens_per_s']:.0f} "
            f"tokens/s; the loop (checkpoints, data, first steps) "
            f"{full.tokens_per_s:.0f} tokens/s; peak memory "
            f"{peak / 2**30:.2f} GiB; {wall:.1f} s; launches (TAOM, SSD, "
            f"flash) {launched}: the SSD scan ran its plain route")

        # Exact resume: as if the run had stopped after step 10's save,
        # that checkpoint restored into a fresh run.
        shutil.rmtree(os.path.join(root, "a", "step_00000020"))
        again = T.train(TRAIN_ARCH, steps=TRAIN_STEPS,
                        ckpt_dir=os.path.join(root, "a"), ckpt_every=1000,
                        resume=True, **kw)
        assert again.losses == full.losses[10:], (again.losses,
                                                  full.losses[10:])
        for (key, a), (_, b) in zip(tree_leaves(again.params),
                                    tree_leaves(full.params)):
            assert torch.equal(a, b), key
        log(f"[train] resume from step 10's checkpoint: steps 10-19's "
            f"losses and the final params bit-equal to the uninterrupted "
            f"run's")
        del again
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # One more step of the full run, profiled; then its gradients.
    source = make_source(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH))
    batch = T.device_batch(source.batch(TRAIN_STEPS), cfg, dev)
    adam = opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                           total_steps=TRAIN_STEPS + 8)
    held = {"state": full.state}

    def step():
        _, held["state"], _ = T.train_step(full.params, held["state"], batch,
                                           cfg, EXACT_CTX, adam)
    prof = profile(step, 1, ("ssd_scan", "flash_attention", "taom_gemm"))
    assert prof["kernel_launches_per_run"] == 0, prof
    out["exact"]["profile"] = prof
    log(f"[train] one exact step under the profiler: "
        f"{prof['profiled_wall_ms_per_run']:.2f} ms host clock, "
        f"{prof['device_busy_ms_per_run']:.2f} ms device busy, idle "
        f"{prof['device_idle_share']:.1%}, "
        f"{prof['device_kernels_per_run']:g} kernels, none of the port's "
        f"own; top: " + json.dumps(prof["top_kernels_ms_per_run"][:5]))
    upstream = {}
    for key, p in tree_leaves(full.params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), key
        for name in SSD_UPSTREAM:
            if name in key:
                upstream[name] = upstream.get(name, 0.0) + \
                    p.grad.float().abs().max().item()
    assert sorted(upstream) == sorted(SSD_UPSTREAM), upstream
    assert all(v > 0 for v in upstream.values()), upstream
    log(f"[train] every one of {len(list(tree_leaves(full.params)))} "
        f"param leaves has a finite gradient; the SSD's upstream weights' "
        f"max |grad|: " + json.dumps(upstream, sort_keys=True))
    del full, held

    # C1 on the card: a 2-layer float32 cut, gradients through forward
    # under the default 'auto' routes against the plain routes.
    cut = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    toks = batch["tokens"]
    grads = {}
    for impl in ("auto", "ref"):
        params = tree_map(lambda p: p.requires_grad_(),
                          zoo.init_params(cut, 0, dev))
        zero_counts()
        transformer.forward(params, toks, cut, ssm_impl=impl) \
            .float().square().mean().backward()
        assert counts() == (0, 0, 0), (impl, counts())
        grads[impl] = {k: p.grad for k, p in tree_leaves(params)}
    assert all(torch.equal(g, grads["ref"][k])
               for k, g in grads["auto"].items())
    try:
        transformer.forward(params, toks, cut, ssm_impl="kernel")
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("impl='kernel' under grad did not raise")
    log(f"[train] C1: a 2-layer float32 cut's gradients through forward "
        f"under 'auto' bit-equal to 'ref' ({len(grads['auto'])} leaves, no "
        f"kernel launched); ssm_impl='kernel' under grad raises: {refused}")
    del grads, params

    # Photonic QAT: 5 steps through the TAOM kernel, then through its plain
    # route.  A step runs every photonic GEMM (in_proj and out_proj a
    # layer) in the forward and again in the remat recompute.
    expected = QAT_STEPS * 2 * 2 * cfg.num_layers
    qat = {}
    for impl in ("auto", "ref"):
        zero_counts()
        qat[impl] = T.train(TRAIN_ARCH, steps=QAT_STEPS,
                            numerics="photonic_heana", impl=impl, **kw)
        qat[impl + "_launches"] = counts()
    assert qat["auto_launches"] == (expected, 0, 0), qat["auto_launches"]
    assert qat["ref_launches"] == (0, 0, 0), qat["ref_launches"]
    assert qat["auto"].losses == qat["ref"].losses, (qat["auto"].losses,
                                                     qat["ref"].losses)
    for (key, a), (_, b) in zip(tree_leaves(qat["auto"].params),
                                tree_leaves(qat["ref"].params)):
        assert torch.equal(a, b), key
    assert all(math.isfinite(x) for x in qat["auto"].losses)
    q_ms = {impl: sorted(qat[impl].step_s[1:])[(QAT_STEPS - 1) // 2] * 1e3
            for impl in ("auto", "ref")}
    out["qat"] = {"losses": qat["auto"].losses, "launches": expected,
                  "step_ms": q_ms["auto"], "plain_step_ms": q_ms["ref"]}
    log(f"[train] photonic QAT (photonic_heana) {QAT_STEPS} steps: "
        f"{expected} TAOM launches = {QAT_STEPS} steps x 2 (forward + "
        f"remat recompute) x 2 x {cfg.num_layers} layers; losses "
        f"{[round(x, 4) for x in qat['auto'].losses]} and final params "
        f"bit-equal to impl='ref'; warm step {q_ms['auto']:.2f} ms through "
        f"the kernel, {q_ms['ref']:.2f} ms through the plain route (host "
        f"clock)")
    del qat
    m = TRAIN_BATCH * TRAIN_SEQ
    d_inner = 2 * cfg.d_model
    in_d = 2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.state_dim + \
        d_inner // cfg.ssm.head_dim
    out["qat"]["gemms"] = qat_times(
        dev, T.NUMERICS["photonic_heana"],
        (("in_proj", m, cfg.d_model, in_d), ("out_proj", m, d_inner,
                                              cfg.d_model)))

    # The dense family: qwen2-0.5b at full width.
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    dense = T.train(DENSE_TRAIN_ARCH, steps=DENSE_TRAIN_STEPS, **kw)
    assert counts() == (0, 0, 0), counts()
    assert all(math.isfinite(x) for x in dense.losses), dense.losses
    d_ms = sorted(dense.step_s[1:])[(DENSE_TRAIN_STEPS - 1) // 2] * 1e3
    out["dense"] = {"losses": dense.losses, "step_ms": d_ms,
                    "tokens_per_s": tokens_per_step / d_ms * 1e3,
                    "peak_bytes": torch.cuda.max_memory_allocated()}
    dcfg = get_config(DENSE_TRAIN_ARCH)
    dbatch = T.device_batch(make_source(DataConfig(
        vocab_size=dcfg.vocab_size, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH)).batch(DENSE_TRAIN_STEPS), dcfg, dev)
    held = {"state": dense.state}

    def dense_step():
        _, held["state"], _ = T.train_step(dense.params, held["state"],
                                           dbatch, dcfg, EXACT_CTX, adam)
    prof = profile(dense_step, 1, ("ssd_scan", "flash_attention",
                                   "taom_gemm"))
    assert prof["kernel_launches_per_run"] == 0, prof
    out["dense"]["profile"] = prof
    log(f"[train] {DENSE_TRAIN_ARCH} exact, {DENSE_TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss {dense.first_loss:.4f} -> "
        f"{dense.final_loss:.4f}; warm step {d_ms:.2f} ms (median of "
        f"steps 1-{DENSE_TRAIN_STEPS - 1}), "
        f"{out['dense']['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{out['dense']['peak_bytes'] / 2**30:.2f} GiB; attention ran its "
        f"plain route; one more step under the profiler: "
        f"{prof['profiled_wall_ms_per_run']:.2f} ms host clock, "
        f"{prof['device_busy_ms_per_run']:.2f} ms device busy, idle "
        f"{prof['device_idle_share']:.1%}, "
        f"{prof['device_kernels_per_run']:g} kernels; top: " +
        json.dumps(prof["top_kernels_ms_per_run"][:6]))
    return out


# The kernel wrappers whose calls phase 13 records while an example runs
# (module under repro_torch.kernels, wrapper): each launches its kernel on
# the card, and ``hold_calls`` holds what it returned against its plain
# version.
KERNEL_WRAPPERS = (("taom_gemm", "taom_gemm_quantized"),
                   ("taom_gemm", "taom_gemm_fused"),
                   ("ssd_scan", "ssd_scan_chunked"),
                   ("flash_attention", "flash_attention_fwd"))


def _detached(v):
    import torch
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, tuple):
        return tuple(_detached(t) for t in v)
    return v


@contextlib.contextmanager
def recorded_calls():
    """While open, each wrapper of ``KERNEL_WRAPPERS`` is wrapped: the first
    call at each distinct signature (the wrapper, each tensor argument's
    shape and dtype, every other argument's value) outside a CUDA graph
    capture keeps detached copies of its arguments and of what it
    returned; a call inside a capture only notes its signature (a capture
    replays the warm eager call before it, ``core.cuda_graph.capture``).
    Yields (calls: {signature: (wrapper, arguments, output)}, the
    signatures seen inside a capture); the wrappers are put back on
    exit."""
    import importlib
    import inspect
    import torch
    calls, captured, saved = {}, set(), []
    for mod_name, fn_name in KERNEL_WRAPPERS:
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        real = getattr(mod, fn_name)

        def recording(*args, _real=real, _sig=inspect.signature(real),
                      _name=fn_name, **kwargs):
            out = _real(*args, **kwargs)
            bound = _sig.bind(*args, **kwargs)
            bound.apply_defaults()
            key = (_name,) + tuple(
                (arg, tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                else (arg, repr(v)) for arg, v in bound.arguments.items())
            if torch.cuda.is_available() and \
                    torch.cuda.is_current_stream_capturing():
                captured.add(key)
            elif key not in calls:
                calls[key] = (_name, {arg: _detached(v) for arg, v in
                                      bound.arguments.items()},
                              _detached(out))
            return out

        setattr(mod, fn_name, recording)
        saved.append((mod, fn_name, real))
    try:
        yield calls, captured
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)


def hold_calls(label: str, calls: dict, captured: set) -> dict:
    """Each recorded kernel call's output against its plain version on the
    same inputs: the TAOM routes bit-equal (``ref.taom_gemm_reference``,
    ``ref.photonic_gemm_reference``), the SSD scan within ``SSD_TOL``
    (``ops._ssd_chunked``), flash within ``FLASH_TOL`` in float32 and one
    bf16 ulp of each query row's max|plain| in bf16
    (``ops._flash_blocked``, ``bf16_row_err``).  Every signature seen
    inside a graph capture must also have run eagerly.  Returns
    {wrapper: {"signatures": n, "max_abs_err": x}}."""
    import torch
    from repro_torch.kernels import ops, ref
    missing = captured - set(calls)
    assert not missing, (label, "captured only", sorted(map(str, missing)))
    held = {}
    for key, (name, a, got) in calls.items():
        if name == "taom_gemm_quantized":
            want = ref.taom_gemm_reference(a["xq"], a["wq"], a["noise"],
                                           a["cfg"], a["adc_fs"])
        elif name == "taom_gemm_fused":
            want = ref.photonic_gemm_reference(a["x"], a["w"], a["noise"],
                                               a["cfg"], a["adc_fs"])
        elif name == "ssd_scan_chunked":
            want = ops._ssd_chunked(a["x"], a["dt"], a["a"], a["b"], a["c"],
                                    a["chunk"])
        else:
            want = ops._flash_blocked(a["q"], a["k"], a["v"], a["causal"],
                                      a["window"])
        pairs = (list(zip(got, want)) if isinstance(got, tuple)
                 else [(got, want)])
        err = 0.0
        for g, w in pairs:
            assert g.shape == w.shape and g.dtype == w.dtype, (label, key)
            assert bool(torch.isfinite(g).all()), (label, key)
            err = max(err, (g.float() - w.float()).abs().max().item())
            if name.startswith("taom"):
                ok = torch.equal(g, w)
            elif name == "ssd_scan_chunked":
                ok = torch.allclose(g, w, rtol=SSD_TOL, atol=SSD_TOL *
                                    w.abs().max().item())
            elif g.dtype == torch.float32:
                ok = torch.allclose(g, w, rtol=FLASH_TOL, atol=FLASH_TOL *
                                    w.abs().max().item())
            else:
                ok = bf16_row_err(g, w)[1] <= 1.0
            assert ok, (label, key, err)
        row = held.setdefault(name, {"signatures": 0, "max_abs_err": 0.0})
        row["signatures"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return held


def run_example(name: str, argv: list) -> tuple:
    """``examples_torch/<name>.py``'s ``main(argv)`` on the card, the launch
    counts set to 0 just before it and read just after, every kernel call
    recorded (``recorded_calls``) and then held against its plain version
    (``hold_calls``): (its dict, the launches (TAOM, SSD, flash),
    host-clock seconds, synchronized, with the recording's copies; what
    was held)."""
    import importlib
    import torch
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    mod = importlib.import_module(name)
    label = " ".join([name] + argv)
    with recorded_calls() as (calls, captured):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = counts()
    held = hold_calls(label, calls, captured)
    del calls
    torch.cuda.empty_cache()
    log(f"[examples] {label}: {secs:.3f} s host clock, synchronized; "
        f"launches (TAOM, SSD, flash) {launches}; each distinct kernel "
        f"call held against its plain version: " +
        json.dumps(held, sort_keys=True))
    for n, names in zip(launches, (("taom_gemm_quantized",
                                    "taom_gemm_fused"),
                                   ("ssd_scan_chunked",),
                                   ("flash_attention_fwd",))):
        assert (n > 0) == any(w in held for w in names), (label, launches,
                                                          held)
    return out, launches, secs, held


def table4_gemms(t4, params, x, numerics: str) -> list:
    """The four GEMMs' inputs (a (M, K), w) of one Table-4 forward under
    ``numerics``, recorded around ``t4.gemm_under``'s matmul (the plain
    route, ``evaluate``'s noise)."""
    from repro_torch.models.cnn import small_cnn_apply
    mm = t4.gemm_under(numerics, "ref")
    seen = []

    def record(a, w):
        seen.append((a.reshape(-1, a.shape[-1]), w))
        return mm(a, w)

    small_cnn_apply(params, x, matmul=record)
    return seen


def table4_phase(dev, t4, params) -> dict:
    """The Table-4 evaluation's photonic columns through the TAOM kernel
    on the card (8 bits: the float32 body, HEANA at N = 2, MAW at N = 1,
    int8 at N = 83), on ``evaluate``'s 512 images: for each column the
    kernel route's logits bit-equal to ``impl="ref"`` with the same noise
    (every GEMM draws from a fresh generator seeded 7, as ``evaluate``
    does), each GEMM's largest integer accumulation max |xq| @ |wq|
    printed beside 2^24; then each GEMM's kernel route (quantize, body,
    rescale; noise pre-drawn) and plain route timed (CUDA graph replay)
    beside the bound (x, w, the output and the noise once at 3.35 TB/s
    against 2 M K D operations at 989 TFLOP/s bf16, ``taom_bound``: qmax
    255 does not fit int8)."""
    import torch
    from repro_torch.core.photonic_gemm import generator_for, sample_noise
    from repro_torch.core.taom import quantize
    from repro_torch.kernels import ops, taom_gemm
    x, _ = t4.make_data(512, 123, device=dev)
    out = {}
    for numerics in ("int8", "heana", "maw"):
        cfg = t4.numerics_config(numerics)
        with torch.no_grad():
            got = t4.logits_under(params, x, numerics, "kernel")
            want = t4.logits_under(params, x, numerics, "ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (
            numerics, (got - want).abs().max().item())
        rows, sums = [], []
        for a, w in table4_gemms(t4, params, x, numerics):
            m, k = a.shape
            d = w.shape[1]
            xq, _ = quantize(a, cfg.bits)
            wq, _ = quantize(w, cfg.bits, axis=0)
            sums.append((xq.abs().double() @ wq.abs().double()).max().item())
            noise = (sample_noise(generator_for(t4.NOISE_SEED, dev), (m, k),
                                  (k, d), cfg) if cfg.noise_enabled else None)
            route = lambda: ops.photonic_matmul(           # noqa: E731
                a, w, cfg, noise=noise, impl="kernel")
            plain = lambda: ops.photonic_matmul(           # noqa: E731
                a, w, cfg, noise=noise, impl="ref")
            with torch.no_grad():
                assert torch.equal(route(), plain()), (numerics, m, k, d)
                row = {"m": m, "k": k, "d": d,
                       "chunks": -(-k // cfg.dpe_size),
                       "kernel_ms": device_ms(route, TABLE4_ITERS,
                                              TABLE4_REPLAYS),
                       "plain_ms": device_ms(plain, TABLE4_ITERS,
                                             TABLE4_REPLAYS)}
            row.update(taom_bound(m, k, d, 4, 0 if noise is None
                                  else noise.numel(),
                                  int8=taom_gemm.int8_route(cfg)))
            rows.append(row)
            del noise
        out[numerics] = {
            "dpe_size": cfg.dpe_size, "noise": cfg.noise_enabled,
            "kernel_ms": sum(r["kernel_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "max_int_sum": sums, "gemms": rows}
        log(f"[examples] Table-4 {numerics} (N = {cfg.dpe_size}, noise "
            f"{'on' if cfg.noise_enabled else 'off'}), 512 images: kernel "
            f"route logits bit-equal to impl='ref'; max |xq| @ |wq| per "
            f"GEMM {[int(v) for v in sums]} (2^24 = {int(EXACT_LIMIT)}); "
            f"per forward kernel route {out[numerics]['kernel_ms']:.4f} ms, "
            f"plain {out[numerics]['plain_ms']:.4f} ms, bound "
            f"{out[numerics]['bound_ms']:.5f} ms (device times, CUDA graph "
            f"replay); per GEMM " + json.dumps(
                [{key: r[key] for key in ("m", "k", "d", "chunks",
                                          "kernel_ms", "plain_ms",
                                          "bound_ms", "bound_by")}
                 for r in rows]))
        torch.cuda.empty_cache()
    return out


def examples_phase(dev) -> dict:
    """Phase 13: the ten ``examples_torch`` scripts on the card, each
    through its ``main(argv)`` with the launch counts set to 0 just before
    it (``run_example``); each one's kernels asserted to have run (none
    under grad, C1), each distinct kernel call held against its plain
    version, its own checks held, its host-clock seconds printed; then the
    Table-4 columns' kernel route against the plain route
    (``table4_phase``)."""
    import tempfile
    import torch
    cnn = (0, 0)                 # the CNN scripts launch no SSD or flash
    launches, secs, held = {}, {}, {}

    def run(label, name, argv):
        out, launches[label], secs[label], held[label] = run_example(name,
                                                                     argv)
        return out

    out = run("quickstart", "quickstart", [])
    assert launches["quickstart"][0] > 0 and launches["quickstart"][2] > 0
    assert out["kernel_vs_oracle"] == 0.0, out["kernel_vs_oracle"]
    out = run("autoflow_inference", "autoflow_inference", [])
    assert out["bit_exact"]
    out = run("serving_throughput", "serving_throughput", [])
    assert out["retraces"] == 0
    out = run("serving_engine", "serving_engine", [])
    assert out["retraces"] == 0
    assert out["stats"]["retraces_since_warmup"] == 0
    out = run("zoo_inference", "zoo_inference", [])
    assert len(out["conformant"]) == 4 and all(out["conformant"].values())
    out = run("operating_point", "operating_point", [])
    assert out["rel_gap"] == 0.0 and out["rejected"]
    for label in ("autoflow_inference", "serving_throughput",
                  "serving_engine", "zoo_inference", "operating_point"):
        assert launches[label][0] > 0 and launches[label][1:] == cnn, (
            label, launches[label])

    out = run("heana_cnn_inference", "heana_cnn_inference", [])
    # 150 exact SGD steps (no photonic GEMM), then evaluate: 4 GEMMs under
    # each of int8, heana and maw through the TAOM kernel.
    assert launches["heana_cnn_inference"] == (12, 0, 0), launches
    losses = out["losses"]
    assert len(losses) == 150 and losses[-1] < losses[0], losses[::30]
    log(f"[examples] Table-4 on the card: 150 SGD steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; top-1 " +
        json.dumps(out["top1"], sort_keys=True) + "; drop % " +
        json.dumps(out["drop_pct"], sort_keys=True))
    import _table4
    table4 = table4_phase(dev, _table4, out["params"])
    del out

    run("serve_lm qwen2-0.5b", "serve_lm", ["--full", "--arch", QWEN_ARCH])
    assert launches["serve_lm qwen2-0.5b"] == (0, 0, 24)
    run("serve_lm mamba2-130m", "serve_lm", ["--full", "--arch", LM_ARCH])
    assert launches["serve_lm mamba2-130m"] == (0, 24, 0)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--ckpt-every", "3", "--ckpt-dir", ckpt]
        first = run("train_lm", "train_lm", ["--steps", "3"] + argv)
        resumed = run("train_lm resume", "train_lm", ["--steps", "6"] + argv)
    assert first["steps"] == 3 and resumed["steps"] == 3, (first, resumed)
    assert launches["train_lm"] == launches["train_lm resume"] == (0, 0, 0)
    torch.cuda.empty_cache()

    out = run("photonic_qat", "photonic_qat",
              ["--steps", str(QAT_EXAMPLE_STEPS)])
    assert launches["photonic_qat"][0] > 0 and out["dpe_size"] == 83
    log("[examples] host-clock seconds per script: " +
        json.dumps({k: round(v, 3) for k, v in secs.items()}))
    # Per wrapper, over every script: distinct calls held, worst error.
    summary = {}
    for rows in held.values():
        for name, row in rows.items():
            acc = summary.setdefault(name, {"signatures": 0,
                                            "max_abs_err": 0.0})
            acc["signatures"] += row["signatures"]
            acc["max_abs_err"] = max(acc["max_abs_err"], row["max_abs_err"])
    log("[examples] kernel calls held against their plain versions over "
        "the ten scripts: " + json.dumps(summary, sort_keys=True))
    return {"launches": launches, "seconds": secs, "table4": table4,
            "held": summary}


# ---------------------------------------------------------------------------
# Phase 14: distribution
# ---------------------------------------------------------------------------
DIST_GEN = 16                    # greedy decode steps through decode_fn(dist)
DIST_LOSS_BATCH, DIST_LOSS_SEQ = 8, 256
DIST_BF16_TOL = 2.0 ** -5        # bf16 logits, dist vs LOCAL (the tests')
DIST_BF16_SEEDS = (0, 1, 2, 3)   # the weights the bf16 chain is read from
DIST_F32_TOL = 1e-4              # float32 logits and gradients (the tests')
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_FLOOR = 1e-6
DIST_RANKS = 2                   # phase 14(b): processes on the one card
DIST_JOIN_S = 300.0
DIST_N = 83                      # phase 14(c): the request's images


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(fn, dev, iters: int = 3) -> float:
    """Host clock per call of fn(), synchronized, after one warm call."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e3


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() /
                 want.float().abs().max())


def _greedy_dist(params, cfg, prompts, dist, dev, gen: int):
    """prefill_fn(dist) + gen - 1 greedy decode_fn(dist) steps: (tokens
    (B, gen), per-step logits (float32, on the device))."""
    import torch
    from repro_torch.models import model_zoo as zoo
    b, p = prompts.shape
    caches = zoo.init_caches(cfg, b, p + gen, getattr(torch, cfg.dtype), dev)
    logits, state = zoo.prefill_fn(params, {"tokens": prompts}, cfg, caches,
                                   dist=dist)
    outs, toks = [logits[:, -1].float()], [logits[:, -1].float().argmax(-1)]
    for i in range(gen - 1):
        logits, state = zoo.decode_fn(params, toks[-1][:, None], p + i, cfg,
                                      state, dist=dist)
        outs.append(logits[:, -1].float())
        toks.append(outs[-1].argmax(-1))
    return torch.stack(toks, 1), outs


def _forced(params, cfg, prompts, toks, dist, dev):
    """The same prefill and steps fed ``toks`` (teacher forcing): the
    per-step logits."""
    import torch
    from repro_torch.models import model_zoo as zoo
    b, p = prompts.shape
    gen = toks.shape[1]
    caches = zoo.init_caches(cfg, b, p + gen, getattr(torch, cfg.dtype), dev)
    logits, state = zoo.prefill_fn(params, {"tokens": prompts}, cfg, caches,
                                   dist=dist)
    outs = [logits[:, -1].float()]
    for i in range(gen - 1):
        logits, state = zoo.decode_fn(params, toks[:, i:i + 1], p + i, cfg,
                                      state, dist=dist)
        outs.append(logits[:, -1].float())
    return outs


def _tokens_differ(toks, local_logits) -> int:
    """Steps x rows whose LOCAL argmax differs from the dist token.  Not a
    check of its own: the dist token is the argmax of the dist logits, so
    LOCAL's margin for its own pick over it is at most the |dist - LOCAL|
    at those two entries, which the logits bound already holds."""
    return sum(int((ll.argmax(-1) != toks[:, i]).sum())
               for i, ll in enumerate(local_logits))


def _bf16_chain(params, cfg, prompts, dist, dev, launches: bool) -> dict:
    """The served width in bf16: prefill_fn
    (dist) with the flash kernel and DIST_GEN greedy steps through
    decode_fn(dist) (flash_decode_gqa), against the LOCAL prefill and
    steps fed the same tokens; with ``launches``, the kernel counts and
    flash_decode_gqa's calls in the dist run."""
    from repro_torch.models import attention as A
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe as M
    out = {}
    calls = []
    real = A.flash_decode_gqa
    A.flash_decode_gqa = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        if launches:
            zero_counts()
        toks, dist_logits = _greedy_dist(params, cfg, prompts, dist, dev,
                                         DIST_GEN)
        _sync(dev)
        if launches:
            out["launches"] = counts()
        out["flash_decode_calls"] = len(calls)
    finally:
        A.flash_decode_gqa = real
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    local_logits = _forced(params, cfg, prompts, toks, M.LOCAL, dev)
    out["rel"] = max(_rel(d, l) for d, l in zip(dist_logits, local_logits))
    out["tokens_differ"] = _tokens_differ(toks, local_logits)
    out["toks"] = toks
    assert out["rel"] <= DIST_BF16_TOL, out["rel"]
    return out


def _dist_world_one(dev, smoke: bool) -> dict:
    """14(a): a world of one (NCCL on the card), mesh (1, 1)."""
    import dataclasses
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model_zoo as zoo
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.optim import compression as C
    from repro_torch.parallel import pipeline_parallel as PP
    from repro_torch.parallel import sharded_ce
    row = {}
    mesh = make_local_mesh(device_type=dev.type)
    dist = M.DistCtx(mesh)
    row["backend"] = tdist.get_backend()
    assert tuple(mesh.shape) == (1, 1) and dist.model_shards == 1
    cfg = get_config(QWEN_ARCH, smoke=smoke)
    batch, prompt = (LM_BATCH, LM_PROMPT) if not smoke else (2, 24)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(14)) \
        .to(dev)
    params = zoo.init_params(cfg, 0, dev)
    row["held_bytes"] = held_memory()[0] if dev.type == "cuda" else 0

    # bf16, the served width: the main path's run from seed 0's weights,
    # then the same chain from DIST_BF16_SEEDS' others, each held to the
    # bound (its readings give the bound's headroom at this width).
    chains = {}
    for seed in DIST_BF16_SEEDS:
        p = params if seed == 0 else zoo.init_params(cfg, seed, dev)
        chains[seed] = _bf16_chain(p, cfg, prompts, dist, dev, seed == 0)
        del p
    first = chains[0]
    row["launches"] = first["launches"]
    row["flash_decode_calls"] = first["flash_decode_calls"]
    assert row["launches"] == (0, 0, cfg.num_layers if dev.type == "cuda"
                               else 0), row["launches"]
    assert row["flash_decode_calls"] == cfg.num_layers * (DIST_GEN - 1)
    row["bf16_logits_rel"] = {seed: c["rel"] for seed, c in chains.items()}
    row["bf16_tokens_differ"] = {seed: c["tokens_differ"]
                                 for seed, c in chains.items()}
    toks = first["toks"]
    del chains
    row["decode_step_ms"] = {}
    caches = zoo.init_caches(cfg, batch, prompt + 8, torch.bfloat16, dev)
    _, state = zoo.prefill_fn(params, {"tokens": prompts}, cfg, caches)
    tok = toks[:, :1]
    for name, d in (("LOCAL", M.LOCAL), ("dist", dist)):
        row["decode_step_ms"][name] = _host_ms(
            lambda d=d: zoo.decode_fn(params, tok, prompt + 1, cfg, state,
                                      dist=d), dev)
    if dev.type == "cuda":
        row["decode_profile"] = {
            name: profile(lambda d=d: zoo.decode_fn(
                params, tok, prompt + 1, cfg, state, dist=d), 3, "flash")
            for name, d in (("LOCAL", M.LOCAL), ("dist", dist))}
    del state, caches

    # float32 copy: the greedy tokens equal LOCAL's, logits within 1e-4.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = zoo.init_params(cfg32, 0, dev)
    toks32, dl32 = _greedy_dist(params32, cfg32, prompts, dist, dev, DIST_GEN)
    ltoks32, ll32 = _greedy_dist(params32, cfg32, prompts, M.LOCAL, dev,
                                 DIST_GEN)
    row["f32_logits_rel"] = max(_rel(d, l) for d, l in zip(dl32, ll32))
    assert torch.equal(toks32, ltoks32), (toks32, ltoks32)
    assert row["f32_logits_rel"] <= DIST_F32_TOL, row["f32_logits_rel"]

    # One loss_fn(dist) step through the sharded CE, float32 (the tests'
    # bounds: loss rtol 1e-5, gradients 1e-4 of the largest), then timed in
    # bf16; then allreduce_compressed of the gradients over the group of 1.
    lb, ls = (DIST_LOSS_BATCH, DIST_LOSS_SEQ) if not smoke else (2, 16)
    seq = torch.randint(0, cfg.vocab_size, (lb, ls + 1),
                        generator=torch.Generator().manual_seed(15)).to(dev)
    lbatch = {"tokens": seq[:, :-1], "targets": seq[:, 1:]}
    assert sharded_ce.supports(cfg.vocab_size, dist)

    def step(p0, c, d):
        p = tree_map(lambda t: t.detach().requires_grad_(), p0)
        loss = zoo.loss_fn(p, lbatch, c, dist=d)
        loss.backward()
        return loss.detach(), {k: t.grad for k, t in tree_leaves(p)}
    loss_l, grads_l = step(params32, cfg32, M.LOCAL)
    loss_d, grads_d = step(params32, cfg32, dist)
    row["loss_rel"] = abs(float(loss_d) - float(loss_l)) / abs(float(loss_l))
    assert row["loss_rel"] <= DIST_LOSS_RTOL, row["loss_rel"]
    floor = DIST_GRAD_FLOOR * max(float(g.abs().max())
                                  for g in grads_l.values())
    row["grad_rel"] = 0.0
    for key, g in grads_d.items():
        err = float((g - grads_l[key]).abs().max())
        scale = float(grads_l[key].abs().max())
        assert err <= max(DIST_F32_TOL * scale, floor), (key, err, scale)
        row["grad_rel"] = max(row["grad_rel"], err / max(scale, floor))
    row["loss_step_ms"] = {name: _host_ms(lambda d=d: step(params, cfg, d),
                                          dev, iters=2)
                           for name, d in (("LOCAL", M.LOCAL),
                                           ("dist", dist))}
    grads = {"/".join(map(str, k)): g for k, g in grads_d.items()}
    reduced, _ = C.allreduce_compressed(grads, C.init_state(grads),
                                        mesh.get_group("data"))
    comp, _ = C.compress_grads(grads, C.init_state(grads))
    plain = C.decompress_grads(comp)
    assert all(torch.equal(reduced[k], plain[k]) for k in grads)
    row["compressed_leaves"] = len(grads)
    row["compression_ratio"] = C.compression_ratio(grads)
    row["allreduce_compressed_ms"] = _host_ms(
        lambda: C.allreduce_compressed(grads, C.init_state(grads),
                                       mesh.get_group("data")), dev, iters=2)
    del grads_l, grads_d, grads, reduced, plain, comp

    # pipeline_forward at one stage against the layers run in turn.
    from torch.distributed.device_mesh import init_device_mesh
    stage_mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("stage",))
    gen = torch.Generator(device=dev).manual_seed(16)
    d_model = cfg.d_model
    sp = {"w": torch.randn((1, d_model, d_model), generator=gen,
                           device=dev) * d_model ** -0.5,
          "b": torch.randn((1, d_model), generator=gen, device=dev)}
    xs = torch.randn((8, 256 if not smoke else 4, d_model), generator=gen,
                     device=dev)

    def block(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    got = PP.pipeline_forward(block, sp, xs, stage_mesh, "stage")
    want = torch.stack([block({k: v[0] for k, v in sp.items()}, x)
                        for x in xs])
    assert torch.equal(got, want)
    row["pipeline_bubble"] = PP.bubble_fraction(1, 8)
    del params, params32
    return row


def _stage_all_reduce(tdist) -> str:
    """Gloo's all-reduce on CUDA tensors, or — if this build has none —
    an explicit copy through the host around it: which one is used."""
    import torch
    probe = torch.ones(4, device="cuda")
    try:
        tdist.all_reduce(probe, op=tdist.ReduceOp.MAX)
        tdist.all_reduce(probe)
        torch.cuda.synchronize()
        return "gloo on CUDA tensors"
    except RuntimeError:
        real = tdist.all_reduce

        def staged(t, op=tdist.ReduceOp.SUM, group=None, async_op=False):
            host = t.cpu()
            real(host, op=op, group=group)
            t.copy_(host)
        tdist.all_reduce = staged
        return "gloo through the host (no CUDA all-reduce in this gloo)"


def _moe_inputs(cfg, dev, smoke):
    """deepseek-v2's MoE layer weights and input, seeded, on the card (the
    same values in every process)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(17)
    m = cfg.moe
    e, d, f = m.num_experts, cfg.d_model, m.d_ff_expert

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=dev) *
                shape[-2] ** -0.5).to(torch.bfloat16)
    p = {"router": w(d, e), "gate": w(e, d, f), "up": w(e, d, f),
         "down": w(e, f, d),
         "shared": {"up": {"w": w(d, m.num_shared_experts * f)},
                    "gate": {"w": w(d, m.num_shared_experts * f)},
                    "down": {"w": w(m.num_shared_experts * f, d)}}}
    x = torch.randn((MOE_BATCH, MOE_PROMPT if not smoke else 6, d),
                    generator=gen, device=dev).to(torch.bfloat16)
    return p, x


def _dist_rank(rank: int, world: int, store: str, out_dir: str,
               smoke: bool) -> None:
    """14(b): one of the processes on the one card (gloo)."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    dev = torch.device("cuda" if not smoke else "cpu")
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    try:
        out = {"collectives": (_stage_all_reduce(tdist) if dev.type == "cuda"
                               else "gloo on CPU tensors")}
        mesh = make_local_mesh(model=world, device_type=dev.type)
        dist = M.DistCtx(mesh)
        # The MoE layer, experts split world ways.
        mcfg = get_config(MOE_ARCH, smoke=smoke)
        p, x = _moe_inputs(mcfg, dev, smoke)
        e_loc = mcfg.moe.num_experts // world
        sl = slice(rank * e_loc, (rank + 1) * e_loc)
        mine = {**p, **{k: p[k][sl].contiguous()
                        for k in ("gate", "up", "down")}}
        out["moe"] = M.moe_ffn(mine, x, mcfg.moe, dist=dist).cpu()
        out["moe_ms"] = _host_ms(lambda: M.moe_ffn(mine, x, mcfg.moe,
                                                   dist=dist), dev)
        del p, mine
        # qwen2's decode attention over a cache split over the ranks.
        q_in = _decode_inputs(dev, smoke)
        out["decode"] = A.flash_decode_gqa(*q_in, dist=dist).cpu()
        out["decode_ms"] = _host_ms(
            lambda: A.flash_decode_gqa(*q_in, dist=dist), dev, iters=10)
        # The sharded CE, qwen2's vocab split world ways.
        table, hidden, targets = _ce_inputs(dev, smoke)
        out["ce"] = _ce_step(table, hidden, targets, dist)
        out["ce_ms"] = _host_ms(
            lambda: _ce_step(table, hidden, targets, dist), dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        tdist.barrier()
    finally:
        tdist.destroy_process_group()


def _decode_inputs(dev, smoke):
    """q, k, v, pos, q_pos, spec of qwen2-0.5b's decode attention at
    LM_BATCH, LM_PROMPT + DIST_GEN slots (bf16, seeded)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import attn_spec
    cfg = get_config(QWEN_ARCH, smoke=smoke)
    spec = attn_spec(cfg)
    b, slots = (LM_BATCH, LM_PROMPT + DIST_GEN) if not smoke else (2, 32)
    gen = torch.Generator(device=dev).manual_seed(18)
    q = torch.randn((b, 1, spec.num_heads, spec.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, slots, spec.num_kv_heads, spec.head_dim),
                        generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    pos = torch.arange(slots, dtype=torch.int32, device=dev).repeat(b, 1)
    pos[:, slots - 5:] = -1                       # slots not yet written
    q_pos = torch.full((b, 1), slots - 6, dtype=torch.int32, device=dev)
    return q, k, v, pos, q_pos, spec


def _ce_inputs(dev, smoke):
    """qwen2-0.5b's head table and a DIST_LOSS_BATCH x DIST_LOSS_SEQ batch
    of hidden states and targets, float32, seeded."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(QWEN_ARCH, smoke=smoke)
    b, s = (DIST_LOSS_BATCH, DIST_LOSS_SEQ) if not smoke else (2, 16)
    gen = torch.Generator(device=dev).manual_seed(19)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                        device=dev) * cfg.d_model ** -0.5
    hidden = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    targets = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev)
    return table, hidden, targets


def _ce_step(table, hidden, targets, dist) -> dict:
    """sharded_xent's loss and its gradients (table, hidden), on the
    CPU."""
    from repro_torch.parallel import sharded_ce
    t = table.detach().requires_grad_()
    h = hidden.detach().requires_grad_()
    loss = sharded_ce.sharded_xent(t, h, targets, dist)
    loss.backward()
    return {"loss": loss.detach().cpu(), "table": t.grad.cpu(),
            "hidden": h.grad.cpu()}


def _dist_two_ranks(dev, smoke: bool) -> dict:
    """14(b): DIST_RANKS processes on the one card, gloo; each rank's
    results against the same computation in this process (its world of
    one, mesh (1, 1))."""
    import tempfile
    import torch
    import torch.multiprocessing as tmp
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t0 = time.perf_counter()
    ctx = tmp.start_processes(_dist_rank, args=(DIST_RANKS, os.path.join(
        tmpdir, "store"), tmpdir, smoke), nprocs=DIST_RANKS, join=False,
        start_method="spawn")
    deadline = time.monotonic() + DIST_JOIN_S
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "phase 14(b) ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    row = {"spawn_s": time.perf_counter() - t0}
    outs = [torch.load(os.path.join(tmpdir, f"rank{r}.pt"))
            for r in range(DIST_RANKS)]
    row["collectives"] = outs[0]["collectives"]

    # MoE: every rank's all-reduced output == the shards' bodies summed
    # here, plus the shared experts, bit for bit.
    mcfg = get_config(MOE_ARCH, smoke=smoke)
    p, x = _moe_inputs(mcfg, dev, smoke)
    e_loc = mcfg.moe.num_experts // DIST_RANKS
    routed = None
    for s in range(DIST_RANKS):
        sl = slice(s * e_loc, (s + 1) * e_loc)
        part = M._routed_local(p["router"], p["gate"][sl], p["up"][sl],
                               p["down"][sl], x, mcfg.moe, DIST_RANKS, s)
        routed = part if routed is None else routed + part
    want = (L.mlp(p["shared"], x, L.EXACT_CTX, "moe.shared") + routed).cpu()
    for r, o in enumerate(outs):
        assert torch.equal(o["moe"], want), r
    del p, routed
    # Decode attention: the ranks agree bit for bit, and with one rank.
    mesh = make_local_mesh(device_type=dev.type)
    q_in = _decode_inputs(dev, smoke)
    one = A.flash_decode_gqa(*q_in, dist=M.DistCtx(mesh)).cpu()
    row["decode_rel"] = _rel(outs[0]["decode"], one)
    assert all(torch.equal(o["decode"], outs[0]["decode"]) for o in outs)
    assert row["decode_rel"] <= 2.0 ** -7, row["decode_rel"]
    # The sharded CE: loss and gradients against one rank.
    ce_one = _ce_step(*_ce_inputs(dev, smoke), M.DistCtx(mesh))
    row["ce_loss_rel"] = max(_rel(o["ce"]["loss"], ce_one["loss"])
                             for o in outs)
    row["ce_grad_rel"] = max(_rel(o["ce"][k], ce_one[k]) for o in outs
                             for k in ("table", "hidden"))
    assert row["ce_loss_rel"] <= DIST_LOSS_RTOL, row["ce_loss_rel"]
    assert row["ce_grad_rel"] <= DIST_F32_TOL, row["ce_grad_rel"]
    for k in ("moe_ms", "decode_ms", "ce_ms"):
        row[k] = [o[k] for o in outs]
    row["decode_one_rank_ms"] = _host_ms(
        lambda: A.flash_decode_gqa(*q_in, dist=M.DistCtx(mesh)), dev,
        iters=10)
    return row


def _dist_serving(dev, entries) -> dict:
    """14(c): data-parallel serving of resnet_mini over ``entries`` (two
    entries of the one card, or several cards), against the one-device
    engine on ``dev`` and the plain route."""
    import torch
    from repro_torch.core import perf_model as pm
    from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
    from repro_torch.exec import ServingEngine
    from repro_torch.models.zoo_cnn import ZOO
    model = ZOO["resnet_mini"]
    params = model.init_params(torch.Generator().manual_seed(0), device=dev)
    acc = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    kw = dict(lowering=model.graph, in_hw=model.in_hw, max_batch=64,
              device=dev)
    one = ServingEngine(params, acc, cfg, **kw)
    one.warmup()
    zero_counts()
    dp = ServingEngine(params, acc, cfg, data_parallel=True,
                       devices=entries, plan_cache=one.plan_cache, **kw)
    assert dp.data_parallel and dp.stats()["n_devices"] == len(entries)
    x = torch.randn((DIST_N, *model.in_hw, model.in_ch),
                    generator=torch.Generator().manual_seed(20)).to(dev)
    # Every TAOM call of the data-parallel path, at its shard shapes with
    # the pinned row, is recorded (the eager run before each capture) and
    # held against its plain version on the same inputs.
    with recorded_calls() as (calls, captured):
        dp.warmup()
        got = dp.infer(x)
        _sync(dev)
    row = {"launches": counts()}
    row["held"] = hold_calls("data-parallel serving", calls, captured)
    assert row["held"] or dev.type != "cuda"
    assert torch.equal(got, one.infer(x))
    assert torch.equal(got, plain_served(dp, params, x, cfg, model.graph,
                                         dev))
    for n in (1, 3, 17, 64):
        got = dp.infer(x[:n])
        assert torch.equal(got, one.infer(x[:n])), n
        assert torch.equal(got, plain_served(dp, params, x[:n], cfg,
                                             model.graph, dev)), n
    row["request_ms"] = {name: _host_ms(lambda e=e: e.infer(x), dev,
                                        iters=10)
                         for name, e in (("one", one), ("data_parallel", dp))}
    s = dp.stats()
    assert s["retraces_since_warmup"] == 0 and s["data_parallel"]
    row["retraces_since_warmup"] = s["retraces_since_warmup"]
    if dev.type == "cuda":
        row["profile"] = {name: profile(lambda e=e: e.infer(x), 3,
                                        "taom_gemm")
                          for name, e in (("one", one), ("data_parallel",
                                                          dp))}
    return row


def plain_served(engine, params, x, cfg, lowering, dev):
    """What ``engine.infer(x)`` must return: each top-bucket chunk of x,
    zero-padded to its bucket, through ``execute_cnn(impl="ref",
    compiled=False)`` (the plain TAOM route, op by op, one device)."""
    import torch
    from repro_torch.exec import execute_cnn
    want = []
    for lo in range(0, x.shape[0], engine.max_bucket):
        chunk = x[lo:lo + engine.max_bucket]
        n = chunk.shape[0]
        bucket = next(b for b in engine.buckets if b >= n)
        xb = torch.cat([chunk, chunk.new_zeros((bucket - n,) +
                                               tuple(chunk.shape[1:]))])
        res = execute_cnn(params, xb, engine.plans[bucket], cfg, impl="ref",
                          lowering=lowering, device=dev, compiled=False)
        want.append(res.logits[:n])
    return torch.cat(want)


def dist_phase(dev, smoke: bool = False) -> dict:
    """Phase 14: distribution on torch.distributed."""
    import torch.distributed as tdist
    t0 = time.perf_counter()
    row = {"world_one": _dist_world_one(dev, smoke)}
    a = row["world_one"]
    log(f"[dist] (a) world of one over {a['backend']}, mesh (1, 1), "
        f"{QWEN_ARCH}: prefill_fn(dist) flash launches "
        f"{a['launches'][2]}, decode_fn(dist) through flash_decode_gqa "
        f"{a['flash_decode_calls']} times; bf16 logits vs LOCAL "
        f"of max by weight seed {json.dumps(a['bf16_logits_rel'])} (bound "
        f"{DIST_BF16_TOL}, largest "
        f"{max(a['bf16_logits_rel'].values()):.3e}), greedy tokens "
        f"differing {json.dumps(a['bf16_tokens_differ'])} of "
        f"{LM_BATCH * DIST_GEN}; float32 tokens equal, logits "
        f"{a['f32_logits_rel']:.3e}; decode step ms "
        f"{json.dumps(a['decode_step_ms'])} (host clock); loss_fn(dist) "
        f"float32 loss rel {a['loss_rel']:.3e}, gradients "
        f"{a['grad_rel']:.3e}; loss step ms {json.dumps(a['loss_step_ms'])}"
        f"; allreduce_compressed of {a['compressed_leaves']} gradient "
        f"leaves bit-equal to decompress(compress(g)), ratio "
        f"{a['compression_ratio']:.3f}, "
        f"{a['allreduce_compressed_ms']:.2f} ms; pipeline_forward at one "
        f"stage == the layer; {a['held_bytes'] / 2**30:.2f} GiB held with "
        f"the bf16 params")
    if "decode_profile" in a:
        log("[dist] (a) decode step profile: " + json.dumps(
            {k: {f: v[f] for f in ("device_busy_ms_per_run",
                                   "device_idle_share",
                                   "device_kernels_per_run")}
             for k, v in a["decode_profile"].items()}))
    row["two_ranks"] = _dist_two_ranks(dev, smoke)
    b = row["two_ranks"]
    log(f"[dist] (b) {DIST_RANKS} processes on one device, {b['collectives']}"
        f": {MOE_ARCH} MoE layer (experts split {DIST_RANKS} ways) "
        f"bit-equal to the shards' bodies summed, {b['moe_ms']} ms; "
        f"{QWEN_ARCH} decode attention over 2 sequence shards "
        f"{b['decode_rel']:.3e} of one rank's max, {b['decode_ms']} ms "
        f"(one rank {b['decode_one_rank_ms']:.3f}); sharded CE loss rel "
        f"{b['ce_loss_rel']:.3e}, gradients {b['ce_grad_rel']:.3e}, "
        f"{b['ce_ms']} ms; spawn to join {b['spawn_s']:.1f} s")
    tdist.destroy_process_group()
    row["serving"] = _dist_serving(dev, [dev, dev])
    log_dist_serving(row["serving"], [dev, dev])
    row["seconds"] = time.perf_counter() - t0
    log(f"[time] phase 14: {row['seconds']:.1f} s host clock"
        + (f", on {card_line()}" if dev.type == "cuda" else ""))
    return row


def log_dist_serving(c: dict, entries) -> None:
    log(f"[dist] (c) resnet_mini data-parallel over "
        f"{[str(d) for d in entries]} at N = {DIST_N}: logits bit-equal "
        f"to one device and to execute_cnn(impl='ref', compiled=False), also at N = 1, 3, 17, "
        f"64; the path's TAOM calls bit-equal to their plain versions, "
        f"by wrapper {json.dumps(c['held'])}; "
        f"retraces_since_warmup {c['retraces_since_warmup']}, TAOM "
        f"launches {c['launches'][0]} (warmup + the checks); request ms "
        f"{json.dumps(c['request_ms'])} (host clock); profile "
        + json.dumps({k: {f: v[f] for f in (
            "device_busy_ms_per_run", "device_idle_share",
            "kernel_launches_per_run")}
            for k, v in c.get("profile", {}).items()}))


def dist_serving_only() -> int:
    """``--dist-serving``: phase 14(c) alone, over two entries of card 0
    and then over every visible card (with more than one), each beside
    the one-device engine on card 0."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    n = torch.cuda.device_count()
    runs = [[dev, dev]]
    if n > 1:
        runs.append([torch.device("cuda", i) for i in range(n)])
    for entries in runs:
        log_dist_serving(_dist_serving(dev, entries), entries)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    log(f"[dist] {n} cards visible: " + "; ".join(cards.split("\n")[:n]))
    return 0


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
    t_start = time.perf_counter()
    sys.path.insert(0, SRC)
    if sys.argv[1:] == ["--dist-serving"]:
        return dist_serving_only()
    from repro_torch.core import perf_model as pm
    from repro_torch.core.taom import quantize
    from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
    from repro_torch.exec import (MicroBatcher, ServingEngine, execute_cnn,
                                  trace_count)
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
    # The engine captures each bucket's forward in a CUDA graph at warmup
    # (an eager warm run, then the capture: 13 wrapper calls each) and
    # replays it for every request (no wrapper call).
    img_gen = torch.Generator(device=dev)
    img_gen.manual_seed(2)
    sizes = (1, 3, 17, 64, 100)
    requests = [torch.randn((n, *model.in_hw, model.in_ch), generator=img_gen,
                            device=dev) for n in sizes]
    mem0 = held_memory()
    captures0 = trace_count()
    zero_counts()
    cold = engine.warmup()
    captured = trace_count() - captures0
    at_warmup = taom_gemm.LAUNCHES
    mem1 = held_memory()
    served = [engine.infer(x) for x in requests]
    torch.cuda.synchronize()
    launches = taom_gemm.LAUNCHES
    assert ssd_scan.LAUNCHES == flash_attention.LAUNCHES == 0, (
        ssd_scan.LAUNCHES, flash_attention.LAUNCHES)
    stats = engine.stats()
    assert captured == len(cold) == len(engine.buckets) == 7, (captured, cold)
    assert stats["retraces_since_warmup"] == 0, stats
    assert at_warmup == launches == 2 * n_gemms * len(cold), (
        at_warmup, launches, n_gemms)
    log(f"[serving] warmup: {captured} CUDA graphs captured (buckets "
        f"{list(engine.buckets)}), cold seconds " + json.dumps(cold) +
        f"; {launches} TAOM wrapper calls = {n_gemms} x 2 (eager warm run "
        f"+ capture) x {len(cold)} buckets, 0 in {stats['batches']} served "
        f"bucket forwards (graph replays); retraces_since_warmup "
        f"{stats['retraces_since_warmup']}")
    log(f"[serving] the 7 buckets' graphs hold "
        f"{(mem1[0] - mem0[0]) / 2**20:.2f} MiB allocated, "
        f"{(mem1[1] - mem0[1]) / 2**20:.2f} MiB reserved (torch.cuda "
        f"memory_allocated / memory_reserved across warmup, the cache "
        f"emptied before each reading; one private pool each)")
    for x, got in zip(requests, served):
        want = plain_served(engine, params, x, main_cfg, model.graph, dev)
        assert got.shape == (x.shape[0], model.num_classes), got.shape
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want), (
            x.shape[0], (got - want).abs().max().item())
    log(f"[serving] graphed logits of {list(sizes)}-image requests bit-equal "
        f"to execute_cnn(impl='ref', compiled=False)")
    noisy_cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                               noise_enabled=True)
    noisy = ServingEngine(params, acc, noisy_cfg, lowering=model.graph,
                          in_hw=model.in_hw, max_batch=8, device=dev)
    noisy.warmup()
    x5 = requests[2][:5]
    a = noisy.infer(x5, seed=1234)
    b = noisy.infer(x5, seed=1234)
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    x8 = torch.cat([x5, x5.new_zeros((3,) + tuple(x5.shape[1:]))])
    eager_noisy = execute_cnn(params, x8, noisy.plans[8], noisy_cfg,
                              seed=1234, lowering=model.graph, device=dev,
                              compiled=False).logits[:5]
    assert torch.equal(a, eager_noisy), (a - eager_noisy).abs().max().item()
    assert noisy.stats()["retraces_since_warmup"] == 0
    quiet = engine.infer(x5)                       # same bucket, noise off
    assert not torch.equal(a, quiet), "noise had no effect"
    log("[serving] noisy request: graphed logits finite, identical from one "
        "seed and bit-equal to the eager forward from that seed")

    # MicroBatcher: 64 single-image submits coalesced into bucketed batches.
    singles = list(requests[3])
    t0 = time.perf_counter()
    with MicroBatcher(engine, max_delay_s=0.002) as mb:
        futs = [mb.submit(img) for img in singles]
        outs = [f.result(timeout=120) for f in futs]
    mb_ms = (time.perf_counter() - t0) * 1e3
    assert all(o.shape == (model.num_classes,) and
               bool(torch.isfinite(o).all()) for o in outs)
    mb_stats = mb.stats()
    assert mb_stats["requests_batched"] == len(singles), mb_stats
    # Rows: the 64 submits queued before the worker starts form one batch,
    # whose Futures must hold the rows of one 64-image request (the
    # activations' quantization scale is per batch, so only the same
    # batch gives the same bits).
    mb1 = MicroBatcher(engine, max_delay_s=0.05)
    futs = [mb1.submit(img) for img in singles]
    mb1.start()
    rows = [f.result(timeout=120) for f in futs]
    mb1.stop()
    whole = engine.infer(torch.stack(singles))
    assert mb1.stats()["batches_formed"] == 1, mb1.stats()
    assert all(torch.equal(r, whole[i]) for i, r in enumerate(rows))
    assert engine.stats()["retraces_since_warmup"] == 0
    log(f"[serving] MicroBatcher: {len(singles)} single-image submits in "
        f"{mb_ms:.3f} ms host clock, " + json.dumps(mb_stats, sort_keys=True)
        + f"; {len(singles)} submits queued before start: one batch, each "
        f"Future bit-equal to its row of one {len(singles)}-image request")
    log("[serving] stats " + json.dumps(engine.stats(), sort_keys=True))

    # Bucket-32 requests: host clock, then where the device's time goes,
    # graphed (engine.infer) beside the eager forward (compiled=False).
    x32 = requests[4][:BATCH]
    eager32 = lambda: execute_cnn(                     # noqa: E731
        params, x32, engine.plans[BATCH], main_cfg, lowering=model.graph,
        device=dev, compiled=False)
    cnn_rows = {}
    for name, fn in (("graphed", lambda: engine.infer(x32)),
                     ("eager", eager32)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / REQUESTS * 1e3
        split = profile(fn, REQUESTS, "taom_gemm", split=taom_gemm.KERNELS)
        cnn_rows[name] = {"wall_ms": wall_ms, **split}
        log(f"[serving] bucket-32 request, {name}, {REQUESTS} runs: "
            f"{wall_ms:.4f} ms host clock unprofiled; per request under the "
            f"profiler: " + json.dumps(split, sort_keys=True))
        assert split["kernel_launches_per_run"] == 2 * n_gemms, (name, split)
    split = cnn_rows["graphed"]
    log(f"[serving] bucket-32: graphed {split['wall_ms']:.4f} ms host clock, "
        f"{split['device_busy_ms_per_run']:.4f} ms device busy, idle "
        f"{split['device_idle_share']:.1%}, "
        f"{split['device_kernels_per_run']:g} kernels (the profiler sees "
        f"the kernels a graph launches); eager "
        f"{cnn_rows['eager']['wall_ms']:.4f} ms, "
        f"{cnn_rows['eager']['device_busy_ms_per_run']:.4f} ms busy, idle "
        f"{cnn_rows['eager']['device_idle_share']:.1%}, "
        f"{cnn_rows['eager']['device_kernels_per_run']:g} kernels")
    log(f"[serving] the TAOM route's {split['kernel_launches_per_run']:g} "
        f"kernels (2 per GEMM) take {split['kernel_ms_per_run']:.5f} ms on "
        f"the graphed path (profiler; absmax "
        f"{split['split_ms_per_run']['taom_gemm_absmax']:.5f}, int8 GEMM "
        f"{split['split_ms_per_run']['taom_gemm_int8']:.5f}) vs "
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

    # -- 8-10. the hybrid, VLM and encoder-decoder families at full width -----
    families = {arch: family_phase(dev, tag, arch, b, p)
                for tag, arch, b, p in FAMILIES}

    # -- 11. the moe family: deepseek-v2-236b, then deepseek-v3-671b, at full
    # width, cut in depth, one model at a time -----------------------------
    families[MOE_ARCH] = moe_phase(dev)
    families[MOE_V3_ARCH] = moe_v3_phase(dev)

    # -- 12. training on the card -------------------------------------------
    trained = train_phase(dev)

    # -- 13. the ten examples on the card ------------------------------------
    examples = examples_phase(dev)
    log(f"[time] phases 1-13: {time.perf_counter() - t_start:.1f} s host "
        f"clock, the kernels' build included")

    # -- 14. distribution on torch.distributed --------------------------------
    dist = dist_phase(dev)

    # -- 15. report -----------------------------------------------------------
    # Each kernel's launches on the served, trained and example paths, each
    # path driven with the counts set to 0 just before it and read just
    # after.
    by_path = {"resnet_mini": (launches, 0, 0),
               LM_ARCH: (0, lm["launches"], 0),
               QWEN_ARCH: (0, 0, qwen["launches"])}
    by_path.update({arch: row["launches"] for arch, row in families.items()})
    by_path[f"{TRAIN_ARCH} train"] = trained["exact"]["launches"]
    by_path[f"{TRAIN_ARCH} train photonic_heana"] = (
        trained["qat"]["launches"], 0, 0)
    by_path.update({f"examples/{label}": n
                    for label, n in examples["launches"].items()})
    by_path[f"{QWEN_ARCH} dist"] = dist["world_one"]["launches"]
    by_path["resnet_mini data-parallel"] = dist["serving"]["launches"]
    # The example paths' distinct kernel calls, each held against its plain
    # version after its script ran (phase 13), per wrapper.
    held = examples["held"]
    taom_held = [held[w] for w in ("taom_gemm_quantized", "taom_gemm_fused")
                 if w in held]
    entry = {
        "name": "taom_gemm_quantized",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/taom_gemm.cu",
        "replaces": "src/repro/kernels/taom_gemm.py:120",
        # Wrapper calls on the main path: the eager warm run and the
        # capture of each bucket's graph (13 each); phase 3's served
        # requests replay the graphs and call no wrapper (the profiler
        # counts the replayed TAOM kernels: path_ms below).
        "launches": sum(n[0] for n in by_path.values()),
        "launches_by_path": {path: n[0] for path, n in by_path.items()},
        "max_abs_err": max([max_err] + [r["max_abs_err"]
                                        for r in taom_held]),
        "examples_held": {w: held[w] for w in ("taom_gemm_quantized",
                                               "taom_gemm_fused")
                          if w in held},
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
        # Photonic QAT's GEMMs (mamba2-130m, 8 x 256 tokens, 8-bit HEANA:
        # the float32 body), per call: the route a training forward takes
        # and the body alone, device time, beside the bound at the bf16
        # rate; launches are the QAT path's 5 steps.
        "qat": {r["gemm"]: {key: r[key] for key in (
            "m", "k", "d", "route_ms", "body_ms", "plain_ms", "bound_ms",
            "bound_by")} for r in trained["qat"]["gemms"]},
        # The Table-4 evaluation's photonic columns (phase 13: 8 bits, the
        # float32 body; HEANA N 2, MAW N 1, int8 N 83), per forward of 512
        # images: the kernel route and the plain route, device time,
        # beside the bound (noise bytes included).
        "table4": {numerics: {key: row[key] for key in (
            "dpe_size", "noise", "kernel_ms", "plain_ms", "bound_ms")}
            for numerics, row in examples["table4"].items()},
    }
    bh, l, p, s, q, _ = SSD_SHAPES[0]
    ssd_entry = {
        "name": "ssd_scan_chunked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:81",
        "launches": sum(n[1] for n in by_path.values()),
        "launches_by_path": {path: n[1] for path, n in by_path.items()},
        "max_abs_err": max(ssd["max_abs_err"],
                           held["ssd_scan_chunked"]["max_abs_err"]),
        "examples_held": held["ssd_scan_chunked"],
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
        # zamba2-7b's served call (batch 4 x 112 heads, P 64, S 64, the
        # prompt of 1000 padded to 1024), per call.
        "zamba2": {key: ssd["zamba2"][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "zamba2_path_ms": (families["zamba2-7b"]["profile"]
                           ["split_ms_per_run"]["ssd_scan"] /
                           families["zamba2-7b"]["launches"][1]),
    }
    bh, s, d, causal, window, dtype = FLASH_SHAPES[0]
    flash_entry = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:75",
        "launches": sum(n[2] for n in by_path.values()),
        "launches_by_path": {path: n[2] for path, n in by_path.items()},
        "max_abs_err": max(flash["max_abs_err"],
                           held["flash_attention_fwd"]["max_abs_err"]),
        "examples_held": held["flash_attention_fwd"],
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
        # The served shapes of zamba2-7b, llava-next-mistral-7b,
        # whisper-tiny's encoder and decoder prompt and deepseek-v2-236b's
        # MLA (D 192, the function's V width dv 128), per launch in bf16;
        # mla_path_ms is the profiler's flash time in one served deepseek
        # prefill divided by its launches.
        "families": [{key: r[key] for key in (
            "bh", "s", "d", "dv", "causal", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by")} for r in flash["families"]],
        "mla_path_ms": (families[MOE_ARCH]["profile"]["kernel_ms_per_run"] /
                        families[MOE_ARCH]["launches"][2]),
        "mla_v3_path_ms": (families[MOE_V3_ARCH]["profile"]
                           ["kernel_ms_per_run"] /
                           families[MOE_V3_ARCH]["launches"][2]),
    }
    print(json.dumps({"kernels": [entry, ssd_entry, flash_entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

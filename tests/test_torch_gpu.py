"""Port tests that need an NVIDIA CUDA card (marker ``gpu``; they skip
elsewhere).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

They hold the CUDA kernels against their plain PyTorch versions on the
card — the TAOM GEMM's two routes (the float32 body on pre-quantized
operands, and the fused int8 route with quantize and rescale inside) bit
for bit where the integer psums stay below 2^24 (asserted), the SSD scan
within rtol 1e-4 and atol 1e-4 * max|plain| (its sums run in another
order), the flash-attention kernel within rtol 1e-5 and atol 1e-5 *
max|plain| in float32 and one bf16 ulp of each query row's max|plain|
binade in bfloat16 (its online softmax sums over 64-key tiles, the plain
version's over 128-key blocks; the bf16 kernel's P reaches the tensor
cores as two bf16 terms, within 2^-17 of the float32 P) — and run the
zoo networks, a mamba2 prefill, a qwen2 prefill and the hybrid, VLM,
encoder-decoder and moe prefills end to end through the kernels — and
hold the compiled paths: the CNN forward captured in a CUDA graph
bit-equal to the eager forward for every resnet_mini bucket (both
policies, noise off and on from one seed), no capture after warmup, eight
threads served bitwise, data-parallel serving's per-entry graphs (two
entries of one card, and every card where there are two or more) bitwise
equal to one device and the plain route, and a graphed decode step equal
to the eager one
— and hold training on the card: gradients through the default forward
bit-equal to the plain routes' (the forward-only SSD and flash kernels
stay out of a backward), and the trainer's loss, resume and photonic QAT
through the TAOM kernel — and hold the small CNN's Table-4 columns
(``examples_torch/_table4.py``: int8, HEANA at N = 2, MAW at N = 1, 8
bits, noise on) through the TAOM kernel bit-equal to the plain route.
They import no JAX.
"""
import dataclasses
import importlib
import math
import os
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import perf_model as pm
from repro_torch.core.taom import quantize
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import PlanCache, execute_cnn, plan_for_network
from repro_torch.kernels import flash_attention, ops, ref, ssd_scan, taom_gemm
from repro_torch.launch import train as ttrain
from repro_torch.models import lowering as lw
from repro_torch.models import model_zoo as zoo
from repro_torch.models import transformer as ttransformer
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.models.zoo_cnn import ZOO

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,d,n", [(1, 1, 1, 83), (37, 50, 9, 83),
                                     (4100, 144, 70, 83), (999, 300, 5, 7)])
@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.MAW,
                                     Backend.HEANA_AMW_BPCA])
@pytest.mark.parametrize("block_d", [8, 16, 128])
def test_kernel_bit_equal_to_plain_on_card(cuda, m, k, d, n, backend,
                                           block_d):
    gen = torch.Generator(device=cuda).manual_seed(m + k + d)
    cfg = PhotonicConfig(backend=backend, bits=8, dpe_size=n)
    xq, _ = quantize(torch.randn(m, k, generator=gen, device=cuda), 8)
    wq, _ = quantize(torch.randn(k, d, generator=gen, device=cuda), 8,
                     axis=0)
    assert (xq.abs().double() @ wq.abs().double()).max() < 2.0 ** 24
    c = -(-k // n)
    shape = (c, m, d) if backend == Backend.MAW else (m, d)
    noise = torch.randn(shape, generator=gen, device=cuda)
    fs = taom_gemm.calibrated_adc_fs(k, cfg)
    before = taom_gemm.LAUNCHES
    got = taom_gemm.taom_gemm_quantized(xq, wq, noise, cfg, fs,
                                        block_m=16, block_d=block_d)
    assert taom_gemm.LAUNCHES == before + 1
    want = ref.taom_gemm_reference(xq, wq, noise, cfg, fs)
    assert torch.equal(got, want)
    quiet = taom_gemm.taom_gemm_quantized(xq, wq, None, cfg, fs,
                                          block_d=block_d)
    assert torch.equal(quiet, ref.taom_gemm_reference(xq, wq, None, cfg, fs))


def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda):
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83)
    x = torch.zeros(8, 16, device=cuda)
    w = torch.zeros(16, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        taom_gemm.taom_gemm_quantized(x.double(), w, torch.zeros(8, 4,
                                      device=cuda), cfg, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        taom_gemm.taom_gemm_quantized(x, torch.zeros(4, 16, device=cuda).T,
                                      torch.zeros(8, 4, device=cuda), cfg,
                                      1.0)


# The fused int8 route (bits <= 7): taom_gemm_fused against the plain
# version ref.photonic_gemm_reference (quantize, chunked GEMM, rescale),
# bit for bit.  resnet_mini's served GEMMs at batch 32 (N=83) and the
# photonic mamba2-130m GEMMs (in_proj, out_proj) with M cut to 512.
def _resnet_mini_shapes():
    model = ZOO["resnet_mini"]
    params = model.init_params(torch.Generator().manual_seed(0))
    acc = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    plan = plan_for_network(params, acc, batch=32, in_hw=model.in_hw,
                            lowering=model.graph, cache=PlanCache())
    return sorted({(lp.c, lp.k, lp.d, lp.tile.block_d) for lp in plan.layers})


FUSED_LM_SHAPES = [(512, 768, 3352, 128), (512, 1536, 768, 128)]


def _fused_operands(cuda, m, k, d, dtype, seed, offset=(0, 0)):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(k, d, generator=gen, device=cuda) *
         torch.rand(1, d, generator=gen, device=cuda)).to(dtype)
    if offset[0]:
        buf = torch.empty(x.numel() + offset[0], dtype=dtype, device=cuda)
        x = buf[offset[0]:].view(m, k).copy_(x)
    if offset[1]:
        buf = torch.empty(w.numel() + offset[1], dtype=dtype, device=cuda)
        w = buf[offset[1]:].view(k, d).copy_(w)
    return x, w


def _fused_noise(cuda, cfg, m, k, d, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = -(-k // cfg.dpe_size)
    chunk_adc = cfg.backend in (Backend.AMW, Backend.MAW)
    return torch.randn((c, m, d) if chunk_adc else (m, d), generator=gen,
                       device=cuda)


def _fused_equal(cuda, x, w, cfg, noise, block_d=128):
    fs = taom_gemm.calibrated_adc_fs(x.shape[1], cfg)
    assert cfg.qmax ** 2 * min(cfg.dpe_size, x.shape[1]) < 2 ** 24
    before = taom_gemm.LAUNCHES
    got = taom_gemm.taom_gemm_fused(x, w, noise, cfg, fs, block_d=block_d)
    assert taom_gemm.LAUNCHES == before + 1
    want = ref.photonic_gemm_reference(x, w, noise, cfg, fs)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.AMW,
                                     Backend.MAW, Backend.HEANA_AMW_BPCA])
@pytest.mark.parametrize("noisy", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_route_bit_equal_at_resnet_mini_shapes_on_card(
        cuda, backend, noisy, dtype):
    cfg = PhotonicConfig(backend=backend, bits=6, dpe_size=83)
    for i, (m, k, d, block_d) in enumerate(_resnet_mini_shapes()):
        x, w = _fused_operands(cuda, m, k, d, dtype, seed=i)
        noise = _fused_noise(cuda, cfg, m, k, d, i) if noisy else None
        _fused_equal(cuda, x, w, cfg, noise, block_d)


@pytest.mark.parametrize("m,k,d,block_d", FUSED_LM_SHAPES)
@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.AMW])
@pytest.mark.parametrize("noisy", [True, False])
def test_fused_route_bit_equal_at_photonic_lm_shapes_on_card(
        cuda, m, k, d, block_d, backend, noisy):
    cfg = PhotonicConfig(backend=backend, bits=6, dpe_size=83)
    x, w = _fused_operands(cuda, m, k, d, torch.bfloat16, seed=k)
    noise = _fused_noise(cuda, cfg, m, k, d, k) if noisy else None
    _fused_equal(cuda, x, w, cfg, noise, block_d)


@pytest.mark.parametrize("m,k,d,n,block_d", [
    (1, 1, 1, 83, 128), (1, 144, 70, 83, 128),     # one row, D > 64
    (37, 83, 70, 83, 8),                           # 9 column tiles of 8
    (300, 200, 10, 36, 16), (64, 500, 33, 250, 64),  # a chunk in 2 pieces
    (33, 27, 16, 7, 128), (5000, 84, 8, 83, 8)])
@pytest.mark.parametrize("bits", [4, 5, 7])
def test_fused_route_bit_equal_at_edges_on_card(cuda, m, k, d, n, block_d,
                                                bits):
    for backend in (Backend.HEANA, Backend.MAW):
        cfg = PhotonicConfig(backend=backend, bits=bits, dpe_size=n)
        x, w = _fused_operands(cuda, m, k, d, torch.float32, seed=m + bits)
        _fused_equal(cuda, x, w, cfg, _fused_noise(cuda, cfg, m, k, d, 1),
                     block_d)


@pytest.mark.parametrize("bits", [4, 6, 7])
@pytest.mark.parametrize("factor", [1.0, 0.7, 3.3, 1e-30, 1e30])
def test_fused_route_rounds_half_integers_like_the_reference_on_card(
        cuda, bits, factor):
    # Operands at (near) half-integer multiples of their scale: the
    # kernels' fast reciprocal path must hand these to the IEEE division,
    # so that round-half-even sees the reference's quotient.
    qmax = (1 << bits) - 1
    halves = torch.arange(-2 * qmax, 2 * qmax + 1, device=cuda) * 0.5
    x = (halves * factor).repeat(3, 1).float()
    x[1] = torch.nextafter(x[1], torch.full_like(x[1], math.inf))
    x[2] = torch.nextafter(x[2], torch.full_like(x[2], -math.inf))
    w = (halves[:, None] * torch.tensor([factor, 1.0, 0.3, 7.0],
                                        device=cuda)).float()
    for backend in (Backend.HEANA, Backend.AMW):
        cfg = PhotonicConfig(backend=backend, bits=bits, dpe_size=83)
        _fused_equal(cuda, x, w, cfg, None)
        _fused_equal(cuda, x.bfloat16(), w, cfg, None)


@pytest.mark.parametrize("offset", [(1, 0), (2, 3), (0, 3), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_route_takes_views_off_a_16_byte_boundary_on_card(
        cuda, offset, dtype):
    # Contiguous x and w views that start inside a 16-byte vector are read
    # one element at a time: the result is what aligned copies give.
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83)
    m, k, d = 300, 144, 64
    x, w = _fused_operands(cuda, m, k, d, dtype, seed=7, offset=offset)
    assert x.is_contiguous() and w.is_contiguous()
    assert bool(offset[0]) == bool(x.data_ptr() % 16)
    _fused_equal(cuda, x, w, cfg, _fused_noise(cuda, cfg, m, k, d, 2))
    fs = taom_gemm.calibrated_adc_fs(k, cfg)
    aligned = taom_gemm.taom_gemm_fused(x.clone(), w.clone(), None, cfg, fs)
    assert torch.equal(aligned,
                       taom_gemm.taom_gemm_fused(x, w, None, cfg, fs))


def test_photonic_matmul_takes_the_fused_route_on_card(cuda):
    # bits <= 7 launch the fused route (its two kernels and no PyTorch
    # quantize), 8 bits the float32 body; both equal impl="ref" with the
    # same generator seed.
    x = torch.randn(4, 50, 100, device=cuda)
    w = torch.randn(100, 24, device=cuda)
    for bits, route in ((6, "taom_gemm_int8"), (8, "taom_gemm_kernel")):
        cfg = PhotonicConfig(backend=Backend.AMW, bits=bits, dpe_size=36)
        got = ops.photonic_matmul(
            x, w, cfg, generator=torch.Generator(device=cuda).manual_seed(3),
            impl="kernel")
        want = ops.photonic_matmul(
            x, w, cfg, generator=torch.Generator(device=cuda).manual_seed(3),
            impl="ref")
        assert torch.equal(got, want), bits
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ops.photonic_matmul(x, w, dataclasses.replace(
                cfg, noise_enabled=False), impl="kernel")
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        assert any(route in n for n in names), (bits, names)


def test_fused_route_replays_in_a_cuda_graph_on_card(cuda):
    # The two kernels and their scratch inside one captured call: replayed
    # on fresh inputs, the graph gives what an eager call gives.
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83)
    m, k, d = 2048, 144, 16
    x, w = _fused_operands(cuda, m, k, d, torch.float32, seed=0)
    noise = _fused_noise(cuda, cfg, m, k, d, 0)
    fs = taom_gemm.calibrated_adc_fs(k, cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        taom_gemm.taom_gemm_fused(x, w, noise, cfg, fs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = taom_gemm.taom_gemm_fused(x, w, noise, cfg, fs)
    for seed in (1, 2):
        nx, nw = _fused_operands(cuda, m, k, d, torch.float32, seed=seed)
        x.copy_(nx * seed)
        w.copy_(nw)
        noise.copy_(_fused_noise(cuda, cfg, m, k, d, seed))
        graph.replay()
        want = taom_gemm.taom_gemm_fused(x, w, noise, cfg, fs)
        torch.cuda.synchronize()
        assert torch.equal(out, want), seed
        assert torch.equal(want,
                           ref.photonic_gemm_reference(x, w, noise, cfg, fs))


def test_fused_route_rejects_bad_inputs_on_card(cuda):
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83)
    x = torch.zeros(8, 16, device=cuda)
    w = torch.zeros(16, 4, device=cuda)
    with pytest.raises(ValueError, match="bits <= 7"):
        taom_gemm.taom_gemm_fused(x, w, None,
                                  dataclasses.replace(cfg, bits=8), 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        taom_gemm.taom_gemm_fused(x.double(), w, None, cfg, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        taom_gemm.taom_gemm_fused(x, w.half(), None, cfg, 1.0)
    with pytest.raises(TypeError, match="float32"):
        taom_gemm.taom_gemm_fused(x, w, torch.zeros(8, 4, device=cuda,
                                                    dtype=torch.bfloat16),
                                  cfg, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        taom_gemm.taom_gemm_fused(x, torch.zeros(4, 16, device=cuda).T, None,
                                  cfg, 1.0)
    with pytest.raises(ValueError, match="noise has shape"):
        taom_gemm.taom_gemm_fused(x, w, torch.zeros(4, 8, device=cuda), cfg,
                                  1.0)
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        taom_gemm.taom_gemm_fused(x, torch.zeros(15, 4, device=cuda), None,
                                  cfg, 1.0)
    with pytest.raises(ValueError, match="is on cpu"):
        taom_gemm.taom_gemm_fused(x, w.cpu(), None, cfg, 1.0)


@pytest.mark.parametrize("name", list(ZOO))
def test_zoo_kernel_path_equals_plain_path_on_card(cuda, name):
    model = ZOO[name]
    params = model.init_params(torch.Generator().manual_seed(0), device=cuda)
    x = torch.randn(4, *model.in_hw, model.in_ch,
                    generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    acc = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    plan = plan_for_network(params, acc, batch=4, in_hw=model.in_hw,
                            lowering=model.graph, cache=PlanCache())
    got = execute_cnn(params, x, plan, cfg, impl="kernel",
                      lowering=model.graph, device=cuda)
    want = execute_cnn(params, x, plan, cfg, impl="ref",
                       lowering=model.graph, device=cuda)
    assert torch.equal(got.logits, want.logits)
    exact = lw.graph_apply(params, x, model.graph)
    direct = lw.direct_forward(params, x, model.graph)
    torch.testing.assert_close(exact, direct, rtol=1e-4, atol=1e-4)


def _ssd_inputs(cuda, bh, l, p, s, seed, decay=1.0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(bh, l, p, generator=gen, device=cuda)
    dt = torch.logaddexp(torch.randn(bh, l, generator=gen, device=cuda),
                         torch.zeros((), device=cuda))
    a = -decay * torch.exp(torch.randn(bh, generator=gen, device=cuda))
    b = torch.randn(bh, l, s, generator=gen, device=cuda)
    c = torch.randn(bh, l, s, generator=gen, device=cuda)
    return x, dt, a, b, c


def _ssd_close(got, want):
    return torch.allclose(got, want, rtol=1e-4,
                          atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("bh,l,p,s,chunk,decay", [
    (96, 1024, 64, 128, 128, 1.0),    # mamba2-130m, batch 4
    (8, 64, 16, 16, 8, 1.0),          # the smoke config
    (24, 512, 64, 64, 128, 1.0),      # zamba2's head and state
    (448, 1000, 64, 64, 128, 1.0),    # zamba2-7b served: batch 4 x 112
    (8, 1000, 64, 128, 128, 1.0),     # ragged L through ops.ssd_scan
    (3, 40, 16, 24, 16, 1.0), (2, 33, 8, 8, 16, 1.0),
    (4, 256, 128, 128, 128, 1.0),     # the largest head, P = 128
    (4, 300, 64, 128, 100, 1.0),      # Q = 100, not a multiple of 4
    (8, 128, 64, 128, 128, 1.0),      # a single chunk, L == Q
    (8, 512, 64, 128, 128, 30.0)])    # fast decay: exp underflows in a chunk
def test_ssd_kernel_matches_plain_on_card(cuda, bh, l, p, s, chunk, decay):
    x, dt, a, b, c = _ssd_inputs(cuda, bh, l, p, s, seed=l + p, decay=decay)
    before = ssd_scan.LAUNCHES
    y, st = ops.ssd_scan(x, dt, a, b, c, chunk=chunk, impl="kernel")
    assert ssd_scan.LAUNCHES == before + 1
    want_y, want_st = ops.ssd_scan(x, dt, a, b, c, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    assert y.shape == (bh, l, p) and st.shape == (bh, p, s)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    assert _ssd_close(y, want_y) and _ssd_close(st, want_st)


def test_ssd_kernel_replays_in_a_cuda_graph_on_card(cuda):
    # The three kernels and their workspace inside one captured call:
    # replayed on fresh inputs, the graph gives what an eager call gives.
    bh, l, p, s, q = 8, 512, 64, 128, 128
    args = _ssd_inputs(cuda, bh, l, p, s, seed=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan.ssd_scan_chunked(*args, chunk=q)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, st = ssd_scan.ssd_scan_chunked(*args, chunk=q)
    for seed in (4, 5):
        for dst, src in zip(args, _ssd_inputs(cuda, bh, l, p, s, seed=seed)):
            dst.copy_(src)
        graph.replay()
        want_y, want_st = ssd_scan.ssd_scan_chunked(*args, chunk=q)
        torch.cuda.synchronize()
        assert torch.equal(y, want_y) and torch.equal(st, want_st), seed


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ssd_kernel_takes_x_off_a_16_byte_boundary_on_card(cuda, offset):
    # A contiguous x view that starts inside a float4 is read one float at
    # a time: the wrapper accepts it and the kernels give what they give on
    # an aligned copy.
    bh, l, p, s, q = 4, 256, 64, 128, 128
    x, dt, a, b, c = _ssd_inputs(cuda, bh, l, p, s, seed=offset)
    buf = torch.empty(x.numel() + offset, device=cuda)
    xs = buf[offset:].view(x.shape).copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    y, st = ssd_scan.ssd_scan_chunked(xs, dt, a, b, c, chunk=q)
    want_y, want_st = ops._ssd_chunked(x, dt, a, b, c, q)
    torch.cuda.synchronize()
    assert _ssd_close(y, want_y) and _ssd_close(st, want_st)


def test_ssd_kernel_wrapper_rejects_bad_inputs_on_card(cuda):
    x, dt, a, b, c = _ssd_inputs(cuda, 2, 16, 8, 8, seed=0)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan.ssd_scan_chunked(x.double(), dt, a, b, c, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_scan_chunked(x.transpose(0, 1).contiguous()
                                  .transpose(0, 1), dt, a, b, c, chunk=8)
    for width in (132, 6):
        bad = torch.zeros(2, 16, width, device=cuda)
        with pytest.raises(ValueError, match="S <= 128 a multiple of 4"):
            ssd_scan.ssd_scan_chunked(x, dt, a, bad, bad, chunk=8)
    shifted = torch.zeros(2 * 16 * 8 + 1, device=cuda)[1:].view(2, 16, 8)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ssd_scan.ssd_scan_chunked(x, dt, a, shifted, c, chunk=8)


def test_mamba_prefill_through_the_kernel_on_card(cuda):
    cfg = dataclasses.replace(get_config("mamba2-130m", smoke=True),
                              dtype="float32")
    params = zoo.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for impl in ("auto", "kernel", "ref"):     # 'auto' is the default
        caches = zoo.init_caches(cfg, 2, 21, device=cuda)
        kwargs = {} if impl == "auto" else {"ssm_impl": impl}
        before = ssd_scan.LAUNCHES
        out[impl] = zoo.prefill_fn(params, {"tokens": tokens.to(cuda)}, cfg,
                                   caches, **kwargs)
        launched = ssd_scan.LAUNCHES - before
        assert launched == (0 if impl == "ref" else cfg.num_layers)
    (lk, sk), (lr, sr) = out["kernel"], out["ref"]
    assert torch.equal(out["auto"][0], lk)
    assert _ssd_close(lk, lr)
    for key in ("conv", "ssm"):
        assert _ssd_close(sk["layers"]["mamba"][key],
                          sr["layers"]["mamba"][key])


@pytest.mark.parametrize("arch", ["zamba2-7b", "llava-next-mistral-7b",
                                  "whisper-tiny", "deepseek-v2-236b"])
def test_family_prefill_through_the_kernels_on_card(cuda, arch):
    """The hybrid, VLM, encoder-decoder and moe prefills (float32 smoke
    configs) with the kernels against the plain versions: the SSD wrapper
    once a mamba layer, the flash kernel once an attention layer
    (whisper's encoder and decoder; deepseek's MLA)."""
    from repro_torch.launch.serve import request_batch
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = zoo.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    batch = request_batch(cfg, tokens.to(cuda))
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(batch["patches"].shape, device=cuda)
    out = {}
    for impl in ("kernel", "ref"):
        caches = zoo.init_caches(cfg, 2, 21, torch.float32, device=cuda)
        before = (ssd_scan.LAUNCHES, flash_attention.LAUNCHES)
        out[impl] = zoo.prefill_fn(params, batch, cfg, caches,
                                   ssm_impl=impl, attn_impl=impl)
        launched = (ssd_scan.LAUNCHES - before[0],
                    flash_attention.LAUNCHES - before[1])
        if impl == "ref":
            assert launched == (0, 0)
        elif cfg.family == "hybrid":
            assert launched == (cfg.num_layers,
                                cfg.num_layers // cfg.shared_attn_period)
        elif cfg.family == "audio":
            assert launched == (0, cfg.encoder_layers + cfg.num_layers)
        else:
            assert launched == (0, cfg.num_layers)
    for got, want in zip(tree_leaves(out["kernel"]),
                         tree_leaves(out["ref"])):
        assert got[0] == want[0]
        assert torch.allclose(got[1].float(), want[1].float(), rtol=1e-4,
                              atol=1e-4 * want[1].float().abs().max()), got[0]


def _flash_inputs(cuda, bh, s, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(bh, s, d, generator=gen, device=cuda)
            .to(getattr(torch, dtype)) for _ in range(3)]


def _flash_close(got, want):
    scale = want.float().abs().max().item()
    if want.dtype == torch.float32:
        return torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    # one bf16 ulp of each query row's max|plain| binade
    err = (got.float() - want.float()).abs().amax(-1)
    row_max = want.float().abs().amax(-1).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    return bool((err <= ulp).all())


@pytest.mark.parametrize("bh,s,d,causal,window,dtype", [
    (64, 1000, 64, True, 0, "bfloat16"),   # qwen2-0.5b at batch 4
    (2, 37, 16, True, 0, "float32"),       # a ragged S
    (3, 300, 120, True, 100, "float32"),   # h2o-danube3's head, a window
    (2, 257, 240, True, 64, "bfloat16"),   # gemma3's head
    (4, 129, 24, False, 0, "float32"),     # non-causal, D 24
    (1, 1, 8, True, 0, "float32"),         # one token
    # the bf16 tensor-core kernel's edges
    (4, 129, 64, False, 0, "bfloat16"),    # non-causal
    (3, 200, 24, True, 0, "bfloat16"),     # D 24: TMA zero-fills to 64
    (2, 300, 40, False, 0, "bfloat16"),    # D 40, non-causal
    (2, 150, 20, True, 0, "bfloat16"),     # D % 8 != 0: no TMA, plain loads
    (2, 140, 150, True, 0, "bfloat16"),    # D 150: no TMA, three atoms
    (1, 1, 64, True, 0, "bfloat16"),       # one token
    (3, 65, 64, True, 0, "bfloat16"),      # one key past a tile
    (2, 300, 64, True, 40, "bfloat16"),    # window starts inside a tile
    (2, 333, 200, True, 100, "bfloat16"),  # D 200 (four atoms), a window
    (2, 200, 128, False, 50, "bfloat16"),  # window without causal
    # the served shapes of the hybrid, VLM and encoder-decoder families
    (128, 1000, 112, True, 0, "bfloat16"),  # zamba2-7b, batch 4 x 32
    (64, 3072, 128, True, 0, "bfloat16"),   # llava, batch 2 x 32 (GQA 4:1)
    (24, 1500, 64, False, 0, "bfloat16"),   # whisper encoder, batch 4 x 6
    (24, 64, 64, True, 0, "bfloat16"),      # whisper decoder prompt
    # deepseek-v2's MLA prefill: batch 4 x 128 heads of nope + rope = 192
    (512, 1000, 192, True, 0, "bfloat16"),
    (4, 129, 192, True, 0, "float32")])
def test_flash_kernel_matches_plain_on_card(cuda, bh, s, d, causal, window,
                                            dtype):
    q, k, v = _flash_inputs(cuda, bh, s, d, dtype, seed=s + d)
    before = flash_attention.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="kernel")
    assert flash_attention.LAUNCHES == before + 1
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    assert _flash_close(got, want)


@pytest.mark.parametrize("d,offset", [(20, 0), (36, 0), (64, 1)])
def test_flash_kernel_without_tma_still_launches_on_card(cuda, d, offset):
    # D % 8 != 0, or a q not on a 16-byte boundary: TMA cannot read it,
    # and the kernel stages the tiles with plain loads instead.
    q, k, v = _flash_inputs(cuda, 2, 97, d, "bfloat16", seed=d)
    if offset:
        buf = torch.empty(q.numel() + offset, dtype=q.dtype, device=cuda)
        q = buf[offset:].view(q.shape).copy_(q)
        assert q.is_contiguous() and q.data_ptr() % 16 != 0
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention_fwd(q, k, v, causal=True)
    assert flash_attention.LAUNCHES == before + 1
    want = ops._flash_blocked(q, k, v, True)
    torch.cuda.synchronize()
    assert _flash_close(got, want)


def test_flash_kernel_wrapper_rejects_bad_inputs_on_card(cuda):
    q, k, v = _flash_inputs(cuda, 2, 16, 8, "float32", seed=0)
    with pytest.raises(TypeError, match="float32 or all"):
        flash_attention.flash_attention_fwd(q.double(), k.double(),
                                            v.double())
    with pytest.raises(TypeError, match="float32 or all"):
        flash_attention.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="is on cpu"):
        flash_attention.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_fwd(
            q, k.transpose(0, 1).contiguous().transpose(0, 1), v)
    with pytest.raises(ValueError, match="k has shape"):
        flash_attention.flash_attention_fwd(q, k[:, :8], v)
    wide = torch.zeros(1, 4, 264, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention.flash_attention_fwd(wide, wide, wide)


def test_qwen2_prefill_through_the_flash_kernel_on_card(cuda):
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True),
                              dtype="float32")
    params = zoo.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for impl in ("auto", "kernel", "ref"):     # 'auto' is the default
        caches = zoo.init_caches(cfg, 2, 21, torch.float32, device=cuda)
        kwargs = {} if impl == "auto" else {"attn_impl": impl}
        before = flash_attention.LAUNCHES
        out[impl] = zoo.prefill_fn(params, {"tokens": tokens.to(cuda)}, cfg,
                                   caches, **kwargs)
        launched = flash_attention.LAUNCHES - before
        assert launched == (0 if impl == "ref" else cfg.num_layers)
    (lk, sk), (lr, sr) = out["kernel"], out["ref"]
    assert torch.equal(out["auto"][0], lk)
    assert torch.allclose(lk, lr, rtol=1e-4, atol=1e-4 * lr.abs().max())
    body_k, body_r = sk["layers"]["body"], sr["layers"]["body"]
    assert torch.equal(body_k["pos"], body_r["pos"])
    for key in ("k", "v"):     # layer 1's come from layer 0's attention
        assert torch.allclose(body_k[key], body_r[key], rtol=1e-4,
                              atol=1e-4 * body_r[key].abs().max())


# ---------------------------------------------------------------------------
# Training: gradients on the card (ROADMAP C1)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-0.5b"])
def test_grads_through_default_forward_equal_plain_route_on_card(cuda,
                                                                 arch):
    """The full config cut to 2 layers, float32: gradients through
    ``transformer.forward`` under its defaults ('auto' routes, remat on)
    equal those under the plain routes bit for bit, no SSD or flash kernel
    launches under grad, every leaf gets a finite gradient, and
    impl='kernel' with a grad-requiring input raises."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              dtype="float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 200),
                           generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(cuda)
    grads = {}
    for impl in ("auto", "ref"):
        params = tree_map(lambda p: p.requires_grad_(),
                          zoo.init_params(cfg, 0, device=cuda))
        kwargs = {} if impl == "auto" else {"ssm_impl": impl,
                                            "attn_impl": impl}
        before = (ssd_scan.LAUNCHES, flash_attention.LAUNCHES)
        out = ttransformer.forward(params, tokens, cfg, **kwargs)
        (out.float().square().mean()).backward()
        assert (ssd_scan.LAUNCHES, flash_attention.LAUNCHES) == before
        grads[impl] = {k: p.grad for k, p in tree_leaves(params)}
    for key, g in grads["auto"].items():
        assert g is not None and bool(torch.isfinite(g).all()), key
        assert torch.equal(g, grads["ref"][key]), key
    with pytest.raises(ValueError, match="forward-only"):
        ttransformer.forward(params, tokens, cfg, ssm_impl="kernel",
                             attn_impl="kernel")
    with torch.no_grad():       # serving: the default is still the kernel
        before = ssd_scan.LAUNCHES + flash_attention.LAUNCHES
        ttransformer.forward(params, tokens, cfg)
        assert ssd_scan.LAUNCHES + flash_attention.LAUNCHES == \
            before + cfg.num_layers


def test_train_on_card_falls_resumes_and_qat_launches_taom(cuda, tmp_path):
    """``launch.train.train`` at smoke size on the card: the loss falls, a
    resume from step 4 reproduces steps 4-7 bit for bit, and photonic QAT
    launches the TAOM kernel twice per photonic GEMM a step (the forward
    and the remat recompute), bit-equal to impl='ref'."""
    kw = dict(smoke=True, batch=4, seq=64, device="cuda", log_every=100)
    full = ttrain.train("mamba2-130m", steps=8, ckpt_dir=str(tmp_path),
                        ckpt_every=4, **kw)
    assert full.final_loss < full.first_loss
    resumed_dir = tmp_path / "resume"
    resumed_dir.mkdir()
    (tmp_path / "step_00000004").rename(resumed_dir / "step_00000004")
    again = ttrain.train("mamba2-130m", steps=8, ckpt_dir=str(resumed_dir),
                         ckpt_every=100, resume=True, **kw)
    assert again.losses == full.losses[4:]
    runs = {}
    for impl in ("auto", "ref"):
        before = taom_gemm.LAUNCHES
        runs[impl] = ttrain.train("mamba2-130m", steps=2,
                                  numerics="photonic_heana", impl=impl, **kw)
        runs[impl + "_launches"] = taom_gemm.LAUNCHES - before
    layers = get_config("mamba2-130m", smoke=True).num_layers
    assert runs["auto_launches"] == 2 * 2 * 2 * layers
    assert runs["ref_launches"] == 0
    assert runs["auto"].losses == runs["ref"].losses
    for (key, a), (_, b) in zip(tree_leaves(runs["auto"].params),
                                tree_leaves(runs["ref"].params)):
        assert torch.equal(a, b), key


# ---------------------------------------------------------------------------
# The compiled paths: CUDA graphs of the CNN forward and of a decode step
# ---------------------------------------------------------------------------
def _resnet_mini(cuda, backend):
    from repro_torch.core import hw
    model = ZOO["resnet_mini"]
    params = model.init_params(torch.Generator().manual_seed(0), device=cuda)
    if backend == Backend.HEANA:
        acc = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
        cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                             noise_enabled=False)
    else:
        acc = hw.OperatingPoint.equal_area(backend.value, Dataflow.OS, 1.0)
        cfg = acc.kernel_config(noise_enabled=False)
    return model, params, acc, cfg


@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.AMW])
def test_graphed_execute_equals_eager_for_every_bucket_on_card(cuda,
                                                              backend):
    from repro_torch.exec import power_of_two_buckets, trace_count
    model, params, acc, cfg = _resnet_mini(cuda, backend)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for b in power_of_two_buckets(64):
        plan = plan_for_network(params, acc, batch=b, in_hw=model.in_hw,
                                lowering=model.graph, cache=PlanCache())
        x = torch.randn(b, *model.in_hw, model.in_ch, generator=gen,
                        device=cuda)
        before = trace_count()
        graphed = [execute_cnn(params, x, plan, cfg, lowering=model.graph,
                               device=cuda, collect_activations=True)
                   for _ in range(2)]
        assert trace_count() == before + 1, b      # one capture, one replay
        eager = execute_cnn(params, x, plan, cfg, lowering=model.graph,
                            device=cuda, compiled=False,
                            collect_activations=True)
        for res in graphed:
            assert torch.equal(res.logits, eager.logits), b
            assert torch.equal(res.fingerprints, eager.fingerprints), b
            assert all(torch.equal(a, e) for a, e in
                       zip(res.activations, eager.activations)), b
        # other parameter tensors: captured anew, never stale weights
        twice = {k: v * 2 for k, v in params.items()}
        res = execute_cnn(twice, x, plan, cfg, lowering=model.graph,
                          device=cuda)
        assert trace_count() == before + 2
        assert torch.equal(res.logits, execute_cnn(
            twice, x, plan, cfg, lowering=model.graph, device=cuda,
            compiled=False).logits)


@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.AMW])
def test_noisy_graphed_equals_noisy_eager_from_one_seed_on_card(cuda,
                                                                backend):
    model, params, acc, cfg = _resnet_mini(cuda, backend)
    cfg = dataclasses.replace(cfg, noise_enabled=True)
    plan = plan_for_network(params, acc, batch=8, in_hw=model.in_hw,
                            lowering=model.graph, cache=PlanCache())
    x = torch.randn(8, *model.in_hw, model.in_ch, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(4))
    run = lambda seed, compiled: execute_cnn(          # noqa: E731
        params, x, plan, cfg, seed=seed, lowering=model.graph, device=cuda,
        compiled=compiled).logits
    a, b, c = run(7, True), run(7, True), run(8, True)
    assert torch.equal(a, run(7, False)) and torch.equal(a, b)
    assert torch.equal(c, run(8, False)) and not torch.equal(a, c)
    assert bool(torch.isfinite(a).all())


def test_zero_retraces_after_warmup_on_card(cuda):
    from repro_torch.exec import ServingEngine, trace_count
    model, params, acc, cfg = _resnet_mini(cuda, Backend.HEANA)
    engine = ServingEngine(params, acc, cfg, lowering=model.graph,
                           in_hw=model.in_hw, max_batch=8,
                           plan_cache=PlanCache(), device=cuda)
    before = trace_count()
    engine.warmup()
    assert trace_count() == before + len(engine.buckets)
    gen = torch.Generator(device=cuda).manual_seed(5)
    for n in (1, 2, 3, 5, 8, 11, 17):
        engine.infer(torch.randn(n, *model.in_hw, model.in_ch, device=cuda,
                                 generator=gen))
    assert trace_count() == before + len(engine.buckets)
    assert engine.stats()["retraces_since_warmup"] == 0


def test_threads_serve_concurrently_bitwise_on_card(cuda):
    import threading
    from repro_torch.exec import ServingEngine
    model, params, acc, cfg = _resnet_mini(cuda, Backend.HEANA)
    engine = ServingEngine(params, acc, cfg, lowering=model.graph,
                           in_hw=model.in_hw, max_batch=8,
                           plan_cache=PlanCache(), device=cuda)
    engine.warmup()
    gen = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn((i % 4) + 1, *model.in_hw, model.in_ch, device=cuda,
                      generator=gen) for i in range(8)]
    expect = [engine.infer(x).cpu() for x in xs]
    results = [[] for _ in xs]
    errors = []

    def worker(i):
        try:
            for _ in range(10):
                results[i].append(engine.infer(xs[i]).cpu())
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert errors == []
    for got, want in zip(results, expect):
        assert len(got) == 10 and all(torch.equal(g, want) for g in got)
    assert engine.stats()["retraces_since_warmup"] == 0


def _dp_entries(cuda, entries):
    if entries == "repeated":
        return [cuda, cuda]
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("backend", [Backend.HEANA, Backend.AMW])
@pytest.mark.parametrize("entries", ["repeated", "cards"])
def test_data_parallel_graphs_equal_one_device_and_plain_on_card(
        cuda, backend, entries):
    """Each entry's per-segment graphs: one capture a data-parallel
    bucket at warmup, none after it, and every request bit-equal to the
    one-device engine and to the plain route at the padded bucket."""
    from repro_torch.exec import ServingEngine, trace_count
    model, params, acc, cfg = _resnet_mini(cuda, backend)
    devices = _dp_entries(cuda, entries)
    kw = dict(lowering=model.graph, in_hw=model.in_hw, max_batch=16,
              plan_cache=PlanCache(), device=cuda)
    one = ServingEngine(params, acc, cfg, **kw)
    dp = ServingEngine(params, acc, cfg, data_parallel=True,
                       devices=devices, **kw)
    assert dp.data_parallel and dp.stats()["n_devices"] == len(devices)
    one.warmup()
    before = trace_count()
    dp.warmup()       # the other buckets replay the one-device graphs
    n_dp = sum(b % len(devices) == 0 for b in dp.buckets)
    assert n_dp > 0 and trace_count() == before + n_dp
    gen = torch.Generator(device=cuda).manual_seed(8)
    for n in (1, 2, 3, 4, 7, 8, 13, 16, 21):
        x = torch.randn(n, *model.in_hw, model.in_ch, device=cuda,
                        generator=gen)
        got = dp.infer(x)
        assert torch.equal(got, one.infer(x)), n
        for lo in range(0, n, 16):
            chunk = x[lo:lo + 16]
            b = next(b for b in dp.buckets if b >= chunk.shape[0])
            xb = torch.cat([chunk, chunk.new_zeros(
                (b - chunk.shape[0],) + tuple(chunk.shape[1:]))])
            want = execute_cnn(params, xb, dp.plans[b], cfg, impl="ref",
                               lowering=model.graph, device=cuda,
                               compiled=False).logits[:chunk.shape[0]]
            assert torch.equal(got[lo:lo + 16], want), (n, lo)
    assert trace_count() == before + n_dp
    assert dp.stats()["retraces_since_warmup"] == 0


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2-0.5b", "zamba2-7b",
                                  "llava-next-mistral-7b", "whisper-tiny",
                                  "deepseek-v2-236b"])
def test_graphed_decode_step_equals_eager_on_card(cuda, arch):
    """A decode step replayed from a CUDA graph equals the eager step bit
    for bit (deepseek: MoE routing and dispatch on the device, the
    absorbed MLA decode)."""
    from repro_torch.launch.serve import DecodeGraph, request_batch
    from repro_torch.models.transformer import tree_map
    cfg = get_config(arch, smoke=True)
    params = zoo.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    caches = zoo.init_caches(cfg, 2, 25, getattr(torch, cfg.dtype), cuda)
    logits, state = zoo.prefill_fn(params, request_batch(cfg,
                                                         tokens.to(cuda)),
                                   cfg, caches)
    tok = logits[:, -1].float().argmax(-1)[:, None]
    step = DecodeGraph(params, cfg, state, tok)
    eager = tree_map(torch.clone, state)
    for i in range(4):
        want, eager = zoo.decode_fn(params, tok, 21 + i, cfg, eager)
        got = step(tok, 21 + i)
        assert torch.equal(got, want), i
        tok = want[:, -1].float().argmax(-1)[:, None]
    for (key, a), (_, b) in zip(tree_leaves(step.state),
                                tree_leaves(eager)):
        assert torch.equal(a, b), key


def test_capture_keeps_the_allocator_cache_warm_on_card(cuda):
    from repro_torch.core import cuda_graph
    x = torch.ones(1 << 20, device=cuda)
    scratch = torch.empty(64 << 20, device=cuda)
    del scratch
    reserved = torch.cuda.memory_reserved(cuda)
    graph, y = cuda_graph.capture(lambda: x * 2, cuda)
    assert torch.cuda.memory_reserved(cuda) >= reserved
    x.fill_(3)
    graph.replay()
    torch.cuda.synchronize(cuda)
    assert bool((y == 6).all())


@pytest.mark.parametrize("numerics", ["int8", "heana", "maw"])
def test_small_cnn_table4_columns_kernel_equal_plain(cuda, numerics):
    """Every GEMM of the small CNN under a Table-4 column (the float32
    body at N = 83, 2 and 1; each GEMM's noise from a fresh generator
    seeded 7): the kernel route's logits equal the plain route's bit for
    bit, and the kernel ran 4 times."""
    examples = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples_torch")
    if examples not in sys.path:
        sys.path.insert(0, examples)
    t4 = importlib.import_module("_table4")
    params, _ = t4.train_model(steps=5, device=cuda)
    x, _ = t4.make_data(16, 123, device=cuda)
    with torch.no_grad():
        before = taom_gemm.LAUNCHES
        got = t4.logits_under(params, x, numerics, "kernel")
        assert taom_gemm.LAUNCHES - before == 4
        want = t4.logits_under(params, x, numerics, "ref")
    assert torch.equal(got, want), (got - want).abs().max().item()

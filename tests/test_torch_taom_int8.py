"""The fused int8 route of the TAOM GEMM, held to the reference on the CPU.

The CUDA kernels of ``repro_torch.kernels.taom_gemm.taom_gemm_fused`` run
only on the card.  Here a plain-torch emulation of their order of
operations — the quantize-on-load formula, the s8 range, K positions
staged in slots padded with zeros to a multiple of 32, exact integer chunk
sums, one float32 conversion per chunk, the policy in chunk order, the
rescale ``acc * (sx * sw)`` and the cast — is held bit for bit against the
reference package's eager ``_taom_forward(impl="ref")`` (the body of its
``photonic_matmul``) on the same seeded numpy inputs and noise.  So is the
port's wrapper, which on a CPU tensor runs its plain version.  Tolerance:
none (bit-equal); every case asserts that its chunk psums stay below 2^24,
where the reference's float32 chunk dot products are exact integers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Backend as JBackend
from repro.core.types import PhotonicConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels.taom_gemm import calibrated_adc_fs as jcal_fs

from repro_torch.core.photonic_gemm import CHUNK_ADC_BACKENDS, detection_sigma
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.core import perf_model as pm
from repro_torch.exec import PlanCache, plan_for_network
from repro_torch.kernels import ops as tops
from repro_torch.kernels import taom_gemm as tkernel
from repro_torch.models.zoo_cnn import ZOO

EXACT_LIMIT = 2 ** 24
F32 = torch.float32


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


def _emulate(x: torch.Tensor, w: torch.Tensor, noise, cfg: PhotonicConfig,
             adc_fs: float, slot: int) -> torch.Tensor:
    """The int8 kernels' arithmetic, step by step, in plain torch."""
    qmax = cfg.qmax
    assert qmax <= 127
    inv_qmax, eps = _f32(1.0 / qmax), _f32(tkernel.QUANT_EPS)
    xf, wf = x.to(F32), w.to(F32)
    # Scales: max|x| (per tensor), max_k |w[k, d]| (per column), then
    # max(absmax, eps) * f32(1/qmax) in float32.
    sx = torch.maximum(xf.abs().amax(), eps) * inv_qmax
    sw = torch.maximum(wf.abs().amax(dim=0), eps) * inv_qmax
    # Quantize on load: clamp(rint(v / s), -qmax, qmax), an exact s8.
    xq = torch.clamp(torch.round(xf / sx), -qmax, qmax)
    wq = torch.clamp(torch.round(wf / sw), -qmax, qmax)
    xs, ws = xq.to(torch.int8), wq.to(torch.int8)
    assert torch.equal(xs.to(F32), xq) and torch.equal(ws.to(F32), wq)
    m, k = x.shape
    d = w.shape[1]
    n = cfg.dpe_size
    n_chunks = -(-k // n)
    chunk_adc = cfg.backend in CHUNK_ADC_BACKENDS
    sigma = detection_sigma(cfg)
    if chunk_adc:
        coef, fs = _f32(sigma), tkernel.chunk_fs(cfg)
    else:
        coef = _f32(sigma * float(np.sqrt(float(n_chunks))))
        fs = float(adc_fs)
    step, inv_step, hi = tkernel._adc_constants(cfg.adc_bits, fs)

    def adc(v):
        q = torch.clamp(torch.round(v * _f32(inv_step)), -hi, hi)
        return q * _f32(step)

    carry = torch.zeros((m, d), dtype=F32)
    for c in range(n_chunks):
        cs, clen = c * n, min(n, k - c * n)
        psum = torch.zeros((m, d), dtype=torch.int64)
        for p0 in range(0, clen, slot):
            ln = min(slot, clen - p0)
            a = torch.zeros((m, slot), dtype=torch.int64)   # padded slot
            b = torch.zeros((slot, d), dtype=torch.int64)
            a[:, :ln] = xs[:, cs + p0:cs + p0 + ln]
            b[:ln] = ws[cs + p0:cs + p0 + ln]
            for kb in range(0, -(-ln // 32) * 32, 32):      # k32 steps
                psum += a[:, kb:kb + 32] @ b[kb:kb + 32]
        assert int(psum.abs().max()) < min(2 ** 31, EXACT_LIMIT)
        v = psum.to(F32)                                    # exact
        if chunk_adc:
            if noise is not None:
                v = v + coef * noise[c]
            v = adc(v)
        carry = carry + v
    if not chunk_adc:
        if noise is not None:
            carry = carry + coef * noise
        carry = adc(carry)
    return (carry * (sx * sw)).to(x.dtype)


def _cfgs(backend: str, bits: int, n: int, noise: bool):
    kw = dict(bits=bits, dpe_size=n, noise_enabled=noise)
    return (JConfig(backend=JBackend(backend), **kw),
            PhotonicConfig(backend=Backend(backend), **kw))


def _inputs(rng, m, k, d, dtype):
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, d)) *
         rng.uniform(0.1, 2.0, (1, d))).astype(np.float32)
    if dtype == "bfloat16":
        # bf16-representable values, so both frameworks see the same x.
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x, w


def _reference(x, w, noise, jcfg, fs, dtype):
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    out = jops._taom_forward(jx, jnp.asarray(w), jnp.asarray(noise), jcfg,
                             fs, "ref", (128, 128))
    return np.asarray(out.astype(jnp.float32))


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("k", [1, 27, 83, 84, 144, 200])
@pytest.mark.parametrize("backend", ["heana", "amw", "maw", "amw_bpca"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_route_emulation_bit_equal_to_reference(k, backend, dtype):
    # bits 4-7 and D in {1, 10, 70} rotate over the cases; noise on and
    # off in each.
    case = [1, 27, 83, 84, 144, 200].index(k) + 3 * len(backend)
    bits = 4 + case % 4
    d = (1, 10, 70)[case % 3]
    m, n = 9, 83 if backend != "maw" else 36
    rng = np.random.default_rng(case * 101 + k)
    x, w = _inputs(rng, m, k, d, dtype)
    for noisy in (True, False):
        jcfg, tcfg = _cfgs(backend, bits, n, noisy)
        assert tcfg.qmax ** 2 * min(n, k) < EXACT_LIMIT
        c = -(-k // n)
        chunk_adc = backend in ("amw", "maw")
        shape = (c, m, d) if chunk_adc else (m, d)
        noise = (rng.standard_normal(shape).astype(np.float32) if noisy
                 else np.zeros(shape, np.float32))
        fs = jcal_fs(k, jcfg)
        want = _reference(x, w, noise, jcfg, fs, dtype)
        tnoise = torch.from_numpy(noise) if noisy else None
        got = _emulate(_torch_x(x, dtype), torch.from_numpy(w), tnoise, tcfg,
                       fs, tkernel.int8_plan(m, k, d, n)["slot"])
        np.testing.assert_array_equal(got.float().numpy(), want)
        port = tkernel.taom_gemm_fused(_torch_x(x, dtype),
                                       torch.from_numpy(w), tnoise, tcfg, fs)
        assert port.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(port.float().numpy(), want)


@pytest.mark.parametrize("n,k,slot", [(250, 500, 192), (83, 300, 32),
                                      (36, 200, 64)])
def test_int8_emulation_slot_pieces_do_not_change_the_result(n, k, slot):
    # A chunk staged in several pieces (N > slot) sums to the same s32
    # psum: the result does not depend on the slot width.
    rng = np.random.default_rng(n + k)
    x, w = _inputs(rng, 17, k, 12, "float32")
    _, tcfg = _cfgs("amw", 7, n, True)
    noise = torch.from_numpy(rng.standard_normal(
        (-(-k // n), 17, 12)).astype(np.float32))
    fs = tkernel.calibrated_adc_fs(k, tcfg)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = _emulate(xt, wt, noise, tcfg, fs, tkernel.int8_plan(17, k, 12,
                                                               n)["slot"])
    assert torch.equal(_emulate(xt, wt, noise, tcfg, fs, slot), want)


@pytest.mark.parametrize("bits,n,route,name", [
    pytest.param(4, 83, "fused", "int8", id="4-fused"),
    pytest.param(7, 83, "fused", "int8", id="7-fused"),
    pytest.param(8, 83, "fused", "s8x2", id="8-fused"),
    pytest.param(8, 259, "float32", "float32", id="8-float32"),
    pytest.param(9, 83, "float32", "float32", id="9-float32")])
def test_photonic_matmul_routes_by_operand_bits(monkeypatch, bits, n, route,
                                                name):
    # impl="kernel": qmax <= 127 takes the fused route on one s8 plane,
    # 8 bits with N qmax^2 < 2^24 (N <= 258) the fused route on two; 8 bits
    # at N 259 and 9 bits the float32 body with quantize and rescale
    # around it.
    calls = []
    fused, body = tkernel.taom_gemm_fused, tkernel.taom_gemm_quantized
    monkeypatch.setattr(tkernel, "taom_gemm_fused",
                        lambda *a, **kw: calls.append("fused") or
                        fused(*a, **kw))
    monkeypatch.setattr(tkernel, "taom_gemm_quantized",
                        lambda *a, **kw: calls.append("float32") or
                        body(*a, **kw))
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=bits, dpe_size=n,
                         noise_enabled=False)
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.standard_normal((2, 5, 100)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((100, 7)).astype(np.float32))
    got = tops.photonic_matmul(x, w, cfg, impl="kernel")
    assert calls == [route]
    assert tkernel.taom_route(cfg) == name
    assert torch.equal(got, tops.photonic_matmul(x, w, cfg, impl="ref"))
    assert calls == [route]                 # impl="ref" calls neither


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_photonic_matmul_widens_other_types_for_the_fused_route(dtype):
    # float16 and float64 reach the fused route as float32 (as the
    # reference's quantize widens them) and come back in their own type.
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((6, 90))).to(dtype)
    w = torch.from_numpy(rng.standard_normal((90, 5))).to(dtype)
    got = tops.photonic_matmul(x, w, cfg, impl="kernel")
    assert got.dtype == dtype
    assert torch.equal(got, tops.photonic_matmul(x, w, cfg, impl="ref"))


def _resnet_mini_path():
    model = ZOO["resnet_mini"]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    acc = pm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    plan = plan_for_network(params, acc, batch=32, in_hw=model.in_hw,
                            lowering=model.graph, cache=PlanCache())
    return [(lp.c, lp.k, lp.d, lp.tile.block_d) for lp in plan.layers]


def test_int8_plan_fills_the_card_at_resnet_mini_shapes():
    # Every served GEMM at batch 32 launches at least 2 x 132 blocks where
    # M allows it; the fc GEMM (M 32) is not one block.
    path = _resnet_mini_path()
    assert len(path) == 13
    for m, k, d, block_d in path:
        plan = tkernel.int8_plan(m, k, d, 83, block_d)
        blocks = plan["grid"][0] * plan["grid"][1]
        at_most = -(-m // 16) * plan["grid"][1]
        assert blocks >= min(tkernel.MIN_BLOCKS, at_most), (m, k, d, plan)
        assert blocks >= 2, (m, k, d, plan)
        assert plan["slot"] == min(96, -(-k // 32) * 32)
        assert plan["width"] >= min(d, block_d)


@pytest.mark.parametrize("m,k,d,n", [(4000, 768, 3352, 83),
                                     (4000, 1536, 768, 83),
                                     (1, 1, 1, 83), (64, 500, 33, 250)])
def test_int8_plan_shapes(m, k, d, n):
    plan = tkernel.int8_plan(m, k, d, n)
    assert plan["slot"] % 32 == 0 and 32 <= plan["slot"] <= tkernel.SLOT_MAX
    assert plan["slot"] >= min(n, k, tkernel.SLOT_MAX)
    assert plan["warps"] in (1, 2, 4)
    assert plan["tile_m"] == 16 * plan["warps"]
    assert plan["grid"] == (-(-m // plan["tile_m"]), -(-d // plan["width"]))
    assert 1 <= plan["x_blocks"] <= tkernel.ABSMAX_BLOCKS
    if d >= 128:
        assert plan["width"] == 128          # the LM widths take BD 128
    pieces = -(-k // n) * -(-n // plan["slot"])
    assert plan["w_bytes"] == pieces * plan["slot"] >= k
    # x is quantized once (a third launch) where the grid has several
    # column tiles or K four pieces, into staged rows of w_bytes each.
    assert plan["x_once"] == (
        (plan["grid"][1] > 1 or pieces >= tkernel.X_ONCE_PIECES) and
        plan["w_bytes"] <= 2 * k)
    assert plan["scratch_bytes"] == (
        (d + m * plan["x_once"]) * plan["w_bytes"] +
        4 * (plan["x_blocks"] + d))


def test_fused_wrapper_checks_on_cpu():
    cfg = PhotonicConfig(backend=Backend.AMW, bits=6, dpe_size=36)
    x, w = torch.zeros(4, 100), torch.zeros(100, 3)
    with pytest.raises(ValueError, match="noise has shape"):
        tkernel.taom_gemm_fused(x, w, torch.zeros(4, 3), cfg, 1.0)
    with pytest.raises(ValueError, match="bits <= 7"):
        tkernel.taom_gemm_fused(x, w, None, dataclasses.replace(cfg, bits=9),
                                1.0)
    with pytest.raises(ValueError, match="bits <= 7"):
        tkernel.taom_gemm_fused(x, w, None, dataclasses.replace(
            cfg, bits=8, dpe_size=259), 1.0)
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        tkernel.taom_gemm_fused(x, torch.zeros(99, 3), None, cfg, 1.0)

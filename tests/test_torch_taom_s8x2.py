"""The fused route's two-plane form ("s8x2", 8-bit operands), held to the
reference on the CPU.

The CUDA kernels of ``repro_torch.kernels.taom_gemm.taom_gemm_fused`` run
only on the card.  Here a plain-torch emulation of their order of
operations for 8-bit operands — the quantize formula, x quantized on load
or once into staged planes, each q in [-255, 255] split into s8 planes
q = 16 h + l (h in [-16, 15], l in [0, 15]), w's planes in the staged
layout (chunks cut into slots padded with zeros to a multiple of 32), the
three exact s32 sums of four s8 products a k32 step (hh, hl + lh, ll),
their combination 256 hh + 16 (hl + lh) + ll — or, for short chunks (the
small-chunk kernel on the CUDA cores), q rebuilt from w's compact planes
and each chunk's N products summed in s32 — one float32 conversion per
chunk, the policy in chunk order, the rescale ``acc * (sx * sw)`` and the
cast — is held bit for bit against the reference package's eager
``_taom_forward(impl="ref")`` (the body of its ``photonic_matmul``) on the
same seeded numpy inputs and noise.  So is the port's wrapper, which on a
CPU tensor runs its plain version.  Tolerance: none (bit-equal); every case
asserts that its chunk psums stay below 2^24 (N qmax^2 < 2^24, N <= 258),
where the reference's float32 chunk dot products are exact integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Backend as JBackend
from repro.core.types import PhotonicConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels.taom_gemm import calibrated_adc_fs as jcal_fs

from repro_torch.core.photonic_gemm import CHUNK_ADC_BACKENDS, detection_sigma
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import taom_gemm as tkernel

EXACT_LIMIT = 2 ** 24
F32 = torch.float32
I64 = torch.int64


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


def _planes(q: torch.Tensor):
    """q (integers in [-255, 255]) as its s8 planes (h, l): q = 16 h + l."""
    h = torch.div(q, 16, rounding_mode="floor")         # q >> 4
    l = q - 16 * h                                      # q & 15
    assert int(h.min()) >= -16 and int(h.max()) <= 15
    assert int(l.min()) >= 0 and int(l.max()) <= 15
    hs, ls = h.to(torch.int8), l.to(torch.int8)
    assert torch.equal(16 * hs.to(I64) + ls.to(I64), q)
    return hs, ls


def _staged(rows: torch.Tensor, n: int, slot: int) -> torch.Tensor:
    """(R, K) s8 rows in the staged layout: chunk c's piece i at bytes
    [(c * ppc + i) * slot, + slot), zeros past each chunk's end."""
    r, k = rows.shape
    ppc = -(-n // slot)
    out = torch.zeros((r, -(-k // n) * ppc * slot), dtype=torch.int8)
    kk = torch.arange(k)
    c, within = kk // n, kk % n
    out[:, (c * ppc + within // slot) * slot + within % slot] = rows
    return out


def _emulate(x: torch.Tensor, w: torch.Tensor, noise, cfg: PhotonicConfig,
             adc_fs: float, plan: dict) -> torch.Tensor:
    """The s8x2 kernels' arithmetic, step by step, in plain torch."""
    qmax = cfg.qmax
    assert tkernel.INT8_QMAX < qmax <= tkernel.S8X2_QMAX
    inv_qmax, eps = _f32(1.0 / qmax), _f32(tkernel.QUANT_EPS)
    xf, wf = x.to(F32), w.to(F32)
    sx = torch.maximum(xf.abs().amax(), eps) * inv_qmax
    sw = torch.maximum(wf.abs().amax(dim=0), eps) * inv_qmax
    xi = torch.clamp(torch.round(xf / sx), -qmax, qmax).to(I64)
    wi = torch.clamp(torch.round(wf / sw), -qmax, qmax).to(I64)
    m, k = x.shape
    d = w.shape[1]
    n, slot = cfg.dpe_size, plan["slot"]
    ppc = -(-n // slot)
    if plan["small"]:           # compact planes: one piece of N a chunk
        assert slot == n and ppc == 1 and not plan["x_once"]
    # w's planes staged once (absmax kernel), (D, kp) each; x's staged
    # once (x_once: the quantize-x kernel) or sliced piece by piece.
    w_st = [_staged(p.T, n, slot) for p in _planes(wi)]
    x_pl = _planes(xi)
    x_st = [_staged(p, n, slot) for p in x_pl] if plan["x_once"] else None
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
        sums = [torch.zeros((m, d), dtype=I64) for _ in range(3)]
        if plan["small"]:
            # q = 16 h + l from w's compact planes, N products in s32.
            wq = 16 * w_st[0][:, c * n:c * n + clen].to(I64) + \
                w_st[1][:, c * n:c * n + clen].to(I64)
            sums[2] += xi[:, cs:cs + clen] @ wq.T
        for i, p0 in enumerate(range(0, clen if not plan["small"] else 0,
                                     slot)):
            ln = min(slot, clen - p0)
            at = (c * ppc + i) * slot
            if x_st is not None:
                a = [p[:, at:at + slot].to(I64) for p in x_st]
            else:                                       # padded slot
                a = [torch.zeros((m, slot), dtype=I64) for _ in x_pl]
                for dst, p in zip(a, x_pl):
                    dst[:, :ln] = p[:, cs + p0:cs + p0 + ln]
            b = [p[:, at:at + slot].T.to(I64) for p in w_st]
            for kb in range(0, -(-ln // 32) * 32, 32):      # k32 steps
                ak = [t[:, kb:kb + 32] for t in a]
                bk = [t[kb:kb + 32] for t in b]
                sums[0] += ak[0] @ bk[0]
                sums[1] += ak[0] @ bk[1] + ak[1] @ bk[0]
                sums[2] += ak[1] @ bk[1]
        assert max(int(s.abs().max()) for s in sums) < 2 ** 31
        psum = sums[0] * 256 + sums[1] * 16 + sums[2]       # s32, exact
        assert torch.equal(psum, xi[:, cs:cs + clen] @ wi[cs:cs + clen])
        assert int(psum.abs().max()) < EXACT_LIMIT
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


def _cfgs(backend: str, n: int, noise: bool, bits: int = 8):
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


# K for each N: N 1 and 2 cut K 27 into 27 and 14 chunks (Table 4's
# conv1); N 83 and 128 end on a short chunk; N 258 stages its first chunk
# in two pieces (slot 192).
K_FOR_N = {1: 27, 2: 27, 83: 200, 128: 300, 258: 300}


@pytest.mark.parametrize("n", sorted(K_FOR_N))
@pytest.mark.parametrize("backend", ["heana", "int_quant", "amw", "maw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s8x2_route_emulation_bit_equal_to_reference(n, backend, dtype):
    # Noise on and off in each case; x quantized on load and once.
    k = K_FOR_N[n]
    case = sorted(K_FOR_N).index(n) + 5 * len(backend)
    m, d = (9, 17)[case % 2], (1, 10, 70)[case % 3]
    rng = np.random.default_rng(case * 103 + k)
    x, w = _inputs(rng, m, k, d, dtype)
    for noisy in (True, False):
        jcfg, tcfg = _cfgs(backend, n, noisy)
        assert tkernel.taom_route(tcfg) == "s8x2"
        assert tcfg.qmax ** 2 * n < EXACT_LIMIT
        c = -(-k // n)
        shape = (c, m, d) if backend in ("amw", "maw") else (m, d)
        noise = (rng.standard_normal(shape).astype(np.float32) if noisy
                 else np.zeros(shape, np.float32))
        fs = jcal_fs(k, jcfg)
        want = _reference(x, w, noise, jcfg, fs, dtype)
        tnoise = torch.from_numpy(noise) if noisy else None
        xt, wt = _torch_x(x, dtype), torch.from_numpy(w)
        plans = [tkernel.int8_plan(m, k, d, n, planes=2, x_once=x_once,
                                   small=False) for x_once in (False, True)]
        if n <= tkernel.SMALL_N:
            plans.append(tkernel.int8_plan(m, k, d, n, planes=2, small=True))
        for plan in plans:
            got = _emulate(xt, wt, tnoise, tcfg, fs, plan)
            np.testing.assert_array_equal(got.float().numpy(), want)
        port = tkernel.taom_gemm_fused(xt, wt, tnoise, tcfg, fs)
        assert port.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(port.float().numpy(), want)


@pytest.mark.parametrize("factor", [1.0, 0.7, 3.3])
def test_s8x2_emulation_at_half_integers_and_the_plane_edges(factor):
    # Operands at (near) half-integer multiples of their scale, every q in
    # [-255, 255] reached (h = -16 and 15, l = 0 and 15), K 64 (so every
    # chunk sum is an integer below 2^24, summed exactly in any order):
    # the emulation and the port's plain route equal the reference.
    qmax = 255
    halves = np.arange(-2 * qmax, 2 * qmax + 1) * 0.5
    halves = np.concatenate([halves, np.zeros(3)]).astype(np.float32)
    rows = [halves, np.nextafter(halves, np.float32(np.inf)),
            np.nextafter(halves, np.float32(-np.inf))]
    x = (np.concatenate(rows).reshape(-1, 64) * np.float32(factor))
    w = (halves[::16, None] * np.array([factor, 1.0, 0.3, 7.0],
                                       np.float32))
    m, k = x.shape
    for backend, n in (("heana", 83), ("int_quant", 2)):
        jcfg, tcfg = _cfgs(backend, n, False)
        fs = jcal_fs(k, jcfg)
        want = _reference(x, w, np.zeros((m, 4), np.float32), jcfg, fs,
                          "float32")
        xt, wt = torch.from_numpy(x), torch.from_numpy(w)
        for x_once, small in ((False, False), (True, False), (False, True)):
            if small and n > tkernel.SMALL_N:
                continue
            plan = tkernel.int8_plan(m, k, 4, n, planes=2, x_once=x_once,
                                     small=small)
            np.testing.assert_array_equal(
                _emulate(xt, wt, None, tcfg, fs, plan).numpy(), want)
        np.testing.assert_array_equal(
            tops.photonic_matmul(xt, wt, tcfg, impl="kernel").numpy(), want)


def test_s8x2_planes_cover_every_8_bit_value():
    q = torch.arange(-255, 256)
    h, l = _planes(q)
    assert int(h.min()) == -16 and int(h.max()) == 15
    assert int(l.min()) == 0 and int(l.max()) == 15


@pytest.mark.parametrize("bits,n,route", [(8, 1, "s8x2"), (8, 258, "s8x2"),
                                          (8, 259, "float32"),
                                          (9, 1, "float32"),
                                          (7, 5000, "int8")])
def test_taom_route_by_bits_and_chunk(bits, n, route):
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=bits, dpe_size=n)
    assert tkernel.taom_route(cfg) == route
    assert (route == "s8x2") == (
        127 < cfg.qmax <= 255 and n * cfg.qmax ** 2 < EXACT_LIMIT)


@pytest.mark.parametrize("m,k,d,n,x_once,small", [
    (2048, 768, 3352, 128, True, False),            # QAT in_proj
    (2048, 1536, 768, 128, True, False),            # QAT out_proj
    (131072, 27, 16, 83, False, False),             # Table 4, int8
    (8192, 288, 32, 83, True, False),               # one tile, 4 pieces
    (32768, 144, 32, 83, False, False),             # one tile, 2 pieces
    (131072, 27, 16, 8, False, True),               # the longest small N
    (131072, 27, 16, 16, False, False),             # past it: the slot
    (131072, 27, 16, 2, False, True),               # Table 4, HEANA
    (8192, 288, 32, 1, False, True),                # Table 4, MAW
    (512, 300, 300, 33, False, False),  # staging would inflate x 2.1x
    (300, 300, 10, 258, False, False)])             # one column tile
def test_s8x2_plan_quantizes_x_once_where_it_has_several_tiles(
        m, k, d, n, x_once, small):
    plan = tkernel.int8_plan(m, k, d, n, planes=2)
    assert plan["planes"] == 2
    assert (plan["x_once"], plan["small"]) == (x_once, small)
    assert plan["w_bytes"] == -(-k // n) * -(-n // plan["slot"]) * \
        plan["slot"]
    def round16(v):
        return -(-v // 16) * 16

    assert plan["scratch_bytes"] == (
        round16(2 * d * plan["w_bytes"]) +
        (round16(2 * m * plan["w_bytes"]) if x_once else 0) +
        4 * (plan["x_blocks"] + d))
    if small:
        assert plan["slot"] == n and plan["w_bytes"] == -(-k // n) * n
        assert plan["width"] in tkernel.SMALL_TILE_WIDTHS
        assert plan["tile_m"] == tkernel.SMALL_THREADS // plan["width"] * \
            plan["height"]
    else:
        assert plan["height"] == plan["warps"]
        assert plan["tile_m"] == 16 * plan["warps"]
    one = tkernel.int8_plan(m, k, d, n)
    assert one["planes"] == 1
    assert {key: plan[key] for key in plan if key not in
            ("planes", "scratch_bytes")} == \
        {key: one[key] for key in one if key not in
         ("planes", "scratch_bytes")}


def test_wrappers_count_launches_per_route_on_cpu_not_at_all():
    # A CPU tensor takes the plain version: no launch is counted.
    before = (tkernel.LAUNCHES, dict(tkernel.ROUTE_LAUNCHES))
    _, cfg = _cfgs("heana", 83, False)
    x, w = torch.randn(4, 90), torch.randn(90, 5)
    tops.photonic_matmul(x, w, cfg, impl="kernel")
    assert (tkernel.LAUNCHES, tkernel.ROUTE_LAUNCHES) == before
    assert set(tkernel.ROUTE_LAUNCHES) == set(tkernel.ROUTES)

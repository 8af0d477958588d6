"""Port conformance: the TAOM GEMM, quantize, ADC and photonic_matmul.

The same seeded numpy inputs go through the JAX reference package (its
Pallas kernel in interpret mode, and its pure-jnp oracle) and through the
port on the CPU, where the port's kernel wrapper runs its plain PyTorch
version.  Tolerance: bit-equal wherever the integer psums stay below 2^24
(every test asserts that bound on its inputs), except the STE gradients,
which are plain float matmuls whose summation order differs between XLA
and PyTorch (rtol 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.taom import quantize as jquantize
from repro.core.types import Backend as JBackend
from repro.core.types import PhotonicConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.taom_gemm import adc_round as jadc_round
from repro.kernels.taom_gemm import calibrated_adc_fs as jcal_fs
from repro.kernels.taom_gemm import taom_gemm_quantized as jkernel

from repro_torch.core import photonic_gemm as tpg
from repro_torch.core.taom import quantize as tquantize
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import taom_gemm as tkernel

EXACT_LIMIT = 2.0 ** 24


def _cfgs(backend: str, bits: int, n: int, noise: bool = True):
    kw = dict(bits=bits, dpe_size=n, noise_enabled=noise)
    return (JConfig(backend=JBackend(backend), **kw),
            PhotonicConfig(backend=Backend(backend), **kw))


def _int_operands(rng, m, k, d, bits):
    qmax = (1 << bits) - 1
    xq = rng.integers(-qmax, qmax + 1, (m, k)).astype(np.float32)
    wq = rng.integers(-qmax, qmax + 1, (k, d)).astype(np.float32)
    bound = (np.abs(xq).astype(np.float64) @ np.abs(wq).astype(np.float64))
    assert bound.max() < EXACT_LIMIT, "inputs leave the exact-f32 range"
    return xq, wq


# (M, K, D, N): C = 1, C = 2 (resnet_mini's K=144 at N=83), ragged C >= 3.
SHAPES = [(37, 50, 9, 83), (64, 144, 16, 83), (50, 200, 37, 36)]


@pytest.mark.parametrize("m,k,d,n", SHAPES)
@pytest.mark.parametrize("backend", ["heana", "amw"])
@pytest.mark.parametrize("bits", [6, 8])
def test_taom_gemm_plain_bit_equal_to_reference(m, k, d, n, backend, bits):
    rng = np.random.default_rng(m * 1000 + k + bits)
    xq, wq = _int_operands(rng, m, k, d, bits)
    jcfg, tcfg = _cfgs(backend, bits, n)
    c = -(-k // n)
    shape = (c, m, d) if backend == "amw" else (m, d)
    noise = rng.standard_normal(shape).astype(np.float32)
    fs = jcal_fs(k, jcfg)
    assert tkernel.calibrated_adc_fs(k, tcfg) == fs
    got = tkernel.taom_gemm_quantized(torch.from_numpy(xq),
                                      torch.from_numpy(wq),
                                      torch.from_numpy(noise), tcfg, fs)
    want_kernel = np.asarray(jkernel(jnp.asarray(xq), jnp.asarray(wq),
                                     jnp.asarray(noise), jcfg, fs,
                                     interpret=True))
    want_oracle = np.asarray(jref.taom_gemm_reference(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(noise), jcfg, fs))
    assert tpg.detection_sigma(tcfg) > 0.0
    np.testing.assert_array_equal(got.numpy(), want_oracle)
    if backend == "amw" and c > 1:
        # The reference's own compiled kernel body fuses its running sum
        # `acc + q * step` into one FMA, so each of its C-1 additions may
        # round differently from its eager oracle (which the port equals):
        # up to C-1 ULPs of the largest running sum, C * chunk full scale.
        tol = (c - 1) * np.spacing(np.float32(c * tkernel.chunk_fs(tcfg)))
        assert np.abs(got.numpy() - want_kernel).max() <= tol
    else:
        np.testing.assert_array_equal(got.numpy(), want_kernel)


@pytest.mark.parametrize("backend", ["heana", "amw", "maw"])
def test_taom_gemm_plain_noise_off_equals_zero_noise_reference(backend):
    # Noise off passes noise=None and the GEMM leaves the noise term out;
    # the reference adds sigma * 0.  Both must give the same values.
    rng = np.random.default_rng(3)
    m, k, d, n = 40, 200, 12, 36
    xq, wq = _int_operands(rng, m, k, d, 6)
    jcfg, tcfg = _cfgs(backend, 6, n, noise=False)
    c = -(-k // n)
    shape = (c, m, d) if backend in ("amw", "maw") else (m, d)
    fs = jcal_fs(k, jcfg)
    got = tkernel.taom_gemm_quantized(torch.from_numpy(xq),
                                      torch.from_numpy(wq), None, tcfg, fs)
    want = np.asarray(jref.taom_gemm_reference(
        jnp.asarray(xq), jnp.asarray(wq), jnp.zeros(shape, jnp.float32),
        jcfg, fs))
    np.testing.assert_array_equal(got.numpy(), want)


def test_taom_gemm_wrapper_checks_shapes():
    _, cfg = _cfgs("amw", 6, 36)
    x, w = torch.zeros(4, 100), torch.zeros(100, 3)
    with pytest.raises(ValueError, match="noise has shape"):
        tkernel.taom_gemm_quantized(x, w, torch.zeros(4, 3), cfg, 1.0)
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        tkernel.taom_gemm_quantized(x, torch.zeros(99, 3),
                                    torch.zeros(3, 4, 3), cfg, 1.0)


def test_kernel_tile_mapping():
    # The width is the smallest of 8/16/32/64 covering min(D, block_d).
    assert tkernel.kernel_tile(10, 128) == 16
    assert tkernel.kernel_tile(64, 128) == 64
    assert tkernel.kernel_tile(200, 256) == 64
    assert tkernel.kernel_tile(8, 128) == 8
    assert tkernel.kernel_tile(32, 8) == 8
    assert tkernel.kernel_tile(16, 128) == 16
    assert tkernel.kernel_tile(33, 128) == 64


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("axis", [None, 0])
def test_quantize_bit_equal_including_ties(bits, axis):
    qmax = (1 << bits) - 1
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((33, 7)).astype(np.float32)
    # A column whose scale is exactly 2^-2 (absmax qmax/4) and whose other
    # entries are exact half-way ties (k + 1/2 in scale units), where
    # round-half-to-even decides: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2, 2.5 -> 2.
    assert np.float32(qmax * 0.25) * np.float32(1.0 / qmax) == 0.25
    x[:, 3] = 0.0
    x[:5, 3] = np.array([qmax, 0.5, 1.5, -2.5, 2.5], np.float32) * 0.25
    jq, js = jquantize(jnp.asarray(x), bits, axis=axis)
    tq, ts = tquantize(torch.from_numpy(x), bits, axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if axis == 0:
        np.testing.assert_array_equal(tq.numpy()[:5, 3],
                                      [qmax, 0.0, 2.0, -2.0, 2.0])


@pytest.mark.parametrize("adc_bits", [6, 8])
def test_adc_round_bit_equal_including_ties(adc_bits):
    fs = 1000.0
    step, inv_step, hi = tkernel._adc_constants(adc_bits, fs)
    rng = np.random.default_rng(adc_bits)
    v = (rng.standard_normal(4096) * fs).astype(np.float32)
    # values at and beyond the clip bound, and candidate half-way points
    v[:64] = (np.arange(-32, 32, dtype=np.float32) + 0.5) * np.float32(step)
    v[64:68] = [2 * fs, -2 * fs, hi * step, -hi * step]
    got = tkernel.adc_round(torch.from_numpy(v), adc_bits, fs).numpy()
    want = np.asarray(jadc_round(jnp.asarray(v), adc_bits, fs))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() <= hi * np.float32(step)


def _matmul_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 150)).astype(np.float32)
    w = (rng.standard_normal((150, 12)) / 12.0).astype(np.float32)
    return x, w


@pytest.mark.parametrize("backend", ["heana", "amw", "maw_bpca"])
def test_photonic_matmul_values_noise_off(backend):
    x, w = _matmul_inputs()
    jcfg, tcfg = _cfgs(backend, 6, 83, noise=False)
    want = np.asarray(jops.photonic_matmul(jnp.asarray(x), jnp.asarray(w),
                                           jcfg, impl="ref"))
    for impl in ("auto", "kernel", "ref"):
        got = tops.photonic_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   tcfg, impl=impl)
        assert got.shape == (2, 5, 12)
        np.testing.assert_array_equal(got.numpy(), want)


def test_photonic_matmul_exact_backend():
    x, w = _matmul_inputs(1)
    _, tcfg = _cfgs("exact", 6, 83, noise=True)
    got = tops.photonic_matmul(torch.from_numpy(x), torch.from_numpy(w), tcfg)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)


def test_photonic_matmul_ste_gradients():
    x, w = _matmul_inputs(2)
    g = np.random.default_rng(9).standard_normal((2, 5, 12)).astype(
        np.float32)
    jcfg, tcfg = _cfgs("heana", 6, 83, noise=False)
    _, vjp = jax.vjp(lambda a, b: jops.photonic_matmul(a, b, jcfg,
                                                       impl="ref"),
                     jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tops.photonic_matmul(tx, tw, tcfg).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5,
                               atol=1e-6)


def test_photonic_matmul_noise_contract_and_chunk_noise_layout():
    x, w = _matmul_inputs(3)
    _, cfg = _cfgs("amw", 6, 36, noise=True)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="generator=None"):
        tops.photonic_matmul(tx, tw, cfg)
    got = tops.photonic_matmul(tx, tw, cfg,
                               generator=tpg.generator_for(5, "cpu"))
    # The same draws, moved (M, C, D) -> (C, M, D) by hand.
    x2d = tx.reshape(-1, 150)
    noise = tpg.sample_noise(tpg.generator_for(5, "cpu"), tuple(x2d.shape),
                             tuple(tw.shape), cfg)
    assert noise.shape == (10, 5, 12)
    xq, sx = tquantize(x2d, cfg.bits)
    wq, sw = tquantize(tw, cfg.bits, axis=0)
    acc = tref.taom_gemm_reference(xq, wq, noise.permute(1, 0, 2), cfg,
                                   tkernel.calibrated_adc_fs(150, cfg))
    assert torch.equal(got.reshape(10, 12), acc * (sx * sw))


def test_noise_sampler_statistics():
    """The port's sampler (a torch.Generator) is not jax.random, so it is
    held statistically: standard normal, reproducible from its seed, and
    independent across folded seeds."""
    _, cfg = _cfgs("heana", 6, 83)
    noise = tpg.sample_noise(tpg.generator_for(11, "cpu"), (4096, 144),
                             (144, 64), cfg)
    assert noise.shape == (4096, 64) and noise.dtype == torch.float32
    z = noise.double()
    count = z.numel()
    assert abs(z.mean().item()) < 5.0 / np.sqrt(count)
    assert abs(z.std().item() - 1.0) < 5.0 / np.sqrt(2.0 * count)
    again = tpg.sample_noise(tpg.generator_for(11, "cpu"), (4096, 144),
                             (144, 64), cfg)
    other = tpg.sample_noise(tpg.generator_for(tpg.fold_seed(11, 1), "cpu"),
                             (4096, 144), (144, 64), cfg)
    assert torch.equal(noise, again)
    corr = (noise.double() * other.double()).mean().item()
    assert abs(corr) < 5.0 / np.sqrt(count)
    assert len({tpg.fold_seed(11, i) for i in range(64)}) == 64


@pytest.mark.parametrize("backend", ["heana", "amw"])
def test_noise_at_adc_input(backend):
    """With zero operands the ADC input is the detection noise alone:
    sigma * sqrt(C) * z once per output for analog carry, sigma * z per
    chunk for chunk-ADC.  Analog carry is read through a fine ADC, so its
    output is the ADC input to within 0.03% in variance; chunk-ADC rounds
    every chunk at chunk_fs, so its output is compared with the same
    rounding applied to independent numpy normals (rtol 3%)."""
    m, k, d, n = 4096, 200, 64, 36                      # C = 6
    _, cfg = _cfgs(backend, 6, n)
    sigma = tpg.detection_sigma(cfg)
    noise = tpg.sample_noise(tpg.generator_for(21, "cpu"), (m, k), (k, d),
                             cfg)
    if backend == "amw":
        noise = noise.movedim(-2, 0).contiguous()
    # Analog carry reads out over +-8 sigma*sqrt(C): no clipping to speak
    # of, and a step of 0.06 sigma*sqrt(C) (rounding adds 0.03% variance).
    out = tkernel.taom_gemm_quantized(torch.zeros(m, k), torch.zeros(k, d),
                                      noise, cfg, 8.0 * sigma * np.sqrt(6.0))
    got = out.double()
    if backend == "heana":
        want_std = sigma * np.sqrt(6.0)
    else:
        step, inv_step, hi = tkernel._adc_constants(cfg.adc_bits,
                                                    tkernel.chunk_fs(cfg))
        z = np.random.default_rng(0).standard_normal(1 << 20) * sigma
        q = np.clip(np.round(z * inv_step), -hi, hi) * step
        want_std = np.sqrt(6.0 * q.var())
    assert abs(got.mean().item()) < 5.0 * want_std / np.sqrt(m * d)
    assert abs(got.std().item() / want_std - 1.0) < 0.03


def test_device_level_pieces_equal_reference():
    """The BPCA/TAOM device-model pieces the port carries (off the main
    path): same values as the reference on the same inputs."""
    from repro.core import bpca as jbpca
    from repro.core import taom as jtaom
    from repro_torch.core import bpca as tbpca
    from repro_torch.core import taom as ttaom
    rng = np.random.default_rng(5)
    a = rng.integers(-63, 64, (6, 83)).astype(np.float32)
    w = rng.integers(-63, 64, (6, 83)).astype(np.float32)
    jt, jd = jtaom.taom_multiply(jnp.asarray(a), jnp.asarray(w))
    tt, td = ttaom.taom_multiply(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for got, want in zip(ttaom.encode_time_amplitude(torch.from_numpy(a),
                                                     torch.from_numpy(w), 6),
                         jtaom.encode_time_amplitude(jnp.asarray(a),
                                                     jnp.asarray(w), 6)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)
    psum = tbpca.integrate_cycle(tt, td)
    np.testing.assert_array_equal(
        psum.numpy(), np.asarray(jbpca.integrate_cycle(jt, jd)))
    _, cfg = _cfgs("heana", 6, 83, noise=False)
    total = tbpca.accumulate(psum.reshape(2, 3), cfg=cfg)
    np.testing.assert_array_equal(total.numpy(), psum.numpy().reshape(2, 3)
                                  .sum(axis=-1))
    v = (rng.standard_normal(500) * 3e4).astype(np.float32)
    got = tbpca.adc_readout(torch.from_numpy(v), 8, 2.5e4).numpy()
    want = np.asarray(jbpca.adc_readout(jnp.asarray(v), 8,
                                        jnp.float32(2.5e4)))
    np.testing.assert_array_equal(got, want)

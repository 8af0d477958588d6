"""Port tests that need an NVIDIA CUDA card (marker ``gpu``; they skip
elsewhere).  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

They hold the CUDA kernel against its plain PyTorch version on the card,
bit for bit where the integer psums stay below 2^24 (asserted), and run
the zoo networks end to end through the kernel.  They import no JAX.
"""
import pytest
import torch

from repro_torch.core import perf_model as pm
from repro_torch.core.taom import quantize
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.exec import PlanCache, execute_cnn, plan_for_network
from repro_torch.kernels import ref, taom_gemm
from repro_torch.models import lowering as lw
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

"""Port hygiene: importing ``repro_torch`` loads neither JAX nor the
reference package and compiles nothing; entry points run on the CUDA card
unless told otherwise and never fall back to the CPU quietly; the
``examples_torch`` scripts import neither package nor the reference's
benchmarks and run on the card unless ``--device`` names another device;
and ``chip_smoke.py`` imports neither package and refuses to run without
a card."""
import ast
import glob
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core import types as ttypes
from repro_torch.core.types import Backend, Dataflow, PhotonicConfig
from repro_torch.core import perf_model as tpm
from repro_torch.exec import ServingEngine, execute_cnn
from repro_torch.kernels import taom_gemm
from repro_torch.launch import train as ttrain
from repro_torch.models.zoo_cnn import ZOO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EXAMPLES = os.path.join(ROOT, "examples_torch")
# The ten scripts, each with the flags that keep a CPU run short.
EXAMPLE_ARGS = {"quickstart": [], "autoflow_inference": [],
                "serving_throughput": [], "serving_engine": [],
                "zoo_inference": ["--smoke"], "operating_point": [],
                "heana_cnn_inference": [], "serve_lm": [],
                "train_lm": ["--smoke", "--steps", "1"],
                "photonic_qat": ["--steps", "1"]}

_IMPORT_ALL = r"""
import json, pkgutil, importlib, subprocess, sys
calls = []
class _Spy(subprocess.Popen):
    def __init__(self, *a, **k):
        calls.append(repr(a[0] if a else k.get("args")))
        raise RuntimeError("no process may start at import time")
subprocess.Popen = _Spy
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import flash_attention, ssd_scan, taom_gemm
print(json.dumps({
    "modules": names,
    "foreign": sorted(k for k in sys.modules
                      if k.split(".")[0] in ("jax", "jaxlib", "repro")),
    "processes": calls,
    "library_loaded": taom_gemm._LIB is not None,
    "ssd_library_loaded": ssd_scan._LIB is not None,
    "flash_library_loaded": flash_attention._LIB is not None,
    "process_group": __import__("torch").distributed.is_initialized(),
}))
"""


def test_import_loads_no_jax_no_reference_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels.taom_gemm" in report["modules"]
    assert "repro_torch.exec.serving" in report["modules"]
    for name in ("configs", "configs.base", "configs.mamba2_130m",
                 "models.layers", "models.ssm", "models.transformer",
                 "models.model_zoo", "launch.serve", "kernels.ssd_scan",
                 "kernels.nvcc", "models.attention", "models.moe",
                 "kernels.flash_attention", "launch.train",
                 "optim.optimizer", "data.pipeline",
                 "checkpoint.checkpoint", "runtime.fault_tolerance",
                 "parallel", "parallel.sharding", "parallel.sharded_ce",
                 "parallel.pipeline_parallel", "optim.compression",
                 "launch.mesh", "launch.dryrun"):
        assert f"repro_torch.{name}" in report["modules"], name
    assert report["foreign"] == []
    assert report["processes"] == []
    assert report["library_loaded"] is False
    assert report["ssd_library_loaded"] is False
    assert report["flash_library_loaded"] is False
    assert report["process_group"] is False


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    model = ZOO["small_cnn"]
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    acc = tpm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83,
                         noise_enabled=False)
    return model, params, acc, cfg


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    model, params, acc, cfg = _small()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttypes.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttypes.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, acc, cfg, lowering=model.graph,
                      in_hw=model.in_hw)
    engine = ServingEngine(params, acc, cfg, lowering=model.graph,
                           in_hw=model.in_hw, max_batch=2, device="cpu")
    x = torch.zeros(2, *model.in_hw, model.in_ch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_cnn(params, x, engine.plans[2], cfg, lowering=model.graph)
    got = execute_cnn(params, x, engine.plans[2], cfg, lowering=model.graph,
                      device="cpu")
    assert got.logits.shape == (2, 10)
    # data-parallel serving over the CPU entries given; one entry is one
    # device, so the flag takes no effect (and never reaches for a card)
    dp = ServingEngine(params, acc, cfg, lowering=model.graph,
                       in_hw=model.in_hw, device="cpu", data_parallel=True)
    assert dp.devices == [torch.device("cpu")] and not dp.data_parallel
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, acc, cfg, lowering=model.graph,
                      in_hw=model.in_hw, device="cpu", data_parallel=True,
                      devices=["cpu", "cuda"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from repro_torch.launch import mesh as tmesh
        tmesh.make_local_mesh()


def test_train_runs_on_the_card_unless_told_otherwise(no_cuda, monkeypatch,
                                                    capsys):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("mamba2-130m", steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train("mamba2-130m", steps=1, device="cuda")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "mamba2-130m",
                                      "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main()
    monkeypatch.setattr(sys, "argv", sys.argv + ["--batch", "2", "--seq",
                                                 "8", "--device", "cpu"])
    ttrain.main()
    assert "done: loss" in capsys.readouterr().out


def test_seeded_params_are_device_independent():
    model = ZOO["resnet_mini"]
    a = model.init_params(torch.Generator().manual_seed(3), device="cpu")
    b = model.init_params(torch.Generator().manual_seed(3), device="cpu")
    assert list(a) == [n.name for n in model.graph.gemm_nodes]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(v.device.type == "cpu" for v in a.values())


def test_kernel_wrapper_refuses_other_devices():
    cfg = PhotonicConfig(backend=Backend.HEANA, bits=6, dpe_size=83)
    meta = torch.empty(4, 10, device="meta")
    with pytest.raises(ValueError, match="no TAOM kernel"):
        taom_gemm.taom_gemm_quantized(meta, torch.empty(10, 3, device="meta"),
                                      torch.empty(4, 3, device="meta"),
                                      cfg, 1.0)


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_refuses_without_a_card(tmp_path):
    script = os.path.join(ROOT, "chip_smoke.py")
    roots = _imported_roots(script)
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
    # No card here: it must fail and print no result line.
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory (without the repo) it must fail too.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(script).read())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_examples_import_no_jax_no_reference_no_benchmarks():
    scripts = sorted(glob.glob(os.path.join(EXAMPLES, "*.py")))
    names = {os.path.basename(p)[:-3] for p in scripts}
    assert set(EXAMPLE_ARGS) <= names
    for path in scripts:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, path
        assert "repro_torch" in roots, path


@pytest.mark.parametrize("name", sorted(EXAMPLE_ARGS))
def test_example_device_defaults_to_the_card(no_cuda, tmp_path, name):
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    argv = EXAMPLE_ARGS[name] + (["--ckpt-dir", str(tmp_path)]
                                 if name == "train_lm" else [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(name).main(argv)

"""The plain reference against the port's engine on the CPU, and what
the harness and the reference import."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness, program
from perfbench.reference import cnn as reference

CONFIGS = ("resnet50-heana4", "mobilenetv2-heana4")


def config(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("hw,batch", [(32, 3), (64, 2)])
def test_reference_equals_engine(name, hw, batch):
    """The engine's plain route (device="cpu") and the reference give the
    same logits bit for bit, padding to a bucket included (batch 3 runs in
    bucket 4)."""
    c = config(name)
    gen = torch.Generator().manual_seed(2 ** 33 + hw)
    params = program.weights(c, hw, gen)
    x = program.images(c, hw, batch, gen)
    got = program.engine(c, params, hw, 4, "cpu").infer(x)
    want = reference.forward(c, params, x)
    assert got.shape == (batch, c["classes"])
    assert torch.equal(got, want)
    assert reference.logit_gap(got, want) == 0.0
    assert want.abs().max() > 0 and (want != 0).float().mean() > 0.5


def test_reference_equals_engine_on_concat_shuffle_slice():
    """The glue of GoogLeNet and ShuffleNet (channel concat, shuffle and
    slice), which neither configuration uses, in a small graph: the
    engine and the reference agree bit for bit."""
    c = dict(config("resnet50-heana4"))
    c["nodes"] = [
        {"name": "x", "op": "input", "cout": 3},
        {"name": "c1", "op": "conv", "inputs": ["x"], "cout": 8,
         "kernel": 3, "stride": 2, "padding": "same", "relu": True},
        {"name": "lo", "op": "slice", "inputs": ["c1"], "c_lo": 0,
         "c_hi": 4},
        {"name": "hi", "op": "slice", "inputs": ["c1"], "c_lo": 4,
         "c_hi": 8},
        {"name": "c2", "op": "conv", "inputs": ["hi"], "cout": 4,
         "kernel": 1, "stride": 1, "padding": "same", "relu": True},
        {"name": "cat", "op": "concat", "inputs": ["lo", "c2"]},
        {"name": "shuf", "op": "shuffle", "inputs": ["cat"], "groups": 2},
        {"name": "c3", "op": "conv", "inputs": ["shuf"], "cout": 6,
         "kernel": 3, "stride": 1, "padding": "same", "relu": True},
        {"name": "gap", "op": "pool", "inputs": ["c3"], "pool": "global"},
        {"name": "fc", "op": "fc", "inputs": ["gap"], "cout": 5}]
    c["classes"] = 5
    gen = torch.Generator().manual_seed(2 ** 33 + 5)
    params = program.weights(c, 16, gen)
    x = program.images(c, 16, 3, gen)
    got = program.engine(c, params, 16, 4, "cpu").infer(x)
    assert torch.equal(got, reference.forward(c, params, x))
    shuffled = [n for n in program.graph(c).nodes if n.op == "shuffle"]
    assert shuffled[0].groups == 2


def _imports(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=harness.ROOT, check=True,
        env={"PYTHONPATH": f"{harness.ROOT / 'src'}:{harness.ROOT}",
             "PATH": "/usr/bin:/bin"})
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    """Everything run.py imports, with every metric reader loaded: no
    module whose top-level name is jax, jaxlib, flax or the JAX package
    (compared whole: repro_torch is the port)."""
    names = _imports(
        "from perfbench import harness\n"
        "import json\n"
        "b = json.loads((harness.ROOT / 'BENCHMARK.json').read_text())\n"
        "[harness.reader(m['name']) for m in b['per_layer'] + "
        "b['end_to_end']]\n"
        "cells = [harness.load(w['name']) for w in b['workloads']]\n"
        "[harness.system(c) for c in cells]\n"
        "[harness.loop(c.mix['loop']) for c in cells]\n"
        "[harness.reference(c.config) for c in cells]\n"
        "import perfbench.run")
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("module", sorted(
    p.stem for p in (harness.HERE / "reference").glob("*.py")
    if p.stem != "__init__"))
def test_reference_imports_nothing_of_the_port(module):
    names = _imports(f"import perfbench.reference.{module}")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}

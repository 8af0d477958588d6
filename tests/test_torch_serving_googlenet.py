"""GoogLeNet's benchmark configuration served through the port's
``ServingEngine`` on the CPU, against the benchmark's plain reference
(``perfbench/reference/cnn.py``): the inception blocks' channel concats,
stride-1 max pools and 5x5 windows on the served walk."""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import program  # noqa: E402
from perfbench.reference import cnn as reference  # noqa: E402
from repro_torch.models import lowering as lw  # noqa: E402


def test_googlenet_served_equals_the_reference_and_walks_its_glue():
    """Batch 3 padded to bucket 4 at 32x32 on seeded weights: the logits
    equal the reference's bit for bit, and each walk of the graph applied
    its 9 concats and 14 pools (4 stride-2, 9 stride-1, the global
    mean) and nothing else of the glue."""
    c = json.loads((ROOT / "perfbench" / "configs" / "googlenet-heana4.json")
                   .read_text())
    gen = torch.Generator().manual_seed(2 ** 33 + 24)
    params = program.weights(c, 32, gen)
    x = program.images(c, 32, 3, gen)
    eng = program.engine(c, params, 32, 4, "cpu")
    before = dict(lw.GLUE_CALLS)
    got = eng.infer(x)
    walked = {k: lw.GLUE_CALLS[k] - before[k] for k in before}
    assert walked == {"pool": 14, "residual_add": 0, "concat": 9,
                      "shuffle": 0, "slice": 0}, walked
    want = reference.forward(c, params, x)
    assert got.shape == (3, 1000)
    assert torch.equal(got, want)
    assert want.abs().max() > 0

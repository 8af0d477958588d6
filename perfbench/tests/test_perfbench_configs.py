"""The configurations pinned to the paper's tables, and BENCHMARK.json's
cells, names and readers."""
import collections
import json
import re

import pytest

from perfbench import harness, loadgen, program
from repro_torch.models import cnn

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name,table", [("resnet50-heana4", cnn.resnet50),
                                        ("mobilenetv2-heana4",
                                         cnn.mobilenet_v2)])
def test_config_gemms_match_the_paper_table(name, table):
    """The node records at 224 give exactly the (M, K, D, count) multiset
    of the port's analytic table of the network."""
    c = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    got = collections.Counter((g.c, g.k, g.d, g.count)
                              for g in program.gemms(c, 224))
    want = collections.Counter((g.c, g.k, g.d, g.count) for g in table())
    assert got == want
    assert c["reduced"] == [] and c["input"]["hw"] == 224
    op = program.operating_point(c)
    assert (op.bits, op.n, op.adc_bits, op.noise_enabled) == (4, 83, 8,
                                                              False)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_exist(cell):
    c = harness.load(cell)
    assert c.entry["config"] in {x["name"] for x in BENCH["configs"]}
    assert (harness.HERE / "traffic" / f"{c.entry['traffic']}.json").exists()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert harness.system(c).run_cell
    assert callable(harness.loop(c.mix["loop"]).run)
    assert callable(harness.reference(c.config).forwards)
    mix = c.mix
    assert max(mix["sizes"]) <= mix["max_batch"]
    assert loadgen.pool_images(mix) == len(loadgen.compositions(mix)) \
        // len(mix["sizes"]) * max(mix["sizes"])


def test_names_units_and_readers():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for group in (BENCH["end_to_end"] + BENCH["per_layer"],
                  BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert callable(harness.reader(m["name"]))
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1

"""What a cell is made of, found by name from its entry in
``BENCHMARK.json``: the configuration file it names, the traffic mix in
``perfbench/traffic/<traffic>.json``, the mix's arrival process in
``perfbench/loops/<loop>.py`` (``loop``), each metric's reader in
``perfbench/metrics/`` (``reader``), the system that runs the
configuration, ``perfbench/systems/<system>.py`` (``system``), and its
plain reference, ``perfbench/reference/<reference>.py`` (``reference``),
both named in the configuration file.  A system module has
``run_cell(cell, seed, seconds, trace, t_start)``, which returns the
result line as a dict.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def cards(self) -> int:
        return int(self.entry["chips"])


def load(workload: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moves)]
    return Cell(workload, entry, config, mix, e2e, layer)


def _module(folder: str, stem: str):
    """``perfbench/<folder>/<stem>.py`` as a module, or None where there
    is no such file.  Loaded from its path, so a name may hold ``.`` and
    ``-``; loaded once a process."""
    key = f"perfbench_{folder}_" + stem.replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / folder / f"{stem}.py"
    if not path.exists():
        return None
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> Callable:
    """The reader of a metric: ``metrics/<name>.py``, else
    ``metrics/<name up to its first dot>.py`` (one reader for a quantity
    split by cell, such as ``device_idle_pct.offline``).  Its ``read(run)``
    returns the number, or None where it finds nothing to read."""
    for stem in (name, name.split(".")[0]):
        mod = _module("metrics", stem)
        if mod is not None:
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def loop(name: str):
    """A traffic mix's arrival process, the module ``loops/<name>.py``.
    Its ``run(mix, seed, seconds, send, first)`` sends the window's
    requests and returns (requests, window start, window end)."""
    mod = _module("loops", name)
    if mod is None:
        raise FileNotFoundError(f"no loop {name!r} in perfbench/loops")
    return mod


def system(cell: Cell):
    """The module that runs the cell's configuration:
    ``perfbench.systems.<system>``."""
    return importlib.import_module(
        f"perfbench.systems.{cell.config['system']}")


def reference(config: dict):
    """The configuration's plain reference:
    ``perfbench.reference.<reference>``."""
    return importlib.import_module(
        f"perfbench.reference.{config['reference']}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)

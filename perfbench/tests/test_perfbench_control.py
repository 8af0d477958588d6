"""The control and the planted faults, each of which has to make a run's
``correct`` come out false.  The runs go through the harness on the CPU
(its look for a card skipped) at 32x32 with a few images a request."""
import time

import pytest
import torch

from perfbench import harness
from perfbench.systems import cnn_serving

SEED = 2 ** 35 + 21
SMALL = {"offline-b64": {"sizes": [2], "variants": 2, "max_batch": 2},
         "online-1to8": {"sizes": [1, 2, 3], "variants": 2, "max_batch": 4,
                         "rate_per_s": 3, "senders": 4},
         "dp4-b256": {"sizes": [4], "variants": 2, "max_batch": 4}}


def small_run(cell_name, seconds=2.0, **kw):
    cell = harness.load(cell_name)
    cell.mix.update(SMALL[cell.entry["traffic"]])
    return cnn_serving.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                            device="cpu", in_hw=32, **kw)


def test_sound_run_and_control():
    """A sound run reads 0 against the reference; the control, the
    reference in bfloat16 in the program's place, reads above the limit."""
    res = small_run("mobilenetv2-heana4.offline-b64", control=True)
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] == 0.0
    assert res["control_gap"] > cnn_serving.LIMITS["logit_gap"]
    assert res["control_gap"] > 0.01


def _altered(eng):
    infer = eng.infer

    def wrong(x, seed=None, block=True):
        out = infer(x, seed, block).clone()
        out[-1, 0] += 1e-3 * out.abs().max()
        return out
    eng.infer = wrong


def _half_left_out(eng):
    infer = eng.infer

    def half(x, seed=None, block=True):
        n = x.shape[0]
        out = infer(x[:(n + 1) // 2], seed, block)
        return torch.cat([out, out[:n - out.shape[0]]])
    eng.infer = half


def _stale(eng):
    """A forward that hands back its last answer unchanged, as a graph
    replayed without its new input would."""
    infer, last = eng.infer, {}

    def stale(x, seed=None, block=True):
        n = x.shape[0]
        out = last.get(n)
        last[n] = infer(x, seed, block)
        return last[n] if out is None else out
    eng.infer = stale


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _stale])
@pytest.mark.parametrize("cell", ["resnet50-heana4.offline-b64",
                                  "resnet50-heana4.online-1to8"])
def test_fault_is_caught(cell, fault):
    res = small_run(cell, fault=fault)
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > 0


def test_exchange_left_out_is_caught(monkeypatch):
    """Data-parallel over two entries with each shard quantizing by its
    own |max|: the batch-wide exchange left out."""
    from repro_torch.exec import executor
    sound = small_run("resnet50-heana4.dp4-b256")
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(executor, "_pins", lambda cfg, xs: False)
    res = small_run("resnet50-heana4.dp4-b256")
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > 0

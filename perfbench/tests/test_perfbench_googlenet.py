"""GoogLeNet's configuration against the paper's table, its reference
against the engine on the CPU, and the reader of its concat time."""
import collections
import json

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import harness, loadgen, program, tracing
from perfbench.reference import cnn as reference
from perfbench.systems.cnn_serving import Run
from repro_torch.models import cnn
from repro_torch.models import lowering as lw

NAME = "googlenet-heana4"


def config():
    return json.loads((harness.HERE / "configs" / f"{NAME}.json")
                      .read_text())


def test_config_gemms_match_the_paper_table():
    """The node records at 224 give exactly the (M, K, D, count) multiset
    of ``cnn.googlenet()``: 58 GEMMs, 1,582,671,872 MACs an image, at the
    published widths and the paper's HEANA point."""
    c = config()
    gemms = program.gemms(c, 224)
    got = collections.Counter((g.c, g.k, g.d, g.count) for g in gemms)
    want = collections.Counter((g.c, g.k, g.d, g.count)
                               for g in cnn.googlenet())
    assert got == want and len(gemms) == 58
    assert sum(g.c * g.k * g.d * g.count for g in gemms) == 1_582_671_872
    assert c["reduced"] == [] and c["input"]["hw"] == 224
    assert c["classes"] == 1000 and c["assumed"]
    op = program.operating_point(c)
    assert (op.bits, op.n, op.adc_bits, op.noise_enabled) == (4, 83, 8,
                                                              False)


def test_graph_holds_the_inception_glue():
    """4 stride-2 max pools, 9 stride-1 'same' 3x3 max pools, the global
    mean and 9 four-way concats of [1x1, 3x3, 5x5, pool]."""
    g = program.graph(config())
    pools = collections.Counter(
        (n.pool, n.pool_size, n.pool_stride) if n.pool == "max" else n.pool
        for n in g.nodes if n.op == "pool")
    assert pools == {("max", 3, 2): 4, ("max", 3, 1): 9, "global": 1}
    cats = [n for n in g.nodes if n.op == "concat"]
    assert len(cats) == 9
    assert all([i.rsplit("_", 1)[1] for i in n.inputs] ==
               ["1x1", "3x3", "5x5", "pool"] for n in cats)
    shapes = lw.infer_shapes(g, 224)
    assert [shapes[n.name][:2] for n in g.nodes if n.op == "pool"
            and n.pool_stride == 2 and n.pool == "max"] == \
        [(56, 56), (28, 28), (14, 14), (7, 7)]
    assert shapes["inc5b_concat"] == (7, 7, 1024)


@pytest.mark.parametrize("hw,batch", [(32, 3), (64, 2)])
def test_reference_equals_engine(hw, batch):
    """The engine's plain route (device="cpu") and the reference give the
    same logits bit for bit, padding to a bucket included (batch 3 runs in
    bucket 4)."""
    c = config()
    gen = torch.Generator().manual_seed(2 ** 33 + hw)
    params = program.weights(c, hw, gen)
    x = program.images(c, hw, batch, gen)
    got = program.engine(c, params, hw, 4, "cpu").infer(x)
    want = reference.forward(c, params, x)
    assert got.shape == (batch, c["classes"])
    assert torch.equal(got, want)
    assert reference.logit_gap(got, want) == 0.0
    assert want.abs().max() > 0 and (want != 0).float().mean() > 0.5


class _Event:
    """A stand-in for the profiler's event record."""

    def __init__(self, name, kind, dev, start, dur):
        self._v = (name, kind, dev, start, dur)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def device_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4]

    def device_index(self):
        return 0


def _run(trace, sizes=(64, 64)):
    traced = [loadgen.Request(i, 0, n, 0.0, logits=torch.zeros(n, 1))
              for i, n in enumerate(sizes)]
    return Run(None, 0.0, [], 1.0, {}, [], (64,), trace, traced)


def test_concat_reader_sums_the_cat_kernels_over_the_images():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    cat = ("void at::native::(anonymous namespace)::CatArrayBatchedCopy"
           "_aligned16_contig<float, unsigned int, 4, 64, 64>")
    ev = [_Event(tracing.SPAN, "user_annotation", cpu, 0, 10 ** 6),
          _Event(cat, "kernel", gpu, 100, 3000),
          _Event(cat.replace("_aligned16_contig", ""), "kernel", gpu,
                 5000, 1000),
          _Event("void taom_gemm_int8_kernel<1>", "kernel", gpu, 7000,
                 50000),
          _Event("void at::native::vectorized_elementwise_kernel<4>",
                 "kernel", gpu, 60000, 9000)]
    read = harness.reader("concat_ms_per_image")
    got = read(_run(tracing.reduce(ev, [0])))
    assert got == pytest.approx(1e3 * 4000e-9 / 128)
    # nothing to read: no trace, no cat kernel, no image answered
    assert read(_run(None)) is None
    assert read(_run(tracing.reduce(ev[:1] + ev[3:], [0]))) is None
    assert read(_run(tracing.reduce(ev, [0]), sizes=())) is None

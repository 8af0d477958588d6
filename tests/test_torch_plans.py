"""Port conformance for the framework-free modules the port copies: the
scheduler's plans (cache keys included), executed-trace energy, the perf
model and the scalability solver must equal the reference's exactly —
same Python arithmetic on the same constants, so no tolerance."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import hw as jhw
from repro.core import perf_model as jpm
from repro.core import scalability as jscal
from repro.core.types import Dataflow as JDataflow
from repro.exec import PlanCache as JPlanCache
from repro.exec import plan_for_network as jplan_for_network
from repro.exec import schedule_buckets as jschedule_buckets
from repro.models import cnn as jcnn
from repro.models.zoo_cnn import ZOO as JZOO

from repro_torch.core import hw as thw
from repro_torch.core import perf_model as tpm
from repro_torch.core import photonic_gemm as tpg
from repro_torch.core import scalability as tscal
from repro_torch.core.types import Backend, Dataflow
from repro_torch.exec import PlanCache, plan_for_network, schedule_buckets
from repro_torch.models import cnn as tcnn
from repro_torch.models.lowering import params_from_jax
from repro_torch.models.zoo_cnn import ZOO


def _plain(obj):
    """A dataclass tree as plain Python values (enums by value), so the
    two packages' (distinct) classes compare field by field."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if hasattr(obj, "value") and hasattr(obj, "name"):       # enum
        return obj.value
    return obj


def _hardware():
    return [
        (jpm.AcceleratorConfig.equal_area("heana", JDataflow.OS, 1.0),
         tpm.AcceleratorConfig.equal_area("heana", Dataflow.OS, 1.0)),
        (jhw.OperatingPoint.design("amw", JDataflow.WS, bits=4,
                                   data_rate_gsps=5.0),
         thw.OperatingPoint.design("amw", Dataflow.WS, bits=4,
                                   data_rate_gsps=5.0)),
    ]


@pytest.mark.parametrize("name", list(ZOO))
@pytest.mark.parametrize("hw_index", [0, 1])
def test_plans_equal_reference(name, hw_index):
    jacc, tacc = _hardware()[hw_index]
    jmodel, model = JZOO[name], ZOO[name]
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    for batch in (1, 3):
        jplan = jplan_for_network(jparams, jacc, batch=batch,
                                  in_hw=model.in_hw, lowering=jmodel.graph,
                                  cache=JPlanCache())
        plan = plan_for_network(params, tacc, batch=batch,
                                in_hw=model.in_hw, lowering=model.graph,
                                cache=PlanCache())
        assert _plain(plan.layers) == _plain(jplan.layers)
        assert [p.cache_key for p in plan.layers] == \
            [p.cache_key for p in jplan.layers]
        assert _plain(plan.acc) == _plain(jplan.acc)
        assert _plain(plan.op) == _plain(jplan.op)
        assert _plain(plan.result) == _plain(jplan.result)
        assert (plan.cache_hits, plan.cache_misses) == \
            (jplan.cache_hits, jplan.cache_misses)
        assert _plain(thw.trace_energy(plan)) == \
            _plain(jhw.trace_energy(jplan))


def test_bucket_plans_equal_reference():
    jacc, tacc = _hardware()[0]
    jmodel, model = JZOO["resnet_mini"], ZOO["resnet_mini"]
    gemms = model.gemms()
    jgemms = jmodel.gemms()
    assert _plain(gemms) == _plain(jgemms)
    jplans = jschedule_buckets(jgemms, jacc, (1, 2, 4, 8),
                               cache=JPlanCache())
    plans = schedule_buckets(gemms, tacc, (1, 2, 4, 8), cache=PlanCache())
    assert list(plans) == list(jplans)
    for b in plans:
        assert _plain(plans[b].layers) == _plain(jplans[b].layers)
        assert _plain(thw.trace_energy(plans[b])) == \
            _plain(jhw.trace_energy(jplans[b]))


def test_analytic_models_equal_reference():
    for cnn in tcnn.CNN_ZOO:
        for be in ("heana", "amw", "maw"):
            for flow in ("os", "is", "ws"):
                jacc = jpm.AcceleratorConfig.equal_area(be, JDataflow(flow),
                                                        1.0)
                tacc = tpm.AcceleratorConfig.equal_area(be, Dataflow(flow),
                                                        1.0)
                want = jpm.cnn_inference(jcnn.CNN_ZOO[cnn](), jacc, batch=4)
                got = tpm.cnn_inference(tcnn.CNN_ZOO[cnn](), tacc, batch=4)
                assert _plain(got) == _plain(want)
    assert tscal.fig9_surface() == jscal.fig9_surface()
    for be in ("heana", "amw", "maw", "amw_bpca"):
        assert thw.OperatingPoint.design(be).describe() == \
            jhw.OperatingPoint.design(be).describe()


@pytest.mark.parametrize("backend", ["heana", "amw", "maw", "maw_bpca"])
@pytest.mark.parametrize("bits", [4, 6, 8])
def test_noise_sigma_and_design_point_equal_reference(backend, bits):
    from repro.core import photonic_gemm as jpg
    from repro.core.types import Backend as JBackend
    jcfg = jpg.design_point(JBackend(backend), bits, 1.0)
    cfg = tpg.design_point(Backend(backend), bits, 1.0)
    assert cfg.dpe_size == jcfg.dpe_size
    assert tpg.detection_sigma(cfg) == jpg.detection_sigma(jcfg)
    assert tpg.noise_shape((5, 7, 300), (300, 9), cfg) == \
        jpg.noise_shape((5, 7, 300), (300, 9), jcfg)

"""The port's shape grid, input specs and roofline terms
(repro_torch.configs, models.registry, roofline.terms) against the
reference's (repro.configs, repro.models.registry, repro.roofline.terms),
on the CPU: the grid and the N/A reasons equal, every spec's shape and
dtype equal, the parameter counts equal integers (the published configs
on fake tensors against ``jax.eval_shape``), the model FLOPs within rtol
1e-12, and a report's row with ``hw=V5E`` equal field by field."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as ref_configs
from repro.models import get_model as ref_get_model
from repro.models import registry as ref_registry
from repro.roofline import terms as ref_terms
from repro_torch import configs
from repro_torch.models import get_model, registry
from repro_torch.models.weights import _flatten
from repro_torch.roofline import H100, V5E, HwSpec, terms

ARCHS = configs.ARCH_IDS
KINDS = ("train", "prefill", "decode")


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _leaves(tree) -> dict:
    return {k: (tuple(v.shape), _dtype(v)) for k, v in _flatten(tree).items()}


def test_shape_grid_equals_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert configs.LONG_OK_FAMILIES == ref_configs.LONG_OK_FAMILIES
    assert configs.all_cells() == ref_configs.all_cells()
    assert len(configs.all_cells()) == 40
    for arch in ARCHS:
        for shape in configs.SHAPES:
            assert configs.shape_applies(configs.get_config(arch), shape) \
                == ref_configs.shape_applies(ref_configs.get_config(arch),
                                             shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    """Every spec helper on the smoke config: the same keys, shapes and
    dtypes (tokens int32); the cache's leaves by key."""
    cfg, rcfg = configs.get_smoke_config(arch), \
        ref_configs.get_smoke_config(arch)
    b, s = 3, 24
    pairs = [
        (registry.train_input_specs(cfg, b, s),
         ref_registry.train_input_specs(rcfg, b, s)),
        (registry.prefill_input_specs(cfg, b, s),
         ref_registry.prefill_input_specs(rcfg, b, s)),
        (registry.decode_input_specs(cfg, b),
         ref_registry.decode_input_specs(rcfg, b)),
        (registry.cache_specs(cfg, b, s),
         ref_registry.cache_specs(rcfg, b, s)),
    ]
    for got, want in pairs:
        assert _leaves(got) == _leaves(want)
    assert registry.train_input_specs(cfg, b, s)["labels"].dtype == \
        torch.int32


def test_input_specs_are_fake_under_fake_mode():
    cfg = configs.get_config("qwen2-vl-72b")
    with FakeTensorMode():
        spec = registry.train_input_specs(cfg, 256, 4096)
    assert all(type(t).__name__ == "FakeTensor" for t in spec.values())
    assert tuple(spec["embeds"].shape) == (256, 4096, cfg.d_model)


def _ref_params(rcfg):
    return jax.eval_shape(ref_get_model(rcfg).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference_smoke(arch):
    cfg, rcfg = configs.get_smoke_config(arch), \
        ref_configs.get_smoke_config(arch)
    params = get_model(cfg).init(0, device="cpu")
    ref = _ref_params(rcfg)
    n, want = terms.count_params(params), ref_terms.count_params(ref)
    assert n == terms.count_params(registry.param_specs(cfg))
    assert isinstance(n, int) and n == want
    active = terms.count_active_params(params, cfg)
    assert active == ref_terms.count_active_params(ref, rcfg)
    assert float(active).is_integer()


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen3-moe-30b-a3b"])
def test_param_counts_equal_reference_published(arch):
    """The published configs' parameters on fake tensors (no memory),
    against ``jax.eval_shape`` of the reference's init."""
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    with FakeTensorMode():
        params = registry.param_specs(cfg)
    ref = _ref_params(rcfg)
    assert terms.count_params(params) == ref_terms.count_params(ref)
    assert terms.count_active_params(params, cfg) == \
        ref_terms.count_active_params(ref, rcfg)
    if cfg.is_moe_arch:
        assert terms.count_active_params(params, cfg) < \
            terms.count_params(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_cell_equals_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        for n_active in (1.0, 3.3e9, 4.411424256e9):
            got = terms.model_flops_cell(cfg, shape, n_active)
            want = ref_terms.model_flops_cell(
                rcfg, ref_configs.SHAPES[name], n_active)
            assert math.isclose(got, want, rel_tol=1e-12), (name, got, want)
        for train in (False, True):
            assert terms.model_flops(cfg, 3.3e9, 4096, train) == \
                ref_terms.model_flops(rcfg, 3.3e9, 4096, train)


@pytest.mark.parametrize("counts", [
    dict(flops=6.31e13, byts=2.71e12, wire=0.0, peak_bytes=5.6e10),
    dict(flops=1.2e9, byts=8.8e9, wire=3.0e6, peak_bytes=1.0e9),
    dict(flops=7.0e14, byts=1.0e10, wire=4.0e11),
])
def test_report_row_equals_reference(counts):
    kw = dict(counts={"all-reduce": 2}, arch="qwen3-4b", shape="train_4k",
              mesh_name="1xH100", chips=1, model_flops=4.6e13, **counts)
    got = terms.analyze_raw(hw=V5E, **kw).row()
    want = ref_terms.analyze_raw(**kw).row()
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == v, k


def test_report_on_the_h100():
    rep = terms.analyze_raw(flops=9.89e14, byts=3.35e12, wire=0.0,
                            counts={}, arch="a", shape="s", mesh_name="m",
                            chips=1, model_flops=4.945e14)
    assert rep.hw == H100 and rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(1.0)
    assert rep.mfu == pytest.approx(0.5)
    assert rep.useful_flops_ratio == pytest.approx(0.5)
    assert H100.hbm_bytes == 80e9 and HwSpec() == V5E


def test_raw_counts_of_counts():
    from repro_torch.roofline import count
    counts, out = count(lambda: torch.ones(4, 8) @ torch.ones(8, 2))
    assert tuple(out.shape) == (4, 2)
    raw = terms.raw_counts(counts)
    assert raw == {"flops": 2 * 4 * 8 * 2, "bytes": counts.bytes,
                   "wire_bytes": 0.0, "counts": {}}
    assert terms.peak_memory(counts) == counts.peak_bytes > 0

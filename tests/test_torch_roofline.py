"""The port's collective-schedule advisor (repro_torch.roofline) against
the reference's (repro.roofline): the rendered flow lists and the
analytic times exactly, the DES times of ``advise_allreduce`` within rtol
1e-6 with the same ranking and sources, on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.roofline import V5E as REF_V5E
from repro.roofline import advise_allreduce as ref_advise
from repro.roofline import analytic_time as ref_analytic
from repro.roofline import advisor as ref_advisor
from repro_torch.roofline import V5E, HwSpec, advise_allreduce, analytic_time
from repro_torch.roofline import advisor

MESHES = [(2, 2), (4, 4)]
BYTES = [1e6, 100e6]


def _flows(fl):
    return [(f.src, f.dst, f.gbits, f.round) for f in fl]


def test_hw_constants_equal_reference():
    assert dataclasses.asdict(V5E) == dataclasses.asdict(REF_V5E)
    assert HwSpec() == V5E


@pytest.mark.parametrize("mesh", [(2, 2), (4, 4), (2, 4), (8, 8)])
def test_flow_lists_equal_reference(mesh):
    nx, ny = mesh
    n, gbits = nx * ny, 0.8
    ring = [x * ny + (y if x % 2 == 0 else ny - 1 - y)
            for x in range(nx) for y in range(ny)]
    for bidir in (False, True):
        assert _flows(advisor.ring_allreduce_flows(
            n, gbits, ring=ring, bidirectional=bidir)) == \
            _flows(ref_advisor.ring_allreduce_flows(
                n, gbits, ring=ring, bidirectional=bidir))
    assert _flows(advisor.torus_2d_allreduce_flows(nx, ny, gbits)) == \
        _flows(ref_advisor.torus_2d_allreduce_flows(nx, ny, gbits))


@pytest.mark.parametrize("schedule", ["ring", "ring-bidir", "torus2d"])
def test_analytic_time_equal_reference(schedule):
    for mesh in [(2, 2), (4, 4), (8, 8), (16, 16)]:
        n = mesh[0] * mesh[1]
        for b in BYTES + [3.5e9]:
            assert analytic_time(schedule, n, b, V5E, mesh) == \
                ref_analytic(schedule, n, b, REF_V5E, mesh)
    with pytest.raises(ValueError):
        analytic_time("tree", 4, 1e6)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("nbytes", BYTES)
def test_advise_allreduce_equal_reference(mesh, nbytes):
    """The DES ranking of the three schedules: order and source equal,
    times within rtol 1e-6, and within 1 % of the analytic ring formulas
    (benchmarks/advisor_validation.py's limit)."""
    want = ref_advise(nbytes, mesh)
    got = advise_allreduce(nbytes, mesh, device="cpu")
    assert [(a.schedule, a.source) for a in got] == \
        [(a.schedule, a.source) for a in want]
    assert all(a.source == "des" for a in got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.predicted_s, b.predicted_s, rtol=1e-6)
        an = analytic_time(a.schedule, mesh[0] * mesh[1], nbytes, V5E, mesh)
        assert abs(a.predicted_s - an) <= 0.01 * an, a.schedule


def test_advise_allreduce_analytic_branch():
    """Past ``des_max_chips`` the ranking comes from the formulas."""
    for mesh, cap in (((4, 4), 8), ((8, 8), 16)):
        got = advise_allreduce(100e6, mesh, des_max_chips=cap, device="cpu")
        want = ref_advise(100e6, mesh, des_max_chips=cap)
        assert [(a.schedule, a.predicted_s, a.source) for a in got] == \
            [(a.schedule, a.predicted_s, a.source) for a in want]
        assert {a.source for a in got} == {"analytic"}


def test_advisor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        advise_allreduce(1e6, (2, 2))

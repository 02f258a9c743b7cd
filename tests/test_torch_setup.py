"""The port's setup layer against the reference: every SimSetup array, every
RouteTable field, the EngineConsts tensors and the legacy flow hash."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import make_consts as ref_make_consts
from repro.core.flows import Flow as RefFlow
from repro.core.flows import flows_setup as ref_flows_setup
from repro.core.routing import flow_hash_u32 as ref_hash
from repro.core.topology import torus_2d as ref_torus_2d
from repro.core.usecase import paper_setup as ref_paper_setup
from repro.scenarios import get_scenario as ref_get_scenario
from repro_torch.core.engine import make_consts
from repro_torch.core.flows import Flow, flows_setup
from repro_torch.core.routing import flow_hash_u32
from repro_torch.core.topology import torus_2d
from repro_torch.core.usecase import paper_setup
from repro_torch.scenarios import get_scenario

SLICE_SCENARIOS = ("paper-fabric", "leaf-spine", "fat-tree",
                   "canonical-tree", "leaf-spine-xl")
_CACHE = {}


def _setups(kind):
    """(reference SimSetup, port SimSetup) for one named case (cached: the
    xl route-table DFS takes seconds)."""
    if kind not in _CACHE:
        if kind.startswith("paper-seed"):
            seed = int(kind[-1])
            pair = (ref_paper_setup(seed), paper_setup(seed, device="cpu"))
        elif kind == "flows-torus":
            fl = [(0, 1, 8.0, 0), (1, 0, 2.0, 0), (0, 1, 4.0, 1)]
            pair = (ref_flows_setup(ref_torus_2d(2, 1),
                                    [RefFlow(*f) for f in fl]),
                    flows_setup(torus_2d(2, 1), [Flow(*f) for f in fl],
                                device="cpu"))
        else:
            pair = (ref_get_scenario(kind).build(),
                    get_scenario(kind).build("cpu"))
        _CACHE[kind] = pair
    return _CACHE[kind]


CASES = ["paper-seed0", "paper-seed1", "paper-seed2", "flows-torus",
         *SLICE_SCENARIOS]


def _assert_equal_arrays(a, b, label):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{label}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{label}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=label)


@pytest.mark.parametrize("kind", CASES)
def test_setup_arrays_equal(kind):
    ref, port = _setups(kind)
    for f in dataclasses.fields(ref):
        rv, pv = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(rv, np.ndarray):
            _assert_equal_arrays(pv, rv, f"SimSetup.{f.name}")
    assert [dataclasses.asdict(j) for j in port.jobs] == \
        [dataclasses.asdict(j) for j in ref.jobs]
    for name in ("vm_host", "vm_total_mips", "vm_core_mips",
                 "host_total_mips"):
        _assert_equal_arrays(getattr(port.cluster, name),
                             getattr(ref.cluster, name), f"cluster.{name}")
    assert port.cluster.storage_node == ref.cluster.storage_node
    assert port.cluster.intra_bw == ref.cluster.intra_bw
    for name in ("link_src", "link_dst", "link_bw"):
        _assert_equal_arrays(getattr(port.cluster.topo, name),
                             getattr(ref.cluster.topo, name), f"topo.{name}")


@pytest.mark.parametrize("kind", CASES)
def test_route_table_equal(kind):
    ref, port = _setups(kind)
    rr, pr = ref.route_table, port.route_table
    for f in dataclasses.fields(rr):
        rv, pv = getattr(rr, f.name), getattr(pr, f.name)
        if isinstance(rv, np.ndarray):
            _assert_equal_arrays(pv, rv, f"RouteTable.{f.name}")
        else:
            assert pv == rv, f"RouteTable.{f.name}"


@pytest.mark.parametrize("kind", CASES)
def test_engine_consts_equal(kind):
    ref, port = _setups(kind)
    rc, rmeta = ref_make_consts(ref)
    pc, pmeta = make_consts(port, device="cpu")
    assert pc._fields == rc._fields
    for name, pv, rv in zip(pc._fields, pc, rc):
        _assert_equal_arrays(pv.numpy(), np.asarray(rv), f"consts.{name}")
    for f in dataclasses.fields(pmeta):
        pv, rv = getattr(pmeta, f.name), getattr(rmeta, f.name)
        if dataclasses.is_dataclass(rv):        # EnergyParams
            pv, rv = dataclasses.asdict(pv), dataclasses.asdict(rv)
        assert pv == rv, f.name


def test_flow_hash_equal():
    rng = np.random.RandomState(0)
    n = 20000
    cols = [rng.randint(-1, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
            for _ in range(3)]
    cols[0][:4] = [0, -1, 2**31 - 1, 1 << 20]
    want = np.asarray(ref_hash(*(jnp.asarray(c) for c in cols)))
    got = flow_hash_u32(*(torch.from_numpy(c) for c in cols)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_live_schedules_are_refused():
    from repro_torch.core.ctrlplane import CtrlPlaneConfig
    from repro_torch.core.failures import no_failures
    _, port = _setups("paper-seed0")
    topo = port.cluster.topo
    sched = no_failures(topo.n_hosts, topo.n_links)
    sched.host_fail_t[0] = 5.0
    for kw, item in ((dict(ctrl=CtrlPlaneConfig(install_latency=0.1)),
                      "item 6"),
                     (dict(spec_slots=1), "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            make_consts(dataclasses.replace(port, **kw), device="cpu")
    # a live failure schedule is accepted (queue 1 item 5 is ported)
    _, meta = make_consts(dataclasses.replace(port, failures=sched),
                          device="cpu")
    assert meta.has_failures
    # the inert schedules are accepted
    make_consts(dataclasses.replace(
        port, failures=no_failures(topo.n_hosts, topo.n_links)), device="cpu")

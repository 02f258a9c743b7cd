"""The port's event loop against the reference's vmapped policy batch: the
whole final SimState on {paper-fabric, leaf-spine, fat-tree,
canonical-tree} × {SDN, legacy} × {Eq. 3, water-fill} × {least-used,
round-robin, random} × policy seeds 0–2, run as 36 lanes of one port run
per scenario (``Results.states`` ``[1, 36, ...]``, as the reference's).

Integer and bool leaves and ``steps`` must be equal; float leaves within
rtol 1e-6 (NaN == NaN).  The port rounds its multiply-adds once, as the
reference's compiled code does (``repro_torch.core.fp``), so on the CPU
the float leaves in fact come out equal bit for bit."""
import itertools

import numpy as np
import pytest

from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro_torch.api import Experiment, PolicyConfig

GRID = [dict(routing=r, traffic=t, placement=p, seed=s)
        for r, t, p, s in itertools.product((1, 0), (0, 1), (0, 1, 2),
                                            range(3))]
RTOL = 1e-6


def assert_states_match(port_states, ref_states, label=""):
    """Leaf by leaf: same dtype and shape, ints/bools equal, floats within
    RTOL.  ``port_states`` leaves are torch tensors, ``ref_states`` numpy
    or jax arrays of the same layout."""
    for name, p, r in zip(port_states._fields, port_states, ref_states):
        p, r = p.cpu().numpy(), np.asarray(r)
        assert p.dtype == r.dtype, f"{label}: {name} dtype {p.dtype} != " \
                                   f"{r.dtype}"
        assert p.shape == r.shape, f"{label}: {name} shape {p.shape} != " \
                                   f"{r.shape}"
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(p, r, rtol=RTOL, atol=0,
                                       equal_nan=True,
                                       err_msg=f"{label}: {name}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("scenario", ["paper-fabric", "leaf-spine",
                                      "fat-tree", "canonical-tree"])
def test_grid_equals_reference_policy_batch(scenario):
    ref = RefExperiment(scenario, [RefPolicyConfig(**g) for g in GRID]).run()
    port = Experiment(scenario, [PolicyConfig(**g) for g in GRID],
                      device="cpu").run()
    ref_states = type(ref.states)(*(np.asarray(leaf) for leaf in ref.states))
    assert not np.any(np.asarray(ref_states.stalled))
    assert_states_match(port.states, ref_states, scenario)


def test_lanes_equal_single_runs():
    """Each lane of a mixed-policy run equals that policy run alone
    (W = 1), bit for bit on one device."""
    pols = [PolicyConfig(**GRID[i]) for i in (0, 4, 10, 23, 35)]
    batch = Experiment("leaf-spine", pols, device="cpu").run()
    for w, pol in enumerate(pols):
        single = Experiment("leaf-spine", pol, device="cpu").run().state()
        for name, a, b in zip(single._fields, single, batch.state(0, w)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=f"lane {w}: {name}")

"""The port's channel model (repro_torch.core.fairshare) against the
reference on random route / active / bandwidth instances (hypothesis, as in
tests/test_fairshare.py) and on the iteration-cap cases of
tests/test_fairshare_clamp.py.  On the CPU both add in the same order, so
the rates are equal bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import fairshare as ref
from repro_torch.core import fairshare as port

INTRA = 1e12


@st.composite
def instances(draw):
    n_links = draw(st.integers(2, 8))
    n_flows = draw(st.integers(1, 10))
    max_hops = draw(st.integers(1, 4))
    bw = np.array([draw(st.floats(0.5, 10.0)) for _ in range(n_links)],
                  np.float32)
    routes = np.full((n_flows, max_hops), -1, np.int32)
    for f in range(n_flows):
        hops = draw(st.integers(0, min(max_hops, n_links)))
        links = draw(st.lists(st.integers(0, n_links - 1), min_size=hops,
                              max_size=hops, unique=True))
        routes[f, :hops] = links
    active = np.array([draw(st.booleans()) for _ in range(n_flows)])
    return bw, routes, active


def _both(fn_ref, fn_port, bw, routes, active, **kw):
    want = np.asarray(fn_ref(jnp.asarray(routes), jnp.asarray(active),
                             jnp.asarray(bw), INTRA, **kw))
    got = fn_port(torch.from_numpy(routes), torch.from_numpy(active),
                  torch.from_numpy(bw), INTRA, **kw).numpy()
    return got, want


@given(instances())
@settings(max_examples=30, deadline=None)
def test_channel_counts_equal(inst):
    bw, routes, active = inst
    want = np.asarray(ref.channel_counts(jnp.asarray(routes),
                                         jnp.asarray(active), bw.shape[0]))
    got = port.channel_counts(torch.from_numpy(routes),
                              torch.from_numpy(active), bw.shape[0])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@given(instances())
@settings(max_examples=30, deadline=None)
def test_eq3_rates_equal(inst):
    got, want = _both(ref.eq3_rates, port.eq3_rates, *inst)
    np.testing.assert_array_equal(got, want)


@given(instances(), st.sampled_from([None, 0, 1, 2, 3]))
@settings(max_examples=25, deadline=None)
def test_waterfill_rates_equal(inst, n_iter):
    got, want = _both(ref.waterfill_rates, port.waterfill_rates, *inst,
                      n_iter=n_iter)
    np.testing.assert_array_equal(got, want)


@given(st.lists(instances(), min_size=2, max_size=2),
       st.sampled_from([0, 1]), st.sampled_from([0, 1]))
@settings(max_examples=12, deadline=None)
def test_rates_dispatch_per_lane(pair, pol0, pol1):
    """Two lanes with their own traffic policy equal the reference's rates
    of each lane run alone (the lanes share the link capacities)."""
    bw = pair[0][0]
    n_flows = min(p[1].shape[0] for p in pair)
    hops = max(p[1].shape[1] for p in pair)
    routes = np.full((2, n_flows, hops), -1, np.int32)
    active = np.zeros((2, n_flows), bool)
    for w, (_, r, a) in enumerate(pair):
        r = np.where(r < bw.shape[0], r, -1)[:n_flows]
        routes[w, :, :r.shape[1]] = r
        active[w] = a[:n_flows]
    pols = np.asarray([pol0, pol1], np.int32)
    got = port.rates(pols, torch.from_numpy(routes),
                     torch.from_numpy(active), torch.from_numpy(bw),
                     INTRA).numpy()
    for w in range(2):
        # a host-static policy resolves the reference's dispatch eagerly
        want = np.asarray(ref.rates(int(pols[w]), jnp.asarray(routes[w]),
                                    jnp.asarray(active[w]),
                                    jnp.asarray(bw), INTRA))
        np.testing.assert_array_equal(got[w], want)


# the three-bottleneck instance of tests/test_fairshare_clamp.py
CLAMP_BW = np.asarray([0.2, 2.0, 0.9], np.float32)
CLAMP_ROUTES = np.asarray([[1, -1], [0, 1], [0, -1], [1, 2], [2, -1],
                           [2, -1]], np.int32)
CLAMP_ACTIVE = np.ones(6, bool)


@pytest.mark.parametrize("n_iter", [None, 0, 1, 2, 3, 4])
def test_waterfill_iteration_cap_equal(n_iter):
    got, want = _both(ref.waterfill_rates, port.waterfill_rates, CLAMP_BW,
                      CLAMP_ROUTES, CLAMP_ACTIVE, n_iter=n_iter)
    np.testing.assert_array_equal(got, want)
    load = np.zeros(3)
    for f, route in enumerate(CLAMP_ROUTES):
        for li in route[route >= 0]:
            load[li] += got[f]
    assert np.all(load <= CLAMP_BW * (1 + 1e-4))


def test_zero_iterations_degenerates_to_eq3():
    wf, _ = _both(ref.waterfill_rates, port.waterfill_rates, CLAMP_BW,
                  CLAMP_ROUTES, CLAMP_ACTIVE, n_iter=0)
    r3, _ = _both(ref.eq3_rates, port.eq3_rates, CLAMP_BW, CLAMP_ROUTES,
                  CLAMP_ACTIVE)
    assert np.allclose(wf, r3)

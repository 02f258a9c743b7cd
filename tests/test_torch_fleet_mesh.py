"""The port's fleet spread over ranks and its sharded restore, on 2
spawned gloo ranks (``torch_mesh_ranks.fleet_ckpt``).

* The counterpart of tests/test_fleet.py's ``test_fleet_sharded_matches_
  serial``: paper-fabric × its ``POLICIES`` × ``SEEDS`` through
  ``run_fleet(width=8, chunk_steps=16, devices=2)``, bitwise against the
  port's ``run()`` and against the reference's ``run()`` on every rank
  (the comparisons of tests/test_torch_fleet.py, bitwise on the CPU),
  ``stats.devices == 2``; each cohort's 3 members round up to 4 lanes,
  and width 1 rounds up to 2 lanes that refill, the pad lanes inert;
  ``devices`` above the world is capped, and below it the ranks past it
  hold no lanes and return the same grid.
* In the same spawn, ``restore(shardings=)`` onto a (1, 2) ("data",
  "model") mesh of a checkpoint the port wrote and of one the reference
  wrote: each local shard is its slice of the saved leaf and
  ``full_tensor()`` the whole leaf, bitwise; saved again from the mesh,
  each checkpoint holds the same arrays.  A tree of plain tensors saved
  under the group is written by each rank that saves it, to its own
  directory.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.api import Experiment as RefExperiment
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_smoke_config as ref_smoke
from repro.models import get_model as ref_get_model
from repro.train import optim as ref_optim
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.weights import leaf_map
from repro_torch.train import AdamWConfig
from repro_torch.train import init as opt_init
from torch_mesh_ranks import plain_tree, spawn

POLICIES = [
    {"routing": 0, "placement": 0},
    {"routing": 0, "placement": 2},
    {"routing": 1, "placement": 0},
    {"routing": 1, "placement": 1},
]
SEEDS = (0, 1, 2)
# tag -> (width, devices)
RUNS = {"d2": (8, 2), "round": (1, 2), "cap": (8, 3), "d1": (8, 1)}
FIELDS = ("sims", "cohorts", "chunks", "refills", "devices", "width")


def _checkpoints(d):
    """A port checkpoint and a reference checkpoint of qwen3-4b's smoke
    model and AdamW state at step 1, the moments random."""
    rng = np.random.default_rng(0)
    model = get_model(get_smoke_config("qwen3-4b")).init(3, device="cpu")
    ostate = opt_init(AdamWConfig(), model)
    for m in (*ostate.mu.values(), *ostate.nu.values()):
        m.copy_(m.new_tensor(rng.standard_normal(m.shape)))
    ostate = ostate._replace(step=ostate.step + 1)
    ckpt.save(os.path.join(d, "port"), 1, (model, ostate))

    api = ref_get_model(ref_smoke("qwen3-4b"))
    params = api.init(jax.random.PRNGKey(7))
    ost = ref_optim.init(ref_optim.AdamWConfig(), params)
    rand = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), ost.mu)
    ost = ost._replace(step=ost.step + 1, mu=rand, nu=rand)
    ref_ckpt.save(os.path.join(d, "ref"), 1, (params, ost))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fleet_ckpt"))
    with open(os.path.join(d, "fleet.json"), "w") as f:
        json.dump({"policies": POLICIES, "seeds": SEEDS, "runs": RUNS}, f)
    _checkpoints(d)
    return d


@pytest.fixture(scope="module")
def ranks(workdir):
    return spawn("fleet_ckpt", 2, workdir)


def test_fleet_over_two_ranks_equals_serial_and_reference(ranks):
    ref = RefExperiment(scenarios="paper-fabric", policies=POLICIES,
                        seeds=SEEDS).run()
    fields = ref.states._fields
    for r, res in enumerate(ranks):
        for name, want in zip(fields, ref.states):
            want = np.asarray(want)
            serial = res[f"serial/{name}"]
            assert serial.dtype == want.dtype and \
                np.array_equal(serial, want, equal_nan=True), (r, name)
            for tag in RUNS:
                got = res[f"{tag}/{name}"]
                assert got.dtype == serial.dtype and \
                    np.array_equal(got, serial, equal_nan=True), \
                    (r, tag, name)


def test_fleet_stats_rounding_cap_and_idle_ranks(ranks):
    """Every rank takes the same decisions; ``devices`` is the ranks that
    held lanes; 3-member cohorts round up to 4 lanes over 2 ranks, width
    1 to 2 (and refills); 3 devices cap at the world of 2."""
    stats = [{tag: dict(zip(FIELDS, map(int, r[f"{tag}/stats"])))
              for tag in RUNS} for r in ranks]
    assert stats[0] == stats[1]
    s = stats[0]
    assert s["d2"]["devices"] == 2 and s["d2"]["width"] == 4
    assert s["round"]["width"] == 2 and s["round"]["refills"] > 0
    assert s["cap"]["devices"] == 2 and s["cap"]["width"] == 4
    assert s["d1"]["devices"] == 1 and s["d1"]["width"] == 3
    for v in s.values():
        assert v["sims"] == len(POLICIES) * len(SEEDS)
        assert v["cohorts"] == len(POLICIES)


def test_sharded_restore_of_port_and_reference_checkpoints(ranks):
    """Every parameter of qwen3-4b's smoke model and every ``mu`` leaf,
    checked on both ranks (the checks run in the ranks)."""
    model = get_model(get_smoke_config("qwen3-4b")).init(0, device="cpu")
    n = len(list(model.parameters())) + len(leaf_map(model, model.cfg))
    for r in ranks:
        for tag in ("port", "ref"):
            assert int(r[f"ckpt_{tag}_checked"]) == n


def test_checkpoints_saved_from_the_mesh_hold_the_same_arrays(ranks,
                                                              workdir):
    for tag in ("port", "ref"):
        arrays = []
        for d in (tag, f"{tag}_from_mesh"):
            with np.load(os.path.join(workdir, d, "step_00000001",
                                      "arrays.npz")) as z:
                arrays.append(dict(z))
        assert sorted(arrays[0]) == sorted(arrays[1])
        for key, want in arrays[0].items():
            got = arrays[1][key]
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (tag, key)


def test_plain_tensors_saved_under_a_group_by_every_rank(ranks, workdir):
    """No DTensor in the tree: every rank, rank 1 too, writes its own
    checkpoint and returns its path; each restores bitwise."""
    for r, res in enumerate(ranks):
        d = os.path.join(workdir, "plain", f"rank{r}")
        assert str(res["plain_path"]) == os.path.join(d, "step_00000002")
        assert bool(res["plain_equal"]), r
        with np.load(os.path.join(d, "step_00000002", "arrays.npz")) as z:
            for key, want in plain_tree(r).items():
                assert np.array_equal(z[key], want.numpy()), (r, key)

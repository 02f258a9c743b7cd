"""The port's synthetic token pipeline and its MapReduce twin
(repro_torch.data) against the reference's (repro.data): the batches bit
for bit, the rendered jobs field by field, and the ingest job through
both engines on one fabric with equal final states."""
import dataclasses

import numpy as np
import pytest

from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro.core.mapreduce import build_setup as ref_build_setup
from repro.data import TokenPipeline as RefPipeline
from repro.data import pipeline_jobs as ref_pipeline_jobs
from repro.scenarios import get_scenario as ref_get_scenario
from repro.scenarios.registry import make_cluster as ref_make_cluster
from repro_torch.api import Experiment, PolicyConfig
from repro_torch.core.mapreduce import build_setup
from repro_torch.data import TokenPipeline, pipeline_jobs
from repro_torch.scenarios import get_scenario
from repro_torch.scenarios.registry import make_cluster
from test_torch_engine import assert_states_match

JOBS = [dict(n_shards=16, shard_gbits=2.0, n_reducers=4),
        dict(n_shards=8, shard_gbits=0.5, n_reducers=3, read_mi=2e3,
             assemble_mi=5e2, shuffle_fraction=0.25, submit_time=1.5)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_batches_equal_reference(seed, hosts):
    n_hosts, host_id = hosts
    kw = dict(vocab=151936, batch=4, seq=33, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    got, want = TokenPipeline(**kw), RefPipeline(**kw)
    for step in (0, 1, 5, 123456789):
        a, b = got.batch_at(step), want.batch_at(step)
        assert a.keys() == b.keys() == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b, _ in zip(got, want, range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert got.step == want.step >= 2


def test_hosts_partition_the_global_batch():
    """Two hosts of half the batch read the rows one host of the whole
    batch reads, at every step: the restart and re-shard contract."""
    one = TokenPipeline(vocab=1000, batch=8, seq=16)
    two = [TokenPipeline(vocab=1000, batch=4, seq=16, n_hosts=2, host_id=h)
           for h in range(2)]
    for step in (0, 3):
        np.testing.assert_array_equal(
            one.batch_at(step)["tokens"],
            np.concatenate([p.batch_at(step)["tokens"] for p in two]))


@pytest.mark.parametrize("kw", JOBS)
def test_pipeline_jobs_equal_reference(kw):
    got, want = pipeline_jobs(**kw), ref_pipeline_jobs(**kw)
    assert len(got) == len(want) == 1
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])


@pytest.mark.parametrize("kw", JOBS)
def test_ingest_job_through_both_engines(kw):
    """The rendered job on leaf-spine's fabric under SDN and legacy
    routing: the setups' tasks and packets and the final states equal."""
    topo, ref_topo = (get_scenario("leaf-spine").topology(),
                      ref_get_scenario("leaf-spine").topology())
    setup = build_setup(pipeline_jobs(**kw), make_cluster(topo), k_max=8,
                        device="cpu")
    ref_setup = ref_build_setup(ref_pipeline_jobs(**kw),
                                ref_make_cluster(ref_topo), k_max=8)
    assert setup.task_job.shape == ref_setup.task_job.shape
    assert setup.pkt_job.shape == ref_setup.pkt_job.shape
    got = Experiment(setup, [PolicyConfig(routing=r) for r in (1, 0)],
                     device="cpu").run()
    want = RefExperiment(ref_setup,
                         [RefPolicyConfig(routing=r) for r in (1, 0)]).run()
    assert not bool(got.states.stalled.any())
    assert_states_match(got.states, want.states, "ingest")

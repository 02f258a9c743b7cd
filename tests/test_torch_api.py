"""The port's front door (repro_torch.api) against the reference's, the
axes it refuses, and the import isolation of the port and chip_smoke.py."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.api import Experiment as RefExperiment
from repro.api import PolicyConfig as RefPolicyConfig
from repro_torch.api import Experiment, PolicyConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-6


def _pair(pol_cls, routing):
    return (("sdn", "legacy")[1 - routing],
            pol_cls(routing=routing, job_concurrency=2))


@pytest.fixture(scope="module")
def both():
    ref = RefExperiment("paper-fabric",
                        [_pair(RefPolicyConfig, r) for r in (1, 0)],
                        seeds=range(2)).run()
    port = Experiment("paper-fabric", [_pair(PolicyConfig, r) for r in (1, 0)],
                      seeds=range(2), device="cpu").run()
    return ref, port


def test_rows_equal_reference(both):
    ref, port = both
    assert port.scenario_names == ref.scenario_names
    assert port.policy_names == ref.policy_names
    rrows, prows = ref.rows(), port.rows()
    assert len(prows) == len(rrows) == 4
    for r, p in zip(rrows, prows):
        assert p.keys() == r.keys()
        for k, v in r.items():
            if isinstance(v, float):
                # energy_kwh sums per-device energies in another order
                np.testing.assert_allclose(p[k], v, rtol=RTOL, err_msg=k)
            else:
                assert p[k] == v, k


def test_job_report_equal_reference(both):
    ref, port = both
    rj, pj = ref.job_report(), port.job_report()
    assert pj.keys() == rj.keys()
    for k in rj:
        assert pj[k].shape == rj[k].shape, k
        np.testing.assert_allclose(pj[k], rj[k], rtol=RTOL, atol=0,
                                   equal_nan=True, err_msg=k)
    re, pe = ref.energy_report(), port.energy_report()
    for k in re:
        np.testing.assert_allclose(pe[k], np.asarray(re[k]), rtol=RTOL,
                                   err_msg=k)
    s = port.summary(0, 1)
    assert int(s["steps"]) == int(np.asarray(ref.summary(0, 1)["steps"]))


def test_unported_axes_raise():
    """Every axis of the front door runs now: several scenarios, the
    failure, degradation and ctrl crosses, the failure, ctrl, chaos and
    streaming registry entries, ``run_fleet`` and ``run_stream``, the last
    three equal to the reference's."""
    from repro.scenarios import get_scenario as ref_get_scenario
    from repro.scenarios.registry import stream_arrivals as ref_arrivals
    from repro_torch.core import CtrlPlaneConfig
    from repro_torch.core.failures import no_failures
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.failures import degradation_injector
    from repro_torch.scenarios.registry import stream_arrivals
    two = Experiment(["paper-fabric", "leaf-spine"], device="cpu")
    assert two.scenario_names == ["paper-fabric", "leaf-spine-4x4"]
    topo = two.scenarios[0][1].cluster.topo
    crossed = Experiment(
        "paper-fabric", device="cpu",
        failures=no_failures(topo.n_hosts, topo.n_links),
        degradation=[("d0", degradation_injector(host_rate=1e-3, seed=0)),
                     ("d1", degradation_injector(host_rate=1e-3, seed=1))],
        ctrl=CtrlPlaneConfig(install_latency=0.05))
    assert crossed.scenario_names == ["paper-fabric/d0", "paper-fabric/d1"]
    for _, setup in crossed.scenarios:
        assert setup.failures is not None
        assert setup.degradation.any_degradation and setup.ctrl.any_ctrl
    _, meta = crossed.build()
    assert meta.has_ctrl and meta.has_degradation
    for name in ("paper-fabric-failures", "paper-fabric-ctrl",
                 "leaf-spine-ctrl", "paper-fabric-chaos",
                 "leaf-spine-chaos"):
        Experiment(name, device="cpu")
    assert get_scenario("leaf-spine-stream").name \
        == ref_get_scenario("leaf-spine-stream").name
    pols = [_pair(PolicyConfig, r) for r in (1, 0)]
    ref_pols = [_pair(RefPolicyConfig, r) for r in (1, 0)]
    exp = Experiment("canonical-tree", pols, device="cpu")
    ref = RefExperiment("canonical-tree", ref_pols)
    fleet, rfleet = exp.run_fleet(width=1), ref.run_fleet(width=1)
    for name, a, b in zip(fleet.states._fields, fleet.states, rfleet.states):
        assert np.array_equal(a.numpy(), np.asarray(b), equal_nan=True), name
    st = exp.run_stream(stream_arrivals(rate=0.05, seed=1), 200.0, slots=3)
    rst = ref.run_stream(ref_arrivals(rate=0.05, seed=1), 200.0, slots=3)
    assert st.stats.refills > 0
    assert vars(st.stats) == vars(rst.stats)
    for pi in range(2):
        for k, v in rst.jobs[pi].items():
            assert np.array_equal(st.jobs[pi][k], v), k


def test_fleet_no_rebuild_on_identical_meta():
    """A second ``run_fleet`` of an equal ``SimMeta`` and width reuses the
    cached chunk, init and refill programs: ``runners.cache_size()`` does
    not grow, and the results are equal."""
    from repro_torch.api import runners
    runners.cache_clear()
    pols = [PolicyConfig(seed=i) for i in range(3)]
    r1 = Experiment("canonical-tree", pols, device="cpu").run_fleet(
        width=2, chunk_steps=8)
    n = runners.cache_size()
    assert n >= 3
    r2 = Experiment("canonical-tree", pols, device="cpu").run_fleet(
        width=2, chunk_steps=8)
    assert runners.cache_size() == n
    for name, a, b in zip(r1.states._fields, r1.states, r2.states):
        assert np.array_equal(a.numpy(), b.numpy(), equal_nan=True), name


def test_stream_no_rebuild_on_identical_meta():
    """A second ``run_stream`` of the same arrival trace through an
    equal-meta ring reuses the cached chunk, init and refill programs."""
    from repro_torch.api import runners
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.arrivals import PoissonArrivals
    runners.cache_clear()
    setup = get_scenario("leaf-spine", n_jobs=2).build("cpu")
    arrivals = PoissonArrivals(rate=0.05, seed=0)

    def one_run():
        exp = Experiment(("leaf-spine", setup),
                         PolicyConfig(job_concurrency=2), device="cpu")
        return exp.run_stream(arrivals, horizon=120.0, slots=4,
                              chunk_steps=64)

    r1 = one_run()
    n = runners.cache_size()
    assert n >= 3
    r2 = one_run()
    assert runners.cache_size() == n
    for k in r1.jobs[0]:
        assert np.array_equal(r1.jobs[0][k], r2.jobs[0][k]), k


def test_port_imports_no_jax_and_no_repro():
    """Import every repro_torch module in a fresh interpreter: neither jax,
    ml_dtypes nor any repro module may load."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ml_dtypes.'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.engine" in report["modules"]
    assert "repro_torch.kernels.tropical_apsp.kernel" in report["modules"]
    assert "repro_torch.kernels.flash_attention.kernel" in report["modules"]
    assert "repro_torch.launch.serve" in report["modules"]
    assert report["bad"] == []


def _imported_roots(path: pathlib.Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_and_port_sources_import_no_jax():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    for f in files:
        roots = _imported_roots(f)
        assert not roots & {"jax", "jaxlib", "ml_dtypes", "repro"}, f


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory with chip_smoke.py and nothing else of the repo (or
    without a CUDA device) the script exits non-zero and prints no
    result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

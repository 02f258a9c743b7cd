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
    """Only ``run_fleet`` (queue 1 item 8), ``run_stream`` and the
    streaming registry entry (item 9) still raise; every other axis
    builds: several scenarios, the failure, degradation and ctrl crosses,
    and the failure, ctrl and chaos registry entries."""
    from repro_torch.core import CtrlPlaneConfig
    from repro_torch.core.failures import no_failures
    from repro_torch.scenarios import get_scenario
    from repro_torch.scenarios.failures import degradation_injector
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
    with pytest.raises(NotImplementedError, match="item 9"):
        get_scenario("leaf-spine-stream")
    exp = Experiment("canonical-tree", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        exp.run_fleet()
    with pytest.raises(NotImplementedError, match="item 9"):
        exp.run_stream(None, 1.0)


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

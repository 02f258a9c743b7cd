"""Nothing the benchmark loads is JAX or the JAX package, the reference
imports nothing of the port, and the command refuses to run without a
card or without the port."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from bench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_run_loads_no_jax_and_no_reference_package():
    """A tiny run on the CPU through the harness, in a fresh process:
    afterwards no loaded module has a forbidden top-level name (whole
    names: ``repro_torch`` is not ``repro``)."""
    code = (
        "import sys, time; sys.path[:0] = [{root!r}, {src!r}, {tests!r}]\n"
        "import torch; torch.set_num_threads(1)\n"
        "import bench_tiny\n"
        "from bench import harness\n"
        "line = bench_tiny.run_tiny(0.2)\n"
        "assert line['correct'], line\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n"
        "print('bench.ref.sim' in sys.modules)\n"
        "print(harness.forbidden_modules())\n").format(
            root=ROOT, src=os.path.join(ROOT, "src"),
            tests=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, ref, bad = out.stdout.strip().splitlines()[-3:]
    assert bad == "[]"
    assert "repro_torch" in loaded and ref == "True"


def test_forbidden_names_compare_whole():
    """``repro_torch`` and ``jaxlib_x`` are not ``repro`` or ``jaxlib``;
    a submodule of ``flax`` is ``flax``."""
    from bench import harness
    planted = ("reprox", "jaxlib_x", "flax.core")
    for name in planted:
        sys.modules[name] = type(sys)(name)
    try:
        bad = harness.forbidden_modules()
        assert "flax" in bad
        assert not {"reprox", "jaxlib_x", "repro_torch"} & set(bad)
    finally:
        for name in planted:
            del sys.modules[name]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_port():
    """The reference imports only numpy and the standard library (and its
    own modules, relatively)."""
    ref = os.path.join(ROOT, "bench", "ref")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(dirpath, f)))
                assert names <= {"numpy", "__future__", "collections",
                                 "dataclasses", "typing"}, (f, names)


def test_bench_sources_import_no_jax():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "bench")):
        for f in files:
            if f.endswith(".py"):
                names = set(_imports(os.path.join(dirpath, f)))
                assert not names & FORBIDDEN, (f, names)


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "paper-usecase.sweep",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _command(ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and not out.stdout.strip()


def test_command_refuses_with_only_its_own_files(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and ``bench/``,
    the port is missing: no result, a non-zero exit."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(str(tmp_path))
    assert out.returncode != 0 and not out.stdout.strip()

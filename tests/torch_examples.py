"""Helpers for the tests of the port's entry scripts
(``examples/torch_*.py``): load one as a module, and read the top-level
packages its source imports.  Imports neither jax nor ``repro``."""
import ast
import importlib.util
import pathlib

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def path(name: str) -> pathlib.Path:
    return EXAMPLES / f"{name}.py"


def load(name: str):
    """``examples/<name>.py`` as a module (its ``__main__`` block not run)."""
    spec = importlib.util.spec_from_file_location(name, path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def imported_roots(name: str) -> set:
    """The first component of every module ``examples/<name>.py`` imports,
    anywhere in its source."""
    roots = set()
    for node in ast.walk(ast.parse(path(name).read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{name}: relative import"
            roots.add(node.module.split(".")[0])
    return roots

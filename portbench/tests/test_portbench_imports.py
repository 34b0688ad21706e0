"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
nothing under portbench/reference/ imports the port."""

import ast
import os

from harness import cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "optax", "spatialalignmentnetwork_tpu"}
PORT = "spatialalignmentnetwork_tpu_torch"


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def modules():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: top_level_imports(p) & JAX for p in modules()}
    assert not {p: n for p, n in found.items() if n}
    assert len(found) > 20  # the walk saw the harness, the readers, the reference


def test_the_reference_imports_nothing_of_the_port():
    ref = [p for p in modules() if os.sep + "reference" + os.sep in p]
    assert ref
    for p in ref:
        assert PORT not in top_level_imports(p), p
        with open(p) as f:
            assert "import spatialalignmentnetwork" not in f.read(), p


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    before = set(cell.forbidden_modules())
    monkeypatch.setitem(sys.modules, "spatialalignmentnetwork_tpu_torch", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "spatialalignmentnetwork_tpu_x.y", types.ModuleType("y"))
    assert set(cell.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert set(cell.forbidden_modules()) == before | {"jax"}

"""The reference and the generators import nothing of the program, the
JAX package or JAX: by their import statements, and in a fresh process
that loads them."""

import ast
import importlib
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.tiny import REPO

BAD = {"jax", "jaxlib", "flax", "dbgtpu", "dbgtpu_torch"}


@pytest.mark.parametrize("folder", ["reference", "gen"])
def test_sources_import_nothing_forbidden(folder):
    for src in (REPO / "benchmark" / folder).glob("*.py"):
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & BAD, (src, names)


def test_loading_them_loads_nothing_forbidden():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.check, benchmark.gen.synth\n"
            "bad = {'jax', 'jaxlib', 'flax', 'dbgtpu', 'dbgtpu_torch'}\n"
            "print(sorted(n for n in sys.modules "
            "if n.split('.')[0] in bad))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_check_sees_a_forbidden_import(tmp_path, monkeypatch):
    from benchmark.tests.tiny import copy_tree

    root = copy_tree(tmp_path / "tree")
    assert harness.reference_imports(root) == []
    (root / "benchmark" / "reference" / "leak.py").write_text(
        "import dbgtpu_torch.spec\n")
    assert harness.reference_imports(root) == [
        "reference/leak.py: dbgtpu_torch.spec"]


def test_stub_reference_of_a_configuration_is_scanned(tmp_path):
    """A reference package that a configuration names is scanned: its
    import statements, and once loaded the objects its modules hold."""
    from benchmark.tests.tiny import add_cell, add_reference, copy_tree

    root = copy_tree(tmp_path / "tree")
    add_reference(root, "reference_leak", ("greedy",),
                  check="from dbgtpu_torch.spec import RunStats as S")
    assert harness.reference_imports(root) == []     # named by none yet
    add_cell(root, "tiny.leak", "load", reference="reference_leak")
    assert harness.reference_imports(root) == [
        "reference_leak/check.py: dbgtpu_torch.spec"]
    ref = harness.reference_of({"reference": "reference_leak"}, root)
    importlib.import_module(ref.__name__ + ".check")
    found = harness.reference_imports(root)
    assert found[0] == "reference_leak/check.py: dbgtpu_torch.spec"
    assert found[1:] == [f"{ref.__name__}.check.S: dbgtpu_torch.spec"]


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dbgtpu_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dbgtpu.sub", sys)
    assert harness.forbidden_modules() == ["dbgtpu.sub"]

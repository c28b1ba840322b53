"""No module of the benchmark imports JAX or the JAX package, whose
top-level name, ``tpulbm``, the program's ``tpulbm_torch`` begins with;
the plain reference and the comparison import nothing of the program."""

import ast
import sys

import pytest

from lbmbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "tpulbm"}
SOURCES = sorted(spec.HERE.rglob("*.py"))


def imported(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "compare.py"])
def test_reference_imports_nothing_of_the_program(name):
    assert "tpulbm_torch" not in imported(spec.HERE / "lbmbench" / name)
    assert imported(spec.HERE / "lbmbench" / name) <= {"__future__", "numpy",
                                                       "torch"}


def test_run_names_what_it_finds_by_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(spec.HERE))
    run = spec.load_module(spec.HERE / "run.py")
    monkeypatch.setitem(sys.modules, "tpulbm_torch_like", object())
    assert run.loaded_forbidden() == [] or all(
        n.split(".")[0] in FORBIDDEN for n in run.loaded_forbidden())
    monkeypatch.setitem(sys.modules, "tpulbm.sim", object())
    assert "tpulbm.sim" in run.loaded_forbidden()
    assert "tpulbm_torch_like" not in run.loaded_forbidden()

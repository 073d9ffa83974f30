"""What the benchmark imports: never JAX nor the JAX package, and the
yardsticks nothing of the program."""
import ast
import pathlib
import sys
import types

import pytest

PB = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}
YARDSTICKS = ("reference.py", "work.py", "datagen.py")


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.relative_to(PB).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PB).as_posix())
def test_no_jax_and_no_jax_package(path):
    found = set(_top_level_imports(path)) & BANNED
    assert not found, (path, found)


@pytest.mark.parametrize("name", YARDSTICKS)
def test_yardsticks_import_nothing_of_the_program(name):
    mods = set(_top_level_imports(PB / name))
    assert not mods & {"repro_torch", "repro", "jax"}, mods
    assert mods <= {"__future__", "contextlib", "numpy", "torch"}, mods


def test_the_run_refuses_jax_by_whole_top_level_names(monkeypatch):
    from portbench.run import banned_modules

    base = set(banned_modules())
    for name in ("repro_torch_fake", "jaxlike.sub", "reprox"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(banned_modules()) == base
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("repro.fake"))
    monkeypatch.setitem(sys.modules, "jax.fake", types.ModuleType("jax.fake"))
    assert {"repro", "jax"} <= set(banned_modules())

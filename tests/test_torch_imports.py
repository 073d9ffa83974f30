"""The port stands alone: no module of src/repro_torch, not chip_smoke.py
and not the port's examples (examples/torch_*.py) imports jax or the JAX
package ``repro`` (``repro_torch`` is the port's own).  Every import
statement is found by walking the syntax tree, so imports inside
functions count too."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree: ast.AST):
    """Every top-level package name an import statement in ``tree`` names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


def test_the_walk_sees_every_import_form():
    tree = ast.parse("import jax.numpy as jnp\nfrom repro.core import engine\n"
                     "def f():\n    import repro\n    from repro_torch.core import index\n"
                     "from . import sibling\n")
    assert list(_imported(tree)) == ["jax", "repro", "repro", "repro_torch"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_neither_jax_nor_repro(path):
    names = set(_imported(ast.parse(path.read_text(), filename=str(path))))
    assert not names & set(FORBIDDEN), f"{path.relative_to(ROOT)} imports {names & set(FORBIDDEN)}"


def test_the_guard_covers_the_port():
    assert len(FILES) > 30
    port = ROOT / "src" / "repro_torch"
    for rel in ("core/engine.py", "core/lsh.py", "obs/__init__.py", "obs/registry.py",
                "obs/trace.py", "obs/recorder.py", "core/ring.py", "launch/join_job.py",
                "launch/mesh.py", "launch/sharding.py", "configs/paper_knn.py",
                "configs/base.py", "models/layers.py", "models/attention.py", "models/rwkv6.py",
                "models/transformer.py", "models/model.py", "models/convert.py",
                "models/moe.py", "models/rglru.py", "models/encdec.py",
                "launch/steps.py", "launch/serve.py", "launch/train.py", "data/pipeline.py",
                "optim/adamw.py", "optim/schedule.py", "optim/compress.py",
                "launch/placement.py", "launch/compressed_train.py", "launch/shapes.py",
                "launch/op_analysis.py", "launch/dryrun.py"):
        assert port / rel in FILES, rel
    for rel in ("torch_quickstart.py", "torch_peptide_search.py", "torch_knnlm_serve.py"):
        assert ROOT / "examples" / rel in FILES, rel

"""The port and chip_smoke.py import neither JAX nor the JAX package, nor
the libraries that read orbax checkpoints: the card's machine has none.
Read from the source (an AST walk), since a test process may already have
JAX loaded."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the orbax reader (train/ocdbt.py, train/orbax_ckpt.py) is written from the
# format: none of the libraries that read it either
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "ntm_tracker_tpu", "tensorstore", "zarr", "numcodecs", "zstandard"}
SOURCES = sorted((ROOT / "ntm_tracker_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_found():
    assert len(SOURCES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_no_jax(path):
    assert not imported_roots(path) & FORBIDDEN


def test_walk_catches_nested_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from ntm_tracker_tpu.config import NTMConfig\n    import jax.numpy\n")
    assert imported_roots(probe) & FORBIDDEN == {"jax", "ntm_tracker_tpu"}

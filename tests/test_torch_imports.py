"""The port's import rule, checked on the source: nothing under
src/repro_torch/ and not chip_smoke.py imports JAX or the JAX package, and
chip_smoke.py needs nothing beyond the standard library, torch, numpy and
the port (the machine with the card has no JAX)."""
import ast
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"


def _imported(path: pathlib.Path):
    """Top-level package names of every import in the file, anywhere in it."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_has_modules():
    assert len(PORT_FILES) >= 15 and SMOKE.exists()


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_no_reference_package(path):
    bad = _imported(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path} imports {bad}"


def test_smoke_imports_only_torch_numpy_and_the_port():
    extra = _imported(SMOKE) - set(sys.stdlib_module_names) - {
        "__future__", "torch", "numpy", "repro_torch"}
    assert not extra, f"chip_smoke.py imports {extra}"


def test_triton_and_kernels_load_lazily():
    """No module imports triton, and the kernel libraries are built and
    loaded only inside the functions that launch them (the CPU tests import
    every module)."""
    for path in PORT_FILES:
        assert "triton" not in _imported(path), path
        tree = ast.parse(path.read_text())
        top = [n for n in tree.body if isinstance(n, (ast.Expr, ast.Assign))]
        for node in top:
            src = ast.unparse(node)
            assert "build.library(" not in src and "build_all(" not in src, (path, src)

"""The port's import rule, checked on the source: nothing under
src/repro_torch/ (its data, training, checkpoint and launch packages
included), not chip_smoke.py, not the port's examples
(examples/torch_*.py: the quickstart, multi_arch, train_100m) and not the
port's scripts (scripts/torch_*.py) imports JAX, the JAX package or
``ml_dtypes``, and chip_smoke.py and the examples need nothing beyond the
standard library, torch, numpy and the port (the machine with the card has
no JAX and no ``ml_dtypes``)."""
import ast
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"
QUICKSTART = ROOT / "examples" / "torch_quickstart.py"
# the port's examples, which run on the card too
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
# the port's scripts (scripts/torch_*.py), which run on the card too
SCRIPTS = sorted((ROOT / "scripts").glob("torch_*.py"))


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
    assert len(PORT_FILES) >= 15 and SMOKE.exists() and QUICKSTART.exists()
    assert {p.name for p in EXAMPLES} >= {"torch_quickstart.py", "torch_multi_arch.py",
                                          "torch_train_100m.py"}
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES}
    assert {"data/synthetic.py", "data/sharegpt.py", "training/pretrain.py",
            "checkpoint/ckpt.py", "launch/train.py", "serving/config.py", "serving/http.py",
            "launch/serve.py", "launch/api_server.py", "launch/load_gen.py",
            "launch/mesh.py", "launch/distributed.py", "launch/sharding.py", "launch/hints.py",
            "launch/dryrun.py", "launch/dryrun_all.py", "launch/step_analysis.py",
            "roofline.py", "models/loops.py"} <= names
    assert "torch_serve_drift.py" in {p.name for p in EXAMPLES}


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE] + EXAMPLES + SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_no_reference_package(path):
    bad = _imported(path) & {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}
    assert not bad, f"{path} imports {bad}"


def _beyond_torch_numpy_and_the_port(path: pathlib.Path) -> set:
    return _imported(path) - set(sys.stdlib_module_names) - {
        "__future__", "torch", "numpy", "repro_torch"}


def test_smoke_imports_only_torch_numpy_and_the_port():
    extra = _beyond_torch_numpy_and_the_port(SMOKE)
    assert not extra, f"chip_smoke.py imports {extra}"


def test_quickstart_imports_only_torch_numpy_and_the_port():
    extra = _beyond_torch_numpy_and_the_port(QUICKSTART)
    assert not extra, f"torch_quickstart.py imports {extra}"


@pytest.mark.parametrize("path", [p for p in EXAMPLES if p != QUICKSTART], ids=lambda p: p.name)
def test_examples_import_only_torch_numpy_and_the_port(path):
    extra = _beyond_torch_numpy_and_the_port(path)
    assert not extra, f"{path.name} imports {extra}"


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

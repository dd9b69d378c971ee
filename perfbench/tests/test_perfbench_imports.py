"""The import guard: the run's check on loaded modules, and the reference's imports read from its source."""

import ast
import sys
import types

import pytest

from perfbench import harness
from perfbench.tests.helpers import ROOT

NOT_IN_REFERENCE = {"jax", "jaxlib", "flax", "mojo_opset_tpu", "mojo_opset_tpu_torch"}
NOT_READ = ("bench.py", "BASELINE", "BENCH_", "MULTICHIP_", "docs/benchmark", "mojo_opset_tpu/")


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_jax_nor_the_program(path):
    assert not _imported(path) & NOT_IN_REFERENCE


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_benchmark_file_imports_jax_or_reads_the_jax_packages_measurements(path):
    assert not _imported(path) & {"jax", "jaxlib", "flax", "mojo_opset_tpu"}
    if path.parent.name != "tests":
        text = path.read_text()
        assert not [name for name in NOT_READ if name in text]


@pytest.mark.parametrize("loaded, flagged", [
    ("mojo_opset_tpu_torch.runtime", []), ("jax.numpy", ["jax"]), ("mojo_opset_tpu.core", ["mojo_opset_tpu"]),
    ("flax", ["flax"]), ("jaxlib_helper", []), ("jax_like", []),
])
def test_loaded_modules_are_compared_by_whole_top_level_name(monkeypatch, loaded, flagged):
    for name in [n for n in sys.modules if n.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    assert harness.forbidden_modules() == flagged

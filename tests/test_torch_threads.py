"""One torch intra-op thread per test process, for the port's test files.

Each port test file imports `one_intra_op_thread` (an autouse, module-scoped
fixture) into its namespace. Under `pytest -n 6` six workers share the
machine's cores; with torch's intra-op pool at one thread per core in every
worker, OpenMP's barriers wait on descheduled threads and a float64
EfficientNet forward and backward that takes seconds alone takes many
minutes. One thread a worker keeps the run bound by its work. The count the
process had is restored when the module ends, so a file behaves the same
under xdist and alone.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_the_module_runs_on_one_intra_op_thread():
    assert torch.get_num_threads() == 1
    x = torch.arange(64.0).reshape(8, 8)
    assert torch.equal(x @ torch.eye(8), x)


def _defines_tests(tree: ast.Module) -> bool:
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test"):
            return True
        if isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            return True
    return False


def _imports_the_fixture(tree: ast.Module) -> bool:
    return any(isinstance(node, ast.ImportFrom) and node.module == "tests.test_torch_threads"
               and any(alias.name == "one_intra_op_thread" for alias in node.names)
               for node in tree.body)


def test_every_port_test_file_takes_the_fixture():
    """A port test file that defines tests imports `one_intra_op_thread`, so
    no new file runs at torch's default thread count under xdist."""
    here = Path(__file__)
    missing = []
    for path in sorted(here.parent.glob("test_torch_*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        if path != here and _defines_tests(tree) and not _imports_the_fixture(tree):
            missing.append(path.name)
    assert not missing, f"import one_intra_op_thread from tests.test_torch_threads in {missing}"

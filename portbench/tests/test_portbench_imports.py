"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `ggnn_tpu_torch` is not `ggnn_tpu`), and the plain
reference imports nothing of the port."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "ggnn_tpu"}


def _sources(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


SOURCES = sorted(_sources(HERE))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, HERE) for p in SOURCES])
def test_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(HERE, "reference")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top != "ggnn_tpu_torch" and top not in FORBIDDEN, path
            assert name != "portbench.program", path


def test_only_program_imports_the_port():
    """Outside the tests, program.py alone touches the system under
    test."""
    users = {os.path.relpath(p, HERE) for p in SOURCES
             if not os.path.relpath(p, HERE).startswith("tests")
             and any(n.split(".")[0] == "ggnn_tpu_torch"
                     for n in _imports(p))}
    assert users == {"program.py"}

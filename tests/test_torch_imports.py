"""The port stands alone: no module of ggnn_tpu_torch, and neither
chip_smoke.py nor tools/torch_serving_profile.py, imports jax, jaxlib,
the JAX package ggnn_tpu or the JAX benchmarks."""

import ast
import os

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ggnn_tpu", "benchmarks")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "torch_serving_profile.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ggnn_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_scan_sees_the_whole_port():
    files = _port_files()
    assert "chip_smoke.py" in files
    assert os.path.join("tools", "torch_serving_profile.py") in files
    assert os.path.join("ggnn_tpu_torch", "serving.py") in files
    for path in (("ops", "kernels", "ell_spmm.py"),
                 ("ops", "kernels", "gather_floor.py"),
                 ("probes", "gather_floor.py"), ("utils", "timing.py")):
        assert os.path.join("ggnn_tpu_torch", *path) in files


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"

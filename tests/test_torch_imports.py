"""The port stands alone: no module of ggnn_tpu_torch, and none of
chip_smoke.py and the port's tools (tools/torch_*.py), imports jax,
jaxlib, the JAX package ggnn_tpu or the JAX benchmarks, nor the libraries
of the JAX package's Orbax checkpoints (orbax, tensorstore, zstandard),
whose format the port reads and writes itself."""

import ast
import os

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ggnn_tpu", "benchmarks", "orbax",
             "tensorstore", "zstandard")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "torch_serving_profile.py"),
             os.path.join(ROOT, "tools", "torch_op_host_cost.py"),
             os.path.join(ROOT, "tools", "torch_kernel_compare.py"),
             os.path.join(ROOT, "tools", "torch_mesh_nccl.py"),
             os.path.join(ROOT, "tools", "torch_ragged_compare.py")]
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
                 ("probes", "gather_floor.py"), ("utils", "timing.py"),
                 ("server.py",), ("export.py",), ("compat", "tf1.py"),
                 ("training", "summaries.py"), ("data", "smiles.py"),
                 ("data", "qm9.py"), ("data", "native_pack.py"),
                 ("native", "__init__.py"), ("__init__.py",),
                 ("parallel", "__init__.py"), ("parallel", "mesh.py"),
                 ("parallel", "node_shard.py"), ("parallel", "step.py"),
                 ("parallel", "tp.py"), ("parallel", "stacking.py"),
                 ("parallel", "collectives.py"), ("parallel", "launch.py"),
                 ("data", "reorder.py"), ("native", "codec.py"),
                 ("training", "orbax_dir.py")):
        assert os.path.join("ggnn_tpu_torch", *path) in files


def test_parallel_loads_no_jax():
    """Importing the mesh package, and what a rank of the mesh tests
    imports, loads no module of JAX or of the JAX package."""
    import subprocess
    import sys
    code = ("import sys; import ggnn_tpu_torch.parallel as p; "
            "p.make_parallel_steps; import ggnn_tpu_torch.parallel.launch; "
            "import torch_mesh_ranks; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_orbax_directories_load_no_oracle(tmp_path):
    """Writing and reading an Orbax directory checkpoint loads no module
    of JAX, orbax, tensorstore or zstandard."""
    import subprocess
    import sys
    code = (
        "import sys, numpy as np; "
        "from ggnn_tpu_torch.training import orbax_dir; "
        f"p = {str(tmp_path / 'c')!r}; "
        "orbax_dir.write_arrays(p, {'w': np.arange(6, dtype=np.float32)}); "
        "assert (orbax_dir.read_arrays(p)['w'] == np.arange(6)).all(); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files())
def test_port_file_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"

"""The port's data ingestion and package surface against the JAX package,
on the CPU: the SMILES parser, QM9 extraction from a tarball built here
(no network), the synthetic generators, the loader's helper, and the
top-level and subpackage names. Everything compares exactly: these are
numpy and stdlib code with the same arithmetic as JAX's."""

import ast
import io
import json
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest

import ggnn_tpu
from ggnn_tpu.data import loader as jax_loader
from ggnn_tpu.data import qm9 as jax_qm9
from ggnn_tpu.data import smiles as jax_smiles
from ggnn_tpu.data import synthetic as jax_synthetic
import ggnn_tpu_torch
from ggnn_tpu_torch.data import loader, qm9, smiles, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle_strings():
    """Every whitespace-free string literal of tests/test_smiles.py: its
    SMILES, its error cases and a few words that are not SMILES."""
    with open(os.path.join(ROOT, "tests", "test_smiles.py")) as f:
        tree = ast.parse(f.read())
    found = {node.value for node in ast.walk(tree)
             if isinstance(node, ast.Constant) and isinstance(node.value, str)
             and node.value and not any(c.isspace() for c in node.value)}
    return sorted(found)


def _parse(module, text):
    """("ok", graph) or ("error", exception class name) of a parse."""
    try:
        return "ok", module.smiles_to_graph(text)
    except Exception as err:
        return "error", type(err).__name__


@pytest.mark.parametrize("text", _oracle_strings())
def test_smiles_matches_jax_on_the_oracle(text):
    got, want = _parse(smiles, text), _parse(jax_smiles, text)
    assert got == want
    if got[0] == "ok":
        assert smiles.parse_smiles(text) == jax_smiles.parse_smiles(text)
        assert qm9.smiles_to_graph(text, backend="builtin") == \
            jax_qm9.smiles_to_graph(text, backend="builtin")


@pytest.mark.parametrize("text", ["C1CC", "C(C", "CX", "C=1CCCCC#1",
                                  "1CC1", "C[Si](C)C"])
def test_smiles_errors_raise_the_ports_smiles_error(text):
    with pytest.raises(smiles.SmilesError):
        smiles.smiles_to_graph(text)
    assert issubclass(smiles.SmilesError, ValueError)


# ------------------------------------------------------------------- QM9

QM9_SMILES = ["C", "N", "O", "F", "CCO", "CC(=O)O", "c1ccccc1", "c1ccncc1",
              "c1cc[nH]c1", "c1ccoc1", "CC#N", "O=C=O", "C1CC1", "FC(F)F",
              "CC(C)C", "C/C=C/C", "N#Cc1ccccc1", "OCC1OC1", "Cn1cccc1",
              "C1=CC=CN1", "C1=CN=CN1", "O=C1C=CC=CN1", "C=C1C=CC=C1",
              "c1ccc2ccccc2c1"]


def write_qm9_tarball(path, smiles_list, mol_ids, seed):
    """A `.tar.bz2` in the QM9 layout: one `dsgdb9nsd_<id>.xyz` a
    molecule (atom count, tab-separated properties with mu in column 4,
    one line an atom, frequencies, the SMILES line, InChI), random mu."""
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w:bz2") as tar:
        for mol_id, text in zip(mol_ids, smiles_list):
            props = ["gdb", str(mol_id), "2", "3",
                     f"{rng.uniform(0.0, 6.0):.4f}", "5", "6"]
            lines = ["3", "\t".join(props)]
            lines += [f"C\t0.0\t0.0\t{i}.0\t0.0" for i in range(3)]
            lines += ["100.0\t200.0", f"{text}\t{text}", "InChI=1S/test"]
            data = ("\n".join(lines) + "\n").encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{mol_id:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def qm9_tarball(tmp_path_factory):
    """24 molecules, 6 of them in the split file's validation ids."""
    valid = sorted(int(i) for i in qm9.load_valid_idx())[:6]
    train = [i for i in range(1, 40) if i not in set(valid)][:18]
    ids = sorted(train + valid)
    path = str(tmp_path_factory.mktemp("qm9") / "dsgdb9nsd.xyz.tar.bz2")
    write_qm9_tarball(path, QM9_SMILES, ids, seed=0)
    return path


def test_qm9_extraction_writes_jax_bytes(qm9_tarball, tmp_path):
    outs = {}
    for name, module in (("jax", jax_qm9), ("port", qm9)):
        raw = module.download_qm9(str(tmp_path / name / "data"),
                                  tarball=qm9_tarball)
        module.preprocess(raw, out_dir=str(tmp_path / name))
        outs[name] = {split: (tmp_path / name /
                              f"molecules_{split}.json").read_bytes()
                      for split in ("train", "valid")}
    assert outs["port"] == outs["jax"]
    valid = json.loads(outs["port"]["valid"])
    train = json.loads(outs["port"]["train"])
    assert (len(train), len(valid)) == (18, 6)
    mus = [g["targets"][0][0] for g in train]
    assert abs(np.mean(mus)) < 1e-9 and abs(np.std(mus) - 1.0) < 1e-9


def test_qm9_entry_point_from_a_tarball(qm9_tarball, tmp_path, capsys):
    """Extract with the module's entry point, then evaluate a model on
    the emitted files through the CLI's --data_dir."""
    from ggnn_tpu_torch import cli
    subprocess.run(
        [sys.executable, "-m", "ggnn_tpu_torch.data.qm9", "--tarball",
         qm9_tarball, "--data-dir", str(tmp_path / "data"), "--out-dir",
         str(tmp_path / "out")], cwd=ROOT, check=True, timeout=120)
    with open(tmp_path / "out" / "molecules_valid.json") as f:
        assert len(json.load(f)) == 6
    assert cli.main(["sparse", "--data_dir", str(tmp_path / "out"),
                     "--device", "cpu", "--quiet", "--evaluate",
                     "--log_dir", str(tmp_path / "log"), "--config",
                     json.dumps({"hidden_size": 8})]) == 0
    out = capsys.readouterr().out.splitlines()
    # The 6 validation targets, then one [1, 6] array of predictions.
    assert len([line for line in out if line.startswith("[[")]) == 7


def test_qm9_split_asset_and_missing_tarball(tmp_path):
    with open(qm9.VALID_IDX_PATH, "rb") as f, \
            open(jax_qm9.VALID_IDX_PATH, "rb") as g:
        assert f.read() == g.read()
    assert len(qm9.load_valid_idx()) == 13082
    with pytest.raises(FileNotFoundError):
        qm9.download_qm9(str(tmp_path), tarball=str(tmp_path / "none.bz2"))


# ------------------------------------------------------ helpers and names

@pytest.mark.parametrize("kwargs", [
    {"num_nodes": 50}, {"num_nodes": 300, "seed": 4},
    {"num_nodes": 120, "seed": 2, "extra_edge_frac": 1.5}])
def test_synthetic_giant_graph_matches_jax(kwargs):
    assert synthetic.synthetic_giant_graph(**kwargs) == \
        jax_synthetic.synthetic_giant_graph(**kwargs)


@pytest.mark.parametrize("kwargs", [
    {"num_graphs": 10}, {"num_graphs": 7, "seed": 3, "num_targets": 3},
    {"num_graphs": 5, "seed": 1, "n_lo": 12, "n_hi": 20}])
def test_async_fixture_molecules_match_jax(kwargs):
    assert synthetic.async_fixture_molecules(**kwargs) == \
        jax_synthetic.async_fixture_molecules(**kwargs)


def test_graph_string_to_array_matches_jax():
    text = "0 1 1\n1 2 2\n2 3 0"
    assert loader.graph_string_to_array(text) == \
        jax_loader.graph_string_to_array(text) == \
        [[0, 1, 1], [1, 2, 2], [2, 3, 0]]


def test_top_level_names():
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.serving import Predictor
    from ggnn_tpu_torch.training.config import resolve_config
    from ggnn_tpu_torch.training.runner import Runner
    assert ggnn_tpu_torch.__version__ == ggnn_tpu.__version__
    assert ggnn_tpu_torch.SMALL_NUMBER == ggnn_tpu.SMALL_NUMBER
    np.testing.assert_array_equal(ggnn_tpu_torch.CHEMICAL_ACCURACIES,
                                  ggnn_tpu.CHEMICAL_ACCURACIES)
    assert ggnn_tpu_torch.GraphBatch.__module__ == "ggnn_tpu_torch.graph"
    assert ggnn_tpu_torch.DenseGraphBatch.__module__ == "ggnn_tpu_torch.graph"
    assert ggnn_tpu_torch.Runner is Runner
    assert ggnn_tpu_torch.Predictor is Predictor
    assert ggnn_tpu_torch.resolve_config is resolve_config
    assert ggnn_tpu_torch.synthetic_molecules is synthetic_molecules
    # Multi-GPU training is ported (ROADMAP A11): make_mesh is the mesh
    # package's.
    from ggnn_tpu_torch.parallel.mesh import make_mesh
    assert ggnn_tpu_torch.make_mesh is make_mesh
    with pytest.raises(AttributeError):
        ggnn_tpu_torch.no_such_name


# The JAX package's re-exports under the port's names (the subpackages'
# docstrings list the mapping).
RENAMED = {"gru_init": "GRUCell", "gru_apply": "GRUCell",
           "cudnn_gru_init": "CudnnCompatibleGRUCell",
           "cudnn_gru_apply": "CudnnCompatibleGRUCell",
           "rnn_init": "RNNCell", "rnn_apply": "RNNCell",
           "tf_adam": "TFAdam", "make_optimizer": "TFAdam",
           "clip_by_norm_per_leaf": "clip_by_norm"}


@pytest.mark.parametrize("package", ["data", "models", "ops", "training"])
def test_subpackages_reexport_the_jax_names(package):
    import importlib
    jax_pkg = importlib.import_module(f"ggnn_tpu.{package}")
    port_pkg = importlib.import_module(f"ggnn_tpu_torch.{package}")
    public = [n for n in vars(jax_pkg) if not n.startswith("_")
              and not isinstance(getattr(jax_pkg, n), type(os))]
    for name in public:
        port_name = RENAMED.get(name, name)
        assert hasattr(port_pkg, port_name), f"{package}.{port_name}"
        assert port_name in (port_pkg.__doc__ or "") or port_name == name
    if package == "ops":
        # The module keeps its name; its function is the JAX re-export.
        from ggnn_tpu_torch.ops.dropout import dropout
        assert port_pkg.dropout.dropout is dropout
        assert "`dropout` is the module" in port_pkg.__doc__


def test_import_stays_light():
    """`import ggnn_tpu_torch` loads no model, no kernel module and no
    training code."""
    code = ("import sys, ggnn_tpu_torch; print(sorted(m for m in "
            "sys.modules if m.startswith('ggnn_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    assert eval(out) == ["ggnn_tpu_torch", "ggnn_tpu_torch.graph",
                         "ggnn_tpu_torch.utils",
                         "ggnn_tpu_torch.utils.constants"]

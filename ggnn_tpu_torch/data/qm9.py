"""QM9 dataset extraction (the reference's get_data.py semantics), a copy
of the JAX package's `ggnn_tpu/data/qm9.py`.

Downloads the QM9 xyz tarball (figshare id 3195389), parses SMILES and the
dipole moment mu (property column 4), splits by `valid_idx.json`
(13,082 validation molecule ids, assets/), normalizes mu by the TRAIN
mean/std, and converts SMILES to graphs: explicit hydrogens, bonds typed
{SINGLE:1, DOUBLE:2, TRIPLE:3, AROMATIC:4}, nodes one-hot over
[H, C, N, O, F]. Output schema matches get_data.py:82-86, and from the
same tarball and split file the two packages write the same bytes.

rdkit and network access are optional dependencies of this module only:
the rest of the port consumes the JSON output (or the synthetic
generator in data/synthetic.py). When rdkit is absent the SMILES
conversion falls back to the dependency-free parser in data/smiles.py
(QM9's chemistry is small enough to parse exactly).

    python -m ggnn_tpu_torch.data.qm9 --tarball dsgdb9nsd.xyz.tar.bz2 \
        --data-dir data --out-dir .
"""

import glob
import json
import os
import shutil
import tarfile
import urllib.request
from typing import Dict, List

import numpy as np

QM9_URL = "https://ndownloader.figshare.com/files/3195389"
BOND_DICT = {"SINGLE": 1, "DOUBLE": 2, "TRIPLE": 3, "AROMATIC": 4}
ATOM_SYMBOLS = ["H", "C", "N", "O", "F"]
INDEX_OF_MU = 4


def download_qm9(data_dir: str = "data", tarball: str = None) -> str:
    """Fetch (or reuse `tarball`, for air-gapped hosts) and extract the
    QM9 xyz archive; returns the extraction dir (get_data.py:11-23).

    Stdlib only (urllib + tarfile — the reference shells out to
    wget/tar, which stock macOS/Windows lack), and ATOMIC: both the
    download and the extraction stage into a temp path renamed on
    success, so an interrupted run cannot leave partial artifacts that
    a re-run would silently trust (a truncated extraction would flow
    straight into preprocess and skew the train mean/std)."""
    os.makedirs(data_dir, exist_ok=True)
    tar_path = tarball or os.path.join(data_dir, "dsgdb9nsd.xyz.tar.bz2")
    if not os.path.exists(tar_path):
        if tarball:
            raise FileNotFoundError(f"--tarball {tarball} does not exist")
        tmp = tar_path + ".part"
        urllib.request.urlretrieve(QM9_URL, tmp)
        os.replace(tmp, tar_path)
    unzip_path = os.path.join(data_dir, "qm9_raw")
    if not os.path.exists(unzip_path):
        tmp_dir = unzip_path + ".part"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)  # leftover from an interrupted run
        os.makedirs(tmp_dir)
        with tarfile.open(tar_path, "r:bz2") as tf:
            tf.extractall(tmp_dir, filter="data")
        os.replace(tmp_dir, unzip_path)
    return unzip_path


def read_xyz(file_path: str) -> Dict:
    with open(file_path, "r") as f:
        lines = f.readlines()
    smiles = lines[-2].split("\t")[0]
    mu = float(lines[1].split("\t")[INDEX_OF_MU])
    return {"smiles": smiles, "mu": mu}


def smiles_to_graph(smiles: str, backend: str = "auto"):
    """SMILES -> (one-hot nodes over [H,C,N,O,F], (begin,type,end) edges),
    matching get_data.py:63-73. `backend`: "rdkit", "builtin", or "auto"
    (rdkit when importable, else the dependency-free parser in
    data/smiles.py — same bond typing and AddHs materialisation,
    hand-verified chemistry oracle in tests/test_smiles.py)."""
    if backend not in ("auto", "rdkit", "builtin"):
        raise ValueError(f"unknown smiles backend {backend!r}")
    if backend != "builtin":
        try:
            from rdkit import Chem  # optional dependency, extraction-only
        except ImportError:
            if backend == "rdkit":
                raise
        else:
            mol = Chem.MolFromSmiles(smiles)
            if mol is None:
                # AddHs(None) would die with an opaque Boost error deep
                # in the 133k-molecule loop; name the offending SMILES.
                raise ValueError(
                    f"rdkit could not parse SMILES {smiles!r}")
            mol = Chem.AddHs(mol)
            edges = [
                (b.GetBeginAtomIdx(), BOND_DICT[str(b.GetBondType())],
                 b.GetEndAtomIdx())
                for b in mol.GetBonds()
            ]
            nodes = [
                [1 if i == ATOM_SYMBOLS.index(a.GetSymbol()) else 0
                 for i in range(5)]
                for a in mol.GetAtoms()
            ]
            return nodes, edges
    from ggnn_tpu_torch.data.smiles import smiles_to_graph as builtin
    return builtin(smiles, tuple(ATOM_SYMBOLS))


VALID_IDX_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "assets", "valid_idx.json")


def load_valid_idx(valid_idx_path: str = VALID_IDX_PATH) -> set:
    """The 13,082 validation molecule ids (vendored copy of the split
    file the reference ships; loaded at get_data.py:37-39)."""
    with open(valid_idx_path, "r") as f:
        return set(json.load(f)["valid_idxs"])


def preprocess(unzip_path: str, valid_idx_path: str = VALID_IDX_PATH,
               out_dir: str = ".") -> None:
    os.makedirs(out_dir, exist_ok=True)  # before minutes of parsing
    valid_idx = load_valid_idx(valid_idx_path)

    raw: Dict[str, List[Dict]] = {"train": [], "valid": []}
    # sorted(): glob returns filesystem order, which varies by host —
    # the emitted example ORDER (and therefore 1-epoch numbers) must be
    # reproducible across machines and re-extractions.
    for file_path in sorted(glob.glob(os.path.join(unzip_path, "*.xyz"))):
        # Filenames are dsgdb9nsd_<id>.xyz; the split file stores the ids.
        mol_id = os.path.basename(file_path)[len("dsgdb9nsd_"):-len(".xyz")]
        section = "valid" if mol_id in valid_idx else "train"
        raw[section].append(read_xyz(file_path))

    train_mu = np.array([m["mu"] for m in raw["train"]])
    mean_mu, std_mu = train_mu.mean(), train_mu.std()

    for section in ("train", "valid"):
        processed = []
        for mol in raw[section]:
            nodes, edges = smiles_to_graph(mol["smiles"])
            processed.append({
                "targets": [[float((mol["mu"] - mean_mu) / std_mu)]],
                "graph": edges,
                "node_features": nodes,
            })
        with open(os.path.join(out_dir, f"molecules_{section}.json"), "w") as f:
            json.dump(processed, f)


def main(argv=None):
    """One-command extraction: with network, `python -m
    ggnn_tpu_torch.data.qm9`; air-gapped, from a pre-fetched archive
    (figshare id 3195389), `python -m ggnn_tpu_torch.data.qm9 --tarball
    /path/dsgdb9nsd.xyz.tar.bz2`. Then `python -m ggnn_tpu_torch.cli
    sparse --data_dir OUT_DIR` (or another variant) trains on the
    emitted molecules_{train,valid}.json."""
    import argparse
    ap = argparse.ArgumentParser(
        description="QM9 extraction (reference get_data.py semantics)")
    ap.add_argument("--tarball", default=None,
                    help="pre-downloaded dsgdb9nsd.xyz.tar.bz2 (skips wget)")
    ap.add_argument("--data-dir", default="data",
                    help="scratch dir for the download/extraction")
    ap.add_argument("--out-dir", default=".",
                    help="where molecules_{train,valid}.json are written")
    args = ap.parse_args(argv)
    unzip_path = download_qm9(args.data_dir, tarball=args.tarball)
    preprocess(unzip_path, out_dir=args.out_dir)


if __name__ == "__main__":
    main()

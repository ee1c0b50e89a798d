"""QM9-shaped molecules from a seed, drawn in bulk.

A frozen copy of the distribution of `ggnn_tpu_torch/data/synthetic.py`,
vectorised so that a corpus of QM9's size (130,831 molecules) takes well
under a second instead of the tens of seconds its per-graph loop takes:

  * atoms: N(18, 5) truncated toward zero and clipped to [4, 29];
  * a random spanning tree (atom i > 0 bonds to a uniform earlier atom),
    bond types 1-4 with probabilities 0.75, 0.12, 0.03, 0.10;
  * ring closures: a uniform count in [0, max(1, n // 6)] of uniform atom
    pairs, each of type 1, dropped where the pair is one atom;
  * atom types H, C, N, O, F with probabilities 0.5, 0.35, 0.05, 0.08,
    0.02, one-hot;
  * target 0.08 n + 0.5 #O + 0.3 #N + 0.02 (sum of bond types)
    + 0.1 N(0, 1), normalised to mean 0 and deviation 1 over the corpus.

The draws are not those of the per-graph generator (another order), so
the molecules differ from it for the same seed; the distribution is the
same. `Corpus` holds the molecules as flat arrays, and `as_json` gives
them in the reference's JSON schema, which the port's entries take.
"""

import dataclasses
from typing import Dict, List

import numpy as np

MIN_ATOMS, MAX_ATOMS = 4, 29
ATOMS_MEAN, ATOMS_STD = 18.0, 5.0
BOND_TYPE_P = (0.75, 0.12, 0.03, 0.10)      # types 1, 2, 3, 4
ATOM_TYPE_P = (0.5, 0.35, 0.05, 0.08, 0.02)  # H, C, N, O, F
NUM_ATOM_TYPES = 5
NUM_BOND_TYPES = 4


@dataclasses.dataclass
class Corpus:
    """Molecules as flat arrays. Edges are the raw bonds [src, type, dst]
    (type 1-based), each molecule's rows contiguous."""

    num_atoms: np.ndarray      # [G] int64
    atom_types: np.ndarray     # [sum atoms] int64, 0-4
    edges: np.ndarray          # [sum bonds, 3] int64
    bonds: np.ndarray          # [G] int64, bond rows a molecule
    targets: np.ndarray        # [G] float64, normalised

    @property
    def num_graphs(self) -> int:
        return len(self.num_atoms)

    @property
    def node_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.num_atoms)])

    @property
    def edge_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.bonds)])

    def take(self, ids) -> "Corpus":
        """The molecules `ids`, in that order (targets kept as they are)."""
        ids = np.asarray(ids, np.int64)
        no, eo = self.node_offsets, self.edge_offsets
        node_rows = _ranges(no[ids], self.num_atoms[ids])
        edge_rows = _ranges(eo[ids], self.bonds[ids])
        return Corpus(self.num_atoms[ids], self.atom_types[node_rows],
                      self.edges[edge_rows], self.bonds[ids],
                      self.targets[ids])

    def as_json(self) -> List[Dict]:
        """The reference's schema: {"targets": [[t]], "graph": [[src,
        type, dst], ...], "node_features": [[one-hot], ...]}."""
        edges = self.edges.tolist()
        feats = np.eye(NUM_ATOM_TYPES, dtype=np.int64)[self.atom_types
                                                       ].tolist()
        targets = self.targets.tolist()
        no, eo = self.node_offsets.tolist(), self.edge_offsets.tolist()
        return [{"targets": [[targets[g]]],
                 "graph": edges[eo[g]:eo[g + 1]],
                 "node_features": feats[no[g]:no[g + 1]]}
                for g in range(self.num_graphs)]


def _ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The concatenation of arange(s, s + n) over (s, n)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    begin = np.repeat(np.cumsum(lengths) - lengths, lengths)
    return np.repeat(starts, lengths) + np.arange(total) - begin


def _categorical(rng: np.random.Generator, p, size: int) -> np.ndarray:
    cum = np.cumsum(p)
    cum[-1] = 1.0
    return np.searchsorted(cum, rng.random(size), side="right")


def molecules(num_graphs: int, seed: int) -> Corpus:
    """`num_graphs` molecules drawn from `seed` (any integer)."""
    rng = np.random.default_rng(abs(int(seed)))
    n = np.clip(rng.normal(ATOMS_MEAN, ATOMS_STD, num_graphs),
                MIN_ATOMS, MAX_ATOMS).astype(np.int64)
    node_off = np.concatenate([[0], np.cumsum(n)])
    # Spanning tree: atom i > 0 of each molecule bonds to a uniform j < i.
    tree_graph = np.repeat(np.arange(num_graphs), n - 1)
    child = (np.arange(int((n - 1).sum()))
             - np.repeat(np.cumsum(n - 1) - (n - 1), n - 1) + 1)
    parent = np.floor(rng.random(len(child)) * child).astype(np.int64)
    tree_type = _categorical(rng, BOND_TYPE_P, len(child)) + 1
    # Ring closures: a uniform count in [0, max(1, n // 6)], uniform pairs.
    extra = np.floor(rng.random(num_graphs)
                     * (np.maximum(1, n // 6) + 1)).astype(np.int64)
    ring_graph = np.repeat(np.arange(num_graphs), extra)
    a = np.floor(rng.random(len(ring_graph)) * n[ring_graph]).astype(np.int64)
    b = np.floor(rng.random(len(ring_graph)) * n[ring_graph]).astype(np.int64)
    keep = a != b
    ring_graph, a, b = ring_graph[keep], a[keep], b[keep]
    graph_of = np.concatenate([tree_graph, ring_graph])
    rows = np.stack([np.concatenate([parent, np.minimum(a, b)]),
                     np.concatenate([tree_type, np.ones(len(a), np.int64)]),
                     np.concatenate([child, np.maximum(a, b)])], axis=1)
    # Each molecule's tree bonds, then its ring closures.
    order = np.argsort(graph_of, kind="stable")
    edges = rows[order]
    bonds = np.bincount(graph_of, minlength=num_graphs).astype(np.int64)
    atom_types = _categorical(rng, ATOM_TYPE_P, int(node_off[-1]))
    atom_graph = np.repeat(np.arange(num_graphs), n)
    oxygens = np.bincount(atom_graph, atom_types == 3, num_graphs)
    nitrogens = np.bincount(atom_graph, atom_types == 2, num_graphs)
    bond_sum = np.bincount(graph_of[order], edges[:, 1], num_graphs)
    raw = (0.08 * n + 0.5 * oxygens + 0.3 * nitrogens + 0.02 * bond_sum
           + 0.1 * rng.normal(size=num_graphs))
    targets = (raw - raw.mean()) / max(raw.std(), 1e-8)
    return Corpus(n, atom_types.astype(np.int64), edges, bonds, targets)

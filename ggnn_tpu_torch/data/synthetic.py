"""Deterministic QM9-shaped synthetic molecule generator.

Connected graphs of 4-29 nodes (mean ~18), 5-dim one-hot node
annotations over {H,C,N,O,F}, bond types 1-4 with QM9-like frequencies
(mostly single bonds), and a smooth normalized scalar target that
depends on graph composition. Output follows the reference JSON schema
(get_data.py:82-86) and, for the same seed, is identical to the JAX
package's `ggnn_tpu/data/synthetic.py`, as are `synthetic_giant_graph`
(one large connected graph) and `async_fixture_molecules` (the corpus
of the async TF1 fixtures).
"""

from typing import Any, Dict, List

import numpy as np


def _one_hot_atoms(atom_types) -> List[List[int]]:
    """One-hot rows over the 5-symbol QM9 alphabet [H, C, N, O, F]
    (get_data.py:70-71)."""
    return [[1 if t == a else 0 for t in range(5)] for a in atom_types]


def _normalize_targets(data, num_targets: int) -> None:
    """In-place corpus mean/std normalization per target column
    (get_data.py:51-56; std floored at 1e-8 for single-value corpora)."""
    for k in range(num_targets):
        vals = np.array([d["targets"][k][0] for d in data])
        mean, std = vals.mean(), max(vals.std(), 1e-8)
        for d in data:
            d["targets"][k][0] = float((d["targets"][k][0] - mean) / std)


def _one_graph(rng: np.random.Generator,
               num_targets: int = 1) -> Dict[str, Any]:
    n = int(np.clip(rng.normal(18.0, 5.0), 4, 29))
    # Random spanning tree: node i>0 attaches to a previous node.
    edges = []
    for i in range(1, n):
        parent = int(rng.integers(0, i))
        bond = int(rng.choice([1, 2, 3, 4], p=[0.75, 0.12, 0.03, 0.10]))
        edges.append([parent, bond, i])
    # A few ring-closing extra edges (molecules have cycles).
    n_extra = int(rng.integers(0, max(1, n // 6) + 1))
    for _ in range(n_extra):
        a, b = rng.integers(0, n, size=2)
        if a != b:
            edges.append([int(min(a, b)), 1, int(max(a, b))])
    atom_types = rng.choice(5, size=n, p=[0.5, 0.35, 0.05, 0.08, 0.02])
    node_features = _one_hot_atoms(atom_types)
    # Smooth learnable target: composition + size + bond statistics.
    bond_sum = sum(e[1] for e in edges)
    target = (
        0.08 * n
        + 0.5 * float(np.sum(atom_types == 3))   # "oxygens" are polar
        + 0.3 * float(np.sum(atom_types == 2))
        + 0.02 * bond_sum
        + 0.1 * rng.normal()
    )
    targets = [[target]]
    for k in range(1, num_targets):  # extra tasks: distinct smooth fns
        targets.append([0.05 * n + 0.4 * float(np.sum(atom_types == k % 5))
                        + 0.1 * rng.normal()])
    return {
        "targets": targets,
        "graph": edges,
        "node_features": node_features,
    }


def synthetic_giant_graph(num_nodes: int, seed: int = 0,
                          extra_edge_frac: float = 0.5
                          ) -> List[Dict[str, Any]]:
    """ONE large connected graph in the reference schema — the stress
    case for node-sharded edge partitioning (SURVEY §5.7: molecular
    batches are disconnected components with near-zero cut; a giant
    packed graph deliberately split across shards is where the boundary
    exchange actually works). Random spanning tree over a shuffled node
    order + long-range extra edges, so contiguous node-range shards see
    a substantial cut."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_nodes)
    edges = []
    for i in range(1, num_nodes):
        parent = order[int(rng.integers(0, i))]
        bond = int(rng.choice([1, 2, 3, 4], p=[0.75, 0.12, 0.03, 0.10]))
        edges.append([int(parent), bond, int(order[i])])
    for _ in range(int(num_nodes * extra_edge_frac)):
        a, b = rng.integers(0, num_nodes, size=2)
        if a != b:
            edges.append([int(a), int(rng.integers(1, 5)), int(b)])
    atom_types = rng.choice(5, size=num_nodes,
                            p=[0.5, 0.35, 0.05, 0.08, 0.02])
    node_features = _one_hot_atoms(atom_types)
    target = 0.001 * num_nodes + 0.1 * float(np.mean(atom_types))
    return [{"targets": [[target]], "graph": edges,
             "node_features": node_features}]


def async_fixture_molecules(num_graphs: int, seed: int = 0,
                            num_targets: int = 1,
                            n_lo: int = 8, n_hi: int = 11
                            ) -> List[Dict[str, Any]]:
    """Corpus for the async TF1 golden fixtures: graphs constructed so
    the reference's latent schedule bugs are DORMANT, making its
    execution directly comparable (VERDICT round 2, next-item #1):

      * node n-1 is the UNIQUE minimum-degree node (backbone chain
        0-1-...-n-1, node 0 closed with an extra edge, extras only among
        nodes 0..n-2), so the reference's dict-order min
        (chem_tensorflow_async.py:308) and this repo's (count, node)
        tie-break pick the SAME DFS seed;
      * sizes in [n_lo, n_hi] with 2*n_lo >= n_hi+1, so a node budget of
        n_hi+1 packs exactly ONE graph per batch in both batchers and the
        reference's per-type msg-target offset bug (async.py:399-401)
        never engages;
      * connected, self-loop-free (every node on the backbone), keeping
        the reference's equal-depth assert (async.py:330) and its
        unwritten-TensorArray-row zero-state quirk out of play;
      * edge types span 1..4 INCLUDING the max — the reference silently
        drops max-type edges from messages but keeps their targets as
        receivers (async.py:258-266); the replay mirrors that with a
        zero-weight extra type slot (tests/test_tf1_golden.py).

    Use with propagation_rounds=2 (only round-pair 0 exists, so the
    tuple-indexing seed bug at async.py:308 is unreachable)."""
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(num_graphs):
        n = int(rng.integers(n_lo, n_hi + 1))
        edges = [[i, int(rng.integers(1, 5)), i + 1] for i in range(n - 1)]
        # close node 0 so node n-1 is the unique degree-1 node
        edges.append([0, int(rng.integers(1, 5)), int(rng.integers(2, n - 1))])
        for _ in range(int(rng.integers(1, 4))):
            a, b = rng.integers(0, n - 1, size=2)
            if a != b:
                edges.append([int(a), int(rng.integers(1, 5)), int(b)])
        atom_types = rng.choice(5, size=n, p=[0.5, 0.35, 0.05, 0.08, 0.02])
        node_features = _one_hot_atoms(atom_types)
        bond_sum = sum(e[1] for e in edges)
        targets = [[0.08 * n + 0.5 * float(np.sum(atom_types == 3))
                    + 0.02 * bond_sum + 0.1 * rng.normal()]]
        for k in range(1, num_targets):
            targets.append([0.05 * n + 0.4 * float(np.sum(atom_types == k % 5))
                            + 0.1 * rng.normal()])
        data.append({"targets": targets, "graph": edges,
                     "node_features": node_features})
    _normalize_targets(data, num_targets)
    return data


def synthetic_molecules(num_graphs: int, seed: int = 0,
                        normalize: bool = True,
                        num_targets: int = 1) -> List[Dict[str, Any]]:
    rng = np.random.default_rng(seed)
    data = [_one_graph(rng, num_targets) for _ in range(num_graphs)]
    if normalize:
        _normalize_targets(data, num_targets)
    return data

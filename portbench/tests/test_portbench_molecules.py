"""The frozen, vectorised molecule generator keeps the distribution that
ggnn_tpu_torch/data/synthetic.py documents, and its own draws."""

import numpy as np

from ggnn_tpu_torch.data import synthetic
from portbench import molecules


def _stats_of_json(graphs):
    n = np.array([len(g["node_features"]) for g in graphs])
    atoms = np.concatenate([np.argmax(g["node_features"], 1) for g in graphs])
    tree = np.concatenate([[e[1] for e in g["graph"][:len(g["node_features"])
                                                    - 1]] for g in graphs])
    return n, atoms, tree


def test_distribution_matches_the_documented_one():
    corpus = molecules.molecules(20000, seed=3)
    n = corpus.num_atoms
    assert n.min() >= 4 and n.max() <= 29
    assert abs(n.mean() - 17.5) < 0.3        # N(18, 5) truncated, clipped
    atoms = (np.bincount(corpus.atom_types, minlength=5)
             / corpus.atom_types.size)
    assert np.allclose(atoms, molecules.ATOM_TYPE_P, atol=0.01)
    tree_rows = np.concatenate([
        np.arange(s, s + k - 1) for s, k in zip(corpus.edge_offsets[:-1], n)])
    bonds = np.bincount(corpus.edges[tree_rows, 1], minlength=5)[1:]
    assert np.allclose(bonds / bonds.sum(), molecules.BOND_TYPE_P, atol=0.01)
    extra = corpus.bonds - (n - 1)
    assert (extra >= 0).all() and (extra <= np.maximum(1, n // 6)).all()
    assert abs(corpus.targets.mean()) < 1e-9
    assert abs(corpus.targets.std() - 1.0) < 1e-9


def test_matches_the_ports_generator_in_distribution():
    ours = molecules.molecules(3000, seed=5).as_json()
    theirs = synthetic.synthetic_molecules(3000, seed=5)
    (n1, a1, t1), (n2, a2, t2) = _stats_of_json(ours), _stats_of_json(theirs)
    assert abs(n1.mean() - n2.mean()) < 0.5
    assert np.allclose(np.bincount(a1, minlength=5) / a1.size,
                       np.bincount(a2, minlength=5) / a2.size, atol=0.02)
    assert np.allclose(np.bincount(t1, minlength=5) / t1.size,
                       np.bincount(t2, minlength=5) / t2.size, atol=0.02)


def test_every_molecule_is_connected_and_the_seed_repeats():
    a = molecules.molecules(500, seed=2**31 + 9)
    b = molecules.molecules(500, seed=2**31 + 9)
    assert np.array_equal(a.edges, b.edges)
    assert np.array_equal(a.targets, b.targets)
    for g in a.as_json()[:50]:
        n = len(g["node_features"])
        seen, frontier = {0}, [0]
        adj = {}
        for s, _, d in g["graph"]:
            adj.setdefault(s, []).append(d)
            adj.setdefault(d, []).append(s)
        while frontier:
            v = frontier.pop()
            for w in adj.get(v, []):
                if w not in seen:
                    seen.add(w)
                    frontier.append(w)
        assert len(seen) == n
        assert all(s != d for s, _, d in g["graph"])

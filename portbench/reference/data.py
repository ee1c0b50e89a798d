"""The reference's batches, from the benchmark's molecules.

The published training pipeline draws from one numpy stream seeded with
`random_seed` (chem_tensorflow.py: `np.random.seed`): the training split
is shuffled once when it is loaded, and again at the start of every
epoch. The sparse model packs the shuffled molecules greedily while the
batch's atoms stay under the node budget (chem_tensorflow_sparse.py:
`node_offset + n < batch_size`). The dense model buckets molecules by
atom count (bucket sizes 4, 6, ..., 26, 29), shuffles each bucket when
it loads, and each epoch shuffles the sequence of full batches (each
bucket's remainder dropped) and each bucket's molecules
(chem_tensorflow_dense.py). Training on the device runs an epoch's
batches grouped by shape, groups in the order their first batch comes
(the JAX package's `train_on_device`, whose epoch the port replays).
"""

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from portbench.molecules import NUM_BOND_TYPES, Corpus

DENSE_BUCKETS = np.array(list(range(4, 28, 2)) + [29])


def sparse_epoch(num_atoms: np.ndarray, node_budget: int,
                 random_seed: int) -> List[np.ndarray]:
    """The molecule ids of each batch of the first training epoch."""
    rng = np.random.RandomState(random_seed)
    order = np.arange(len(num_atoms), dtype=np.int32)
    rng.shuffle(order)                 # when the split is loaded
    order = order.copy()
    rng.shuffle(order)                 # the epoch's shuffle
    return pack_greedy(num_atoms, order, node_budget)


def pack_greedy(num_atoms: np.ndarray, order: np.ndarray,
                node_budget: int) -> List[np.ndarray]:
    """`order` cut into batches whose atoms stay under `node_budget`."""
    batches, start, count = [], 0, 0
    sizes = num_atoms[order]
    for i, n in enumerate(sizes.tolist()):
        if count + n >= node_budget and i > start:
            batches.append(order[start:i])
            start, count = i, 0
        count += n
    if start < len(order):
        batches.append(order[start:])
    return batches


def dense_epoch(num_atoms: np.ndarray, batch_size: int,
                random_seed: int) -> List[Tuple[np.ndarray, int]]:
    """(molecule ids, bucket size) of each batch of the first training
    epoch, in the order the device epoch runs them."""
    rng = np.random.RandomState(random_seed)
    chosen = np.argmax(DENSE_BUCKETS[None, :] >= num_atoms[:, None], axis=1)
    seen = list(dict.fromkeys(chosen.tolist()))
    orders = []
    for c in seen:                     # when the split is loaded
        ids = np.nonzero(chosen == c)[0].astype(np.int32)
        rng.shuffle(ids)
        orders.append(ids)
    orders = [ids.copy() for ids in orders]
    at_step = [b for b, ids in enumerate(orders)
               for _ in range(len(ids) // batch_size)]
    rng.shuffle(at_step)               # the epoch's shuffle
    for ids in orders:
        rng.shuffle(ids)
    taken = [0] * len(orders)
    batches = []
    for b in at_step:
        start = taken[b] * batch_size
        taken[b] += 1
        batches.append((orders[b][start:start + batch_size],
                        int(DENSE_BUCKETS[seen[b]])))
    # Grouped by shape, groups in first-seen order.
    groups = list(dict.fromkeys(v for _, v in batches))
    return [bt for v in groups for bt in batches if bt[1] == v]


@dataclasses.dataclass
class SparseBatch:
    """Molecules as one graph: features [N, H], every bond in both
    directions (source, target, 0-based type) and each atom's molecule."""

    features: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    etype: torch.Tensor
    graph_of: torch.Tensor
    targets: torch.Tensor     # [G]
    num_graphs: int


@dataclasses.dataclass
class DenseBatch:
    """features [B, V, H], adjacency [B, T, V, V] with a[b, t, dst, src]
    = 1 for a bond of type t + 1 in either direction, mask [B, V]."""

    features: torch.Tensor
    adjacency: torch.Tensor
    mask: torch.Tensor
    targets: torch.Tensor     # [B]


def _features(corpus: Corpus, hidden: int) -> np.ndarray:
    feats = np.zeros((int(corpus.num_atoms.sum()), hidden), np.float32)
    feats[np.arange(len(corpus.atom_types)), corpus.atom_types] = 1.0
    return feats


def sparse_batch(corpus: Corpus, hidden: int, device) -> SparseBatch:
    """The molecules of `corpus` as one sparse batch on `device`."""
    node_off = corpus.node_offsets
    base = np.repeat(node_off[:-1], corpus.bonds)
    s = corpus.edges[:, 0] + base
    d = corpus.edges[:, 2] + base
    t = corpus.edges[:, 1] - 1
    g = np.repeat(np.arange(corpus.num_graphs), corpus.num_atoms)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return SparseBatch(
        features=dev(_features(corpus, hidden), torch.float32),
        src=dev(np.concatenate([s, d]), torch.long),
        dst=dev(np.concatenate([d, s]), torch.long),
        etype=dev(np.concatenate([t, t]), torch.long),
        graph_of=dev(g, torch.long),
        targets=dev(corpus.targets, torch.float32),
        num_graphs=corpus.num_graphs)


def dense_batch(corpus: Corpus, bucket: int, hidden: int,
                device) -> DenseBatch:
    """The molecules of `corpus` (at most `bucket` atoms each) as one
    dense batch on `device`."""
    b = corpus.num_graphs
    feats = np.zeros((b, bucket, hidden), np.float32)
    mask = np.zeros((b, bucket), np.float32)
    slot = (np.arange(int(corpus.num_atoms.sum()))
            - np.repeat(corpus.node_offsets[:-1], corpus.num_atoms))
    row = np.repeat(np.arange(b), corpus.num_atoms)
    feats[row, slot, corpus.atom_types] = 1.0
    mask[row, slot] = 1.0
    adj = np.zeros((b, NUM_BOND_TYPES, bucket, bucket), np.float32)
    erow = np.repeat(np.arange(b), corpus.bonds)
    s, t, d = corpus.edges[:, 0], corpus.edges[:, 1] - 1, corpus.edges[:, 2]
    adj[erow, t, d, s] = 1.0
    adj[erow, t, s, d] = 1.0

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return DenseBatch(dev(feats), dev(adj), dev(mask),
                      dev(corpus.targets))

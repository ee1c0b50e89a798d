"""The native batch pipeline: C assembly, Python orchestration. The
port of `ggnn_tpu/data/native_pack.py`, over the port's own library
(`ggnn_tpu_torch/native`, a copy of the JAX package's packer.cpp).

The corpus is flattened once into contiguous arrays (`FlatCorpus`);
bucketing, shuffling and label semantics stay in vectorised Python, and
each batch's per-edge and per-node scatter work is one C call. The
batches equal the JAX package's native batches bit for bit, in eval and
in training mode from the same `RandomState`, and in eval mode they
equal the numpy packers' (data/packing.py;
tests/test_torch_native_pack.py). The flattening is paid once per run,
not per epoch. Each packer assembles its batches on a pool of `workers`
threads: the C calls release the GIL.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ggnn_tpu_torch.data.packing import (DENSE_BUCKET_SIZES, PackCapacities,
                                         build_combined_lane,
                                         ell_graph_batch,
                                         plan_capacities_from_walk,
                                         plan_gcn_capacities_from_walk)
from ggnn_tpu_torch.graph import DenseGraphBatch, GCNGraphBatch, GraphBatch
from ggnn_tpu_torch.native import require_lib


@dataclasses.dataclass
class FlatCorpus:
    """The whole dataset as contiguous arrays (one-time flattening)."""

    edges: np.ndarray         # [E_tot, 3] int32 (src, 1-based type, dst)
    edge_offsets: np.ndarray  # [G+1] int64
    feats: np.ndarray         # [N_tot, A] float32
    node_offsets: np.ndarray  # [G+1] int64
    targets: np.ndarray       # [G, K] float32
    target_mask: np.ndarray   # [G, K] float32
    max_vertex: np.ndarray    # [G] int32 (max vertex id per graph)
    num_nodes: np.ndarray     # [G] int64
    edges_per_graph: np.ndarray  # [G] int64

    @property
    def num_graphs(self) -> int:
        return len(self.num_nodes)

    @classmethod
    def from_raw(cls, raw_data: Sequence[Any],
                 task_ids: Sequence[int]) -> "FlatCorpus":
        g_count = len(raw_data)
        edge_counts = np.fromiter((len(d["graph"]) for d in raw_data),
                                  np.int64, g_count)
        node_counts = np.fromiter((len(d["node_features"]) for d in raw_data),
                                  np.int64, g_count)
        edge_offsets = np.zeros(g_count + 1, np.int64)
        np.cumsum(edge_counts, out=edge_offsets[1:])
        node_offsets = np.zeros(g_count + 1, np.int64)
        np.cumsum(node_counts, out=node_offsets[1:])
        edges = np.empty((int(edge_offsets[-1]), 3), np.int32)
        # Feature width from the first NON-empty graph (a zero-node
        # entry must not crash the width probe).
        feat_w = next((len(d["node_features"][0]) for d in raw_data
                       if d["node_features"]), 0)
        feats = np.empty((int(node_offsets[-1]), feat_w), np.float32)
        for i, d in enumerate(raw_data):
            if d["graph"]:
                edges[edge_offsets[i]:edge_offsets[i + 1]] = d["graph"]
            if d["node_features"]:
                feats[node_offsets[i]:node_offsets[i + 1]] = \
                    d["node_features"]
        targets = np.zeros((g_count, len(task_ids)), np.float32)
        target_mask = np.ones((g_count, len(task_ids)), np.float32)
        for i, d in enumerate(raw_data):
            for k, task_id in enumerate(task_ids):
                v = d["targets"][task_id][0]
                if v is None:
                    target_mask[i, k] = 0.0
                else:
                    targets[i, k] = float(v)
        max_vertex = np.zeros(g_count, np.int32)
        seg = np.repeat(np.arange(g_count), edge_counts)
        if len(seg):
            m = np.maximum(edges[:, 0], edges[:, 2])
            np.maximum.at(max_vertex, seg, m)
            if np.any(edges[:, [0, 2]] < 0):
                raise ValueError("negative vertex id in graph data")
        # The C kernels index raw buffers with these ids — validate once
        # here so corrupt input raises instead of corrupting memory.
        if len(seg) and np.any(edges[:, 1] < 1):
            raise ValueError(
                "edge type must be a positive 1-based integer "
                "(the C packers index [T,...] slabs with type-1)")
        # Only graphs that HAVE edges can reference a vertex (an
        # empty graph leaves max_vertex at its 0 init, which would
        # spuriously fail against node_counts == 0).
        bad = np.nonzero((max_vertex >= node_counts)
                         & (edge_counts > 0))[0]
        if len(bad):
            raise ValueError(
                f"graph {bad[0]}: edge references vertex "
                f"{int(max_vertex[bad[0]])} but only "
                f"{int(node_counts[bad[0]])} node_features rows exist")
        return cls(edges=edges, edge_offsets=edge_offsets, feats=feats,
                   node_offsets=node_offsets, targets=targets,
                   target_mask=target_mask, max_vertex=max_vertex,
                   num_nodes=node_counts, edges_per_graph=edge_counts)


def _map_ordered(fn: Callable, items: List, workers: int) -> Iterator:
    """Run `fn` over `items` on a thread pool, yielding results in
    order with bounded lookahead. The C assembly calls release the GIL
    (ctypes), so packing fans out across cores while the consumer
    dispatches device steps."""
    if workers <= 1 or len(items) <= 1:
        for it in items:
            yield fn(it)
        return
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending = []
        it = iter(items)
        for _ in range(2 * workers):
            try:
                pending.append(pool.submit(fn, next(it)))
            except StopIteration:
                break
        while pending:
            out = pending.pop(0).result()
            try:
                pending.append(pool.submit(fn, next(it)))
            except StopIteration:
                pass
            yield out


def _validate_edge_types(corpus: FlatCorpus, num_fwd: int) -> None:
    """Upper-bound check (lower bound is in FlatCorpus.from_raw): a raw
    type beyond the model's forward-type count would index past the C
    packers' [T, ...] slabs — heap corruption, not an exception."""
    if len(corpus.edges):
        worst = int(corpus.edges[:, 1].max())
        if worst > num_fwd:
            raise ValueError(
                f"edge type {worst} exceeds the model's {num_fwd} "
                f"forward edge types")


def _validate_feature_geometry(corpus: FlatCorpus, hidden_size: int,
                               annotation_size: int) -> None:
    """The C kernels memcpy `annotation_size` floats per node row into
    `hidden_size`-strided output rows — a mismatch with the corpus'
    actual feature width (or hidden < annotation) is a heap overflow,
    not an exception (the python packers raise instead)."""
    feat_w = int(corpus.feats.shape[1]) if corpus.feats.size else annotation_size
    if annotation_size != feat_w:
        raise ValueError(
            f"annotation_size {annotation_size} != corpus feature "
            f"width {feat_w}")
    if hidden_size < annotation_size:
        raise ValueError(
            f"hidden_size {hidden_size} < annotation_size "
            f"{annotation_size} (annotations are zero-padded UP to the "
            "hidden width)")


def _validate_node_budget(node_budget: int, caps: PackCapacities) -> None:
    """Batch composition bounds node counts by `node_budget`, but the C
    kernels write node rows into caps.nodes-sized buffers with NO bound
    check — a budget larger than the planned capacity (mismatched
    plan/pack arguments) would be silent heap corruption, not an
    exception (the numpy packers fail loudly in pad_to). The +1 mirrors the serving envelope trick (strict '<' fit
    check lets an exactly-capacity graph through; arrays are sized by
    caps.nodes either way, and the fit guarantees node_count < budget
    <= caps.nodes + 1 => node_count <= caps.nodes)."""
    if node_budget > caps.nodes + 1:
        raise ValueError(
            f"node_budget {node_budget} exceeds the planned node "
            f"capacity {caps.nodes} (+1): batches composed under this "
            "budget would overrun the C packers' buffers — replan the "
            "capacities at this budget")


def apply_task_sample_ratios(target_mask: np.ndarray, order: np.ndarray,
                             task_ids: Sequence[int],
                             task_sample_ratios: Dict) -> None:
    """Blank labels past the sampled prefix of `order` (the shuffled
    per-split graph order), mirroring chem_tensorflow_sparse.py:243-250."""
    for k, task_id in enumerate(task_ids):
        ratio = task_sample_ratios.get(str(task_id))
        if ratio is not None:
            cut = int(len(order) * ratio)
            target_mask[order[cut:], k] = 0.0


# ------------------------------------------------------------- dense

@dataclasses.dataclass
class DenseProcessed:
    corpus: FlatCorpus
    bucket_order: List[np.ndarray]   # graph ids per bucket (stable order)
    bucket_v: List[int]              # padded vertex count per bucket


def preprocess_dense_native(raw_data, task_ids, task_sample_ratios,
                            is_training: bool,
                            rng: Optional[np.random.RandomState] = None,
                            bucket_sizes: Optional[np.ndarray] = None,
                            num_edge_types: Optional[int] = None,
                            tie_fwd_bkwd: bool = True) -> DenseProcessed:
    corpus = FlatCorpus.from_raw(raw_data, task_ids)
    if num_edge_types is not None:
        _validate_edge_types(
            corpus,
            num_edge_types if tie_fwd_bkwd else num_edge_types // 2)
    if bucket_sizes is None:
        bucket_sizes = DENSE_BUCKET_SIZES
    # Bucket by rows actually written (max edge vertex AND feature-row
    # count): the C assembly memcpys all num_nodes feature/mask rows into
    # the [V,H] slot, so a graph with isolated trailing nodes must land
    # in a bucket that holds them (matches the python path).
    needed = np.maximum(corpus.max_vertex + 1,
                        corpus.num_nodes.astype(np.int32))
    if int(needed.max(initial=0)) > int(bucket_sizes[-1]):
        # argmax over an all-False row would silently land in bucket 0
        # and the C assembly would write past the [V,V] adjacency.
        raise ValueError(
            f"graph with {int(needed.max())} vertices "
            f"exceeds the largest bucket ({int(bucket_sizes[-1])})")
    chosen = np.argmax(bucket_sizes[None, :] >= needed[:, None], axis=1)
    # Buckets in first-seen order, like the python dict insertion order.
    seen: List[int] = []
    for c in chosen:
        if c not in seen:
            seen.append(int(c))
    bucket_order, bucket_v = [], []
    for c in seen:
        ids = np.nonzero(chosen == c)[0].astype(np.int32)
        if is_training:
            if rng is not None:
                rng.shuffle(ids)
            apply_task_sample_ratios(corpus.target_mask, ids, task_ids,
                                     task_sample_ratios)
        bucket_order.append(ids)
        bucket_v.append(int(bucket_sizes[c]))
    return DenseProcessed(corpus=corpus, bucket_order=bucket_order,
                          bucket_v=bucket_v)


def pack_dense_batches_native(processed: DenseProcessed, batch_size: int,
                              hidden_size: int, annotation_size: int,
                              num_edge_types: int, tie_fwd_bkwd: bool,
                              is_training: bool,
                              rng: Optional[np.random.RandomState] = None,
                              drop_remainder: bool = True,
                              workers: int = 4,
                              adjacency_dtype=np.float32
                              ) -> Iterator[DenseGraphBatch]:
    lib = require_lib()
    corpus = processed.corpus
    # The preprocess-time check is optional (num_edge_types may be
    # unknown there); the pack call always knows it, and an unvalidated
    # out-of-range type would write past the C [B,T,V,V] slab.
    _validate_edge_types(
        corpus, num_edge_types if tie_fwd_bkwd else num_edge_types // 2)
    _validate_feature_geometry(corpus, hidden_size, annotation_size)
    bwd_offset = 0 if tie_fwd_bkwd else num_edge_types // 2
    orders = [ids.copy() for ids in processed.bucket_order]
    div = ((len(ids) // batch_size) if drop_remainder
           else -(-len(ids) // batch_size) for ids in orders)
    bucket_at_step = [bi for bi, n in enumerate(div) for _ in range(n)]
    if is_training and rng is not None:
        rng.shuffle(bucket_at_step)
        for ids in orders:
            rng.shuffle(ids)
    counters = [0] * len(orders)
    compositions = []
    for bi in bucket_at_step:
        start = counters[bi] * batch_size
        counters[bi] += 1
        compositions.append((orders[bi][start:start + batch_size],
                             processed.bucket_v[bi]))

    def assemble(comp):
        ids, v = comp
        b_real = len(ids)
        init = np.zeros((batch_size, v, hidden_size), np.float32)
        adj = np.zeros((batch_size, num_edge_types, v, v), np.float32)
        mask = np.zeros((batch_size, v), np.float32)
        lib.pack_dense_batch(
            corpus.edges, corpus.edge_offsets, corpus.feats,
            corpus.node_offsets, np.ascontiguousarray(ids, np.int32),
            b_real, num_edge_types, v, annotation_size, hidden_size,
            bwd_offset, init, adj, mask)
        targets = np.zeros((corpus.targets.shape[1], batch_size), np.float32)
        t_mask = np.zeros_like(targets)
        targets[:, :b_real] = corpus.targets[ids].T
        t_mask[:, :b_real] = corpus.target_mask[ids].T
        if adjacency_dtype == torch.bfloat16:
            # 0/1 entries are exact in bf16; the (dominant) adjacency
            # tensor stored narrow halves its copy and its reads under
            # compute_dtype "bfloat16". numpy has no bf16: the leaf is a
            # host torch tensor, which GraphBatch.to moves as it is.
            adj = torch.from_numpy(adj).to(torch.bfloat16)
        elif adjacency_dtype != np.float32:
            raise ValueError(
                f"adjacency_dtype {adjacency_dtype}: float32 or "
                "torch.bfloat16")
        return DenseGraphBatch(
            node_features=init, adjacency=adj, node_mask=mask,
            targets=targets, target_mask=t_mask,
            num_graphs=np.int32(b_real),
        )

    yield from _map_ordered(assemble, compositions, workers)


def preprocess_gcn_dense_native(raw_data, task_ids, task_sample_ratios,
                                is_training: bool,
                                rng: Optional[np.random.RandomState] = None,
                                bucket_sizes: Optional[np.ndarray] = None
                                ) -> DenseProcessed:
    """gcn_blocked preprocessing: identical bucketing to the dense path
    (edge types are discarded by the GCN family, so no type
    validation); normalization happens inside the C assembly."""
    return preprocess_dense_native(
        raw_data, task_ids, task_sample_ratios, is_training, rng,
        bucket_sizes=bucket_sizes)


def pack_gcn_dense_batches_native(processed: DenseProcessed,
                                  batch_size: int, hidden_size: int,
                                  annotation_size: int, is_training: bool,
                                  rng: Optional[np.random.RandomState] = None,
                                  drop_remainder: bool = False,
                                  workers: int = 4
                                  ) -> Iterator[DenseGraphBatch]:
    """gcn_blocked batches: [B,1,V,V] normalized dense adjacency
    (native/packer.cpp:pack_gcn_dense_batch), bit-identical in eval
    mode to packing.preprocess_gcn_dense + pack_dense_batches."""
    lib = require_lib()
    corpus = processed.corpus
    _validate_feature_geometry(corpus, hidden_size, annotation_size)
    orders = [ids.copy() for ids in processed.bucket_order]
    div = ((len(ids) // batch_size) if drop_remainder
           else -(-len(ids) // batch_size) for ids in orders)
    bucket_at_step = [bi for bi, n in enumerate(div) for _ in range(n)]
    if is_training and rng is not None:
        rng.shuffle(bucket_at_step)
        for ids in orders:
            rng.shuffle(ids)
    counters = [0] * len(orders)
    compositions = []
    for bi in bucket_at_step:
        start = counters[bi] * batch_size
        counters[bi] += 1
        compositions.append((orders[bi][start:start + batch_size],
                             processed.bucket_v[bi]))

    def assemble(comp):
        ids, v = comp
        b_real = len(ids)
        init = np.zeros((batch_size, v, hidden_size), np.float32)
        adj = np.zeros((batch_size, 1, v, v), np.float32)
        mask = np.zeros((batch_size, v), np.float32)
        lib.pack_gcn_dense_batch(
            corpus.edges, corpus.edge_offsets, corpus.feats,
            corpus.node_offsets, np.ascontiguousarray(ids, np.int32),
            b_real, v, annotation_size, hidden_size, init, adj, mask)
        targets = np.zeros((corpus.targets.shape[1], batch_size), np.float32)
        t_mask = np.zeros_like(targets)
        targets[:, :b_real] = corpus.targets[ids].T
        t_mask[:, :b_real] = corpus.target_mask[ids].T
        return DenseGraphBatch(
            node_features=init, adjacency=adj, node_mask=mask,
            targets=targets, target_mask=t_mask,
            num_graphs=np.int32(b_real),
        )

    yield from _map_ordered(assemble, compositions, workers)


# ------------------------------------------------------------- sparse

@dataclasses.dataclass
class SparseProcessed:
    corpus: FlatCorpus
    order: np.ndarray                # packing order of graph ids
    edge_type_counts: np.ndarray     # [G, T] int64 (incl. bkwd)


def preprocess_sparse_native(raw_data, num_edge_types, tie_fwd_bkwd,
                             task_ids, task_sample_ratios,
                             is_training: bool,
                             rng: Optional[np.random.RandomState] = None
                             ) -> SparseProcessed:
    corpus = FlatCorpus.from_raw(raw_data, task_ids)
    _validate_edge_types(
        corpus, num_edge_types if tie_fwd_bkwd else num_edge_types // 2)
    g_count = corpus.num_graphs
    counts = np.zeros((g_count, num_edge_types), np.int64)
    seg = np.repeat(np.arange(g_count), corpus.edges_per_graph)
    if len(seg):
        typ = corpus.edges[:, 1].astype(np.int64) - 1
        if tie_fwd_bkwd:
            np.add.at(counts, (seg, typ), 2)  # fwd + reversed, same type
        else:
            np.add.at(counts, (seg, typ), 1)
            np.add.at(counts, (seg, typ + num_edge_types // 2), 1)
    order = np.arange(g_count, dtype=np.int32)
    if is_training:
        if rng is not None:
            rng.shuffle(order)
        apply_task_sample_ratios(corpus.target_mask, order, task_ids,
                                 task_sample_ratios)
    return SparseProcessed(corpus=corpus, order=order,
                           edge_type_counts=counts)


def plan_capacities_native(processed: SparseProcessed, node_budget: int,
                           margin: float = None) -> PackCapacities:
    """Same walk as packing.plan_capacities over the flat arrays (the
    walk itself is shared — packing.plan_capacities_from_walk — so the
    two pipelines cannot drift)."""
    t_dim = processed.edge_type_counts.shape[1]
    return plan_capacities_from_walk(
        ((int(processed.corpus.num_nodes[g]),
          processed.edge_type_counts[g]) for g in processed.order),
        t_dim, node_budget, margin)


def pack_sparse_batches_native(processed: SparseProcessed,
                               num_edge_types: int, tie_fwd_bkwd: bool,
                               node_budget: int, caps: PackCapacities,
                               hidden_size: int, annotation_size: int,
                               is_training: bool,
                               rng: Optional[np.random.RandomState] = None,
                               ell_block: int = 0,
                               ell_k: Optional[int] = None,
                               workers: int = 4
                               ) -> Iterator[GraphBatch]:
    """The native counterpart of `packing.pack_sparse_batches`, equal
    to it leaf for leaf: the composition walk here, each batch
    assembled by the C packer on one of `workers` threads (with
    `ell_block`, its blocked-ELL layouts built there too)."""
    lib = require_lib()
    corpus = processed.corpus
    # Same pack-time re-validation as the dense path: preprocess may have run under a different num_edge_types /
    # tie_fwd_bkwd, and an unvalidated out-of-range type would make
    # the C kernel write edge rows past the [T, E] slab — silent heap
    # corruption instead of this ValueError.
    _validate_edge_types(
        corpus, num_edge_types if tie_fwd_bkwd else num_edge_types // 2)
    _validate_feature_geometry(corpus, hidden_size, annotation_size)
    _validate_node_budget(node_budget, caps)
    order = processed.order.copy()
    if is_training and rng is not None:
        rng.shuffle(order)
    num_tasks = corpus.targets.shape[1]

    # Sequential composition walk (cheap), parallel C assembly.
    compositions = []
    idx = 0
    while idx < len(order):
        batch_ids: List[int] = []
        node_count, edge_counts = 0, np.zeros(num_edge_types, np.int64)
        while idx < len(order):
            g = int(order[idx])
            n = int(corpus.num_nodes[g])
            g_edges = processed.edge_type_counts[g]
            fits = (node_count + n < node_budget
                    and len(batch_ids) + 1 <= caps.graphs
                    and np.all(edge_counts + g_edges <= caps.edges_per_type)
                    # Combined-lane bound, matching the python packer: an
                    # edges_all overflow would drop the edge_*_all arrays
                    # from this batch's pytree structure.
                    and (not caps.edges_all
                         or edge_counts.sum() + g_edges.sum()
                         <= caps.edges_all))
            if not fits:
                if not batch_ids:
                    raise ValueError(
                        f"graph with {n} nodes / {g_edges.max()} edges "
                        f"exceeds pack capacities {caps}")
                break
            batch_ids.append(g)
            node_count += n
            edge_counts += g_edges
            idx += 1
        compositions.append((batch_ids, node_count))

    def assemble(comp):
        batch_ids, node_count = comp
        e_cap = caps.edges_per_type
        edge_sources = np.zeros((num_edge_types, e_cap), np.int32)
        edge_targets = np.full((num_edge_types, e_cap), caps.nodes, np.int32)
        edge_mask = np.zeros((num_edge_types, e_cap), np.float32)
        in_degrees = np.zeros((caps.nodes, num_edge_types), np.float32)
        init = np.zeros((caps.nodes, hidden_size), np.float32)
        node_graph_ids = np.full((caps.nodes,), caps.graphs, np.int32)
        type_counts = np.zeros((num_edge_types,), np.int64)
        rc = lib.pack_sparse_batch(
            corpus.edges, corpus.edge_offsets, corpus.feats,
            corpus.node_offsets,
            np.ascontiguousarray(batch_ids, np.int32), len(batch_ids),
            num_edge_types, int(tie_fwd_bkwd), e_cap, annotation_size,
            hidden_size, edge_sources, edge_targets, edge_mask,
            in_degrees, init, node_graph_ids, type_counts)
        if rc != 0:
            raise ValueError(f"edge capacity overflow (caps {caps})")
        # Target-sort each type lane (padding target==caps.nodes stays
        # at the end), matching packing.pack_sparse_batches.
        for t in range(num_edge_types):
            sl = np.lexsort((edge_sources[t], edge_targets[t]))
            edge_sources[t] = edge_sources[t][sl]
            edge_targets[t] = edge_targets[t][sl]
            edge_mask[t] = edge_mask[t][sl]
        targets = np.zeros((num_tasks, caps.graphs), np.float32)
        t_mask = np.zeros_like(targets)
        targets[:, :len(batch_ids)] = corpus.targets[batch_ids].T
        t_mask[:, :len(batch_ids)] = corpus.target_mask[batch_ids].T
        common = dict(
            node_features=init, node_graph_ids=node_graph_ids,
            edge_sources=edge_sources, edge_targets=edge_targets,
            edge_mask=edge_mask, in_degrees=in_degrees,
            targets=targets, target_mask=t_mask,
            num_graphs=np.int32(len(batch_ids)),
            num_nodes=np.int32(node_count),
        )
        common.update(build_combined_lane(
            edge_sources, edge_targets, edge_mask, caps.edges_all,
            caps.nodes))
        if ell_block:
            return ell_graph_batch(common, caps.nodes, ell_block, ell_k)
        return GraphBatch(**common)

    yield from _map_ordered(assemble, compositions, workers)


# --------------------------------------------------------------------
# GCN edge-list pipeline (the `gcn` variant)
# --------------------------------------------------------------------

@dataclasses.dataclass
class GCNProcessed:
    """Flat corpus + per-graph normalized-adjacency COO row counts
    (nnz = n + 2·|unique undirected off-diagonal pairs| — the size of
    D^{-1/2}(sym(A)+I)D^{-1/2}'s support, needed by the greedy batch
    composition and the capacity planner)."""
    corpus: FlatCorpus
    order: np.ndarray         # packing order of graph ids
    nnz_per_graph: np.ndarray  # [G] int64


def preprocess_gcn_native(raw_data, task_ids, task_sample_ratios,
                          is_training: bool,
                          rng: Optional[np.random.RandomState] = None
                          ) -> GCNProcessed:
    """Native analog of packing.preprocess_gcn: the per-graph
    normalization moves into the C batch assembly (pack_gcn_batch), so
    preprocess only flattens the corpus and counts each graph's COO
    support (vectorised over the flat edge array)."""
    corpus = FlatCorpus.from_raw(raw_data, task_ids)
    g_count = corpus.num_graphs
    nnz = corpus.num_nodes.astype(np.int64).copy()
    if len(corpus.edges):
        seg = np.repeat(np.arange(g_count, dtype=np.int64),
                        corpus.edges_per_graph)
        s = corpus.edges[:, 0].astype(np.int64)
        t = corpus.edges[:, 2].astype(np.int64)
        off = s != t
        if np.any(off):
            lo, hi = np.minimum(s, t)[off], np.maximum(s, t)[off]
            sg = seg[off]
            if g_count < (1 << 21) and int(corpus.max_vertex.max()) < (1 << 21):
                keys = (sg << 42) | (lo << 21) | hi
                uniq_g = np.unique(keys) >> 42
            else:  # wide ids: exact but slower structured unique
                uniq_g = np.unique(np.stack([sg, lo, hi], 1), axis=0)[:, 0]
            nnz += 2 * np.bincount(uniq_g, minlength=g_count)
    order = np.arange(g_count, dtype=np.int32)
    if is_training:
        if rng is not None:
            rng.shuffle(order)
        apply_task_sample_ratios(corpus.target_mask, order, task_ids,
                                 task_sample_ratios)
    return GCNProcessed(corpus=corpus, order=order, nnz_per_graph=nnz)


def plan_gcn_capacities_native(processed: GCNProcessed, node_budget: int,
                               margin: float = None) -> PackCapacities:
    """Same walk as packing.plan_gcn_capacities (shared
    plan_gcn_capacities_from_walk — the two pipelines cannot drift)."""
    return plan_gcn_capacities_from_walk(
        ((int(processed.corpus.num_nodes[g]),
          int(processed.nnz_per_graph[g])) for g in processed.order),
        node_budget, margin)


def pack_gcn_batches_native(processed: GCNProcessed, node_budget: int,
                            caps: PackCapacities, hidden_size: int,
                            annotation_size: int, is_training: bool,
                            rng: Optional[np.random.RandomState] = None,
                            workers: int = 4) -> Iterator:
    """Native analog of packing.pack_gcn_batches: identical greedy
    composition, one C call per batch (normalization + COO emission +
    feature/graph-id fill), bit-identical eval batches
    (tests/test_native.py)."""
    lib = require_lib()
    corpus = processed.corpus
    _validate_feature_geometry(corpus, hidden_size, annotation_size)
    _validate_node_budget(node_budget, caps)
    order = processed.order.copy()
    if is_training and rng is not None:
        rng.shuffle(order)
    num_tasks = corpus.targets.shape[1]
    nnz = processed.nnz_per_graph

    compositions = []
    idx = 0
    while idx < len(order):
        batch_ids: List[int] = []
        node_count, edge_count = 0, 0
        while idx < len(order):
            g = int(order[idx])
            n = int(corpus.num_nodes[g])
            e = int(nnz[g])
            fits = (node_count + n < node_budget
                    and len(batch_ids) + 1 <= caps.graphs
                    and edge_count + e <= caps.edges_per_type)
            if not fits:
                if not batch_ids:
                    raise ValueError(
                        f"graph exceeds pack capacities {caps}")
                break
            batch_ids.append(g)
            node_count += n
            edge_count += e
            idx += 1
        compositions.append((batch_ids, node_count))

    def assemble(comp):
        batch_ids, node_count = comp
        e_cap = int(caps.edges_per_type)
        edge_sources = np.zeros(e_cap, np.int32)
        edge_targets = np.full(e_cap, caps.nodes, np.int32)
        edge_weights = np.zeros(e_cap, np.float32)
        init = np.zeros((caps.nodes, hidden_size), np.float32)
        node_graph_ids = np.full((caps.nodes,), caps.graphs, np.int32)
        rc = lib.pack_gcn_batch(
            corpus.edges, corpus.edge_offsets, corpus.feats,
            corpus.node_offsets,
            np.ascontiguousarray(batch_ids, np.int32), len(batch_ids),
            e_cap, annotation_size, hidden_size,
            edge_sources, edge_targets, edge_weights, init,
            node_graph_ids)
        if rc == -4:
            raise ValueError(
                "graph node count exceeds the native GCN packer's "
                "21-bit id field; set \"native_pack\": false")
        if rc < 0:
            raise ValueError(f"GCN COO capacity overflow (caps {caps})")
        targets = np.zeros((num_tasks, caps.graphs), np.float32)
        t_mask = np.zeros_like(targets)
        targets[:, :len(batch_ids)] = corpus.targets[batch_ids].T
        t_mask[:, :len(batch_ids)] = corpus.target_mask[batch_ids].T
        return GCNGraphBatch(
            node_features=init, node_graph_ids=node_graph_ids,
            edge_sources=edge_sources, edge_targets=edge_targets,
            edge_weights=edge_weights,
            targets=targets, target_mask=t_mask,
            num_graphs=np.int32(len(batch_ids)),
            num_nodes=np.int32(node_count))

    yield from _map_ordered(assemble, compositions, workers)

"""Graph preprocessing and static-shape batch packing (numpy).

A copy of the sparse, dense and GCN halves of `ggnn_tpu/data/packing.py`;
its batches are bit-identical to that packer's. Sparse packing reproduces
the reference's node-budget super-graph packing
(chem_tensorflow_sparse.py:278-350):
graphs are appended while `node_offset + n < node_budget` (strict <),
with vertex ids offset per component. Static capacities (per-type edge
caps, the combined-lane cap, the graph-count cap) end a batch early in
the rare case the padded capacity would overflow.

Backward edges of untied weights land in type `num_fwd_edge_types + e`
(the reference's chem_tensorflow_sparse.py:271 computed an out-of-range
type there; the fix is kept).

Dense packing reproduces the bucketed padding scheme
(chem_tensorflow_dense.py:132-228), including, behind `drop_remainder`,
the reference's silent dropping of each bucket's remainder graphs
(floor division at chem_tensorflow_dense.py:160).

GCN packing stores the normalised adjacency D^-1/2 (A+I) D^-1/2 of each
graph (chem_tensorflow_gcn.py:116-142, float64 math, +1e-7 on the
D^-1/2 diagonal, edge types discarded) as a row-major, so target-sorted,
weighted COO list packed under the sparse node budget (`gcn`), or as a
dense [1, V, V] block per bucket for `pack_dense_batches` (`gcn_blocked`).

The blocked-ELL layout branch of the JAX packer is not ported.
"""

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ggnn_tpu_torch.data.ell import ELLOverflowError, build_ell_layout
from ggnn_tpu_torch.graph import (DenseGraphBatch, ELLGraphBatch,
                                  GCNGraphBatch, GraphBatch)
from ggnn_tpu_torch.utils.padding import pad_to, round_up

DENSE_BUCKET_SIZES = np.array(list(range(4, 28, 2)) + [29])

DEFAULT_PACK_MARGIN = 1.05


@dataclasses.dataclass(frozen=True)
class PackCapacities:
    nodes: int
    edges_per_type: int
    graphs: int
    # Type-COMBINED edge-lane capacity (sum across types). Bond types are
    # skewed (~75% single bonds), so one combined lane holds far fewer
    # padded slots than per-type lanes sized to the worst type.
    # 0 = combined layout not planned.
    edges_all: int = 0


# --------------------------------------------------------------------
# Shared label handling
# --------------------------------------------------------------------

def _extract_labels(raw_graph, task_ids) -> List[Optional[float]]:
    return [raw_graph["targets"][task_id][0] for task_id in task_ids]


def _apply_task_sample_ratios(processed: List[dict], task_ids,
                              task_sample_ratios: Dict) -> None:
    """Blank labels past the sampled prefix
    (chem_tensorflow_sparse.py:243-250)."""
    for internal_id, task_id in enumerate(task_ids):
        ratio = task_sample_ratios.get(str(task_id))
        if ratio is not None:
            ex_to_sample = int(len(processed) * ratio)
            for ex_id in range(ex_to_sample, len(processed)):
                processed[ex_id]["labels"][internal_id] = None


def _labels_to_values_and_mask(labels) -> (List[float], List[float]):
    values, mask = [], []
    for v in labels:
        if v is None:
            values.append(0.0)
            mask.append(0.0)
        else:
            values.append(float(v))
            mask.append(1.0)
    return values, mask


# --------------------------------------------------------------------
# Sparse (typed edge list) preprocessing + packing
# --------------------------------------------------------------------

def graph_to_adjacency_lists(edges, num_edge_types: int, tie_fwd_bkwd: bool):
    """Typed adjacency lists + per-type in-degree counts for one graph.

    Mirrors chem_tensorflow_sparse.py:254-276: types become 0-based, tied
    backward edges are appended to the same type, lists are sorted for
    determinism.
    """
    adj_lists: Dict[int, list] = {}
    in_deg: Dict[int, Dict[int, int]] = {}
    num_fwd = num_edge_types if tie_fwd_bkwd else num_edge_types // 2

    def add(etype, src, dst):
        adj_lists.setdefault(etype, []).append((src, dst))
        in_deg.setdefault(etype, {}).setdefault(dst, 0)
        in_deg[etype][dst] += 1

    for src, e, dst in edges:
        if not 1 <= e <= num_fwd:
            # A 0-based or oversized raw type would negative-index-wrap
            # into the LAST type's lanes: reject it loudly.
            raise ValueError(
                f"edge type {e} out of range [1, {num_fwd}]")
        fwd_type = e - 1
        add(fwd_type, src, dst)
        if tie_fwd_bkwd:
            add(fwd_type, dst, src)
        else:
            add(num_fwd + fwd_type, dst, src)

    final = {e: np.array(sorted(lm), dtype=np.int32)
             for e, lm in adj_lists.items()}
    return final, in_deg


def _validate_vertex_ids(edges, num_nodes: int) -> None:
    """Both bounds, loudly: a negative id would numpy-wrap into the last
    node's row and an oversized one into the previous packed graph's."""
    for src, _e, dst in edges:
        if not (0 <= src < num_nodes and 0 <= dst < num_nodes):
            raise ValueError(
                f"edge vertex id out of range [0, {num_nodes}): "
                f"({src}, ., {dst})")


def preprocess_sparse(raw_data: Sequence[Any], num_edge_types: int,
                      tie_fwd_bkwd: bool, task_ids: Sequence[int],
                      task_sample_ratios: Dict, is_training: bool,
                      rng: Optional[np.random.RandomState] = None
                      ) -> List[dict]:
    processed = []
    for d in raw_data:
        n = len(d["node_features"])
        _validate_vertex_ids(d["graph"], n)
        adj_lists, in_deg_dicts = graph_to_adjacency_lists(
            d["graph"], num_edge_types, tie_fwd_bkwd
        )
        in_degrees = np.zeros((n, num_edge_types), dtype=np.float32)
        for e_type, counts in in_deg_dicts.items():
            for node_id, cnt in counts.items():
                in_degrees[node_id, e_type] = cnt
        processed.append({
            "adjacency_lists": adj_lists,
            "in_degrees": in_degrees,
            "init": np.asarray(d["node_features"], dtype=np.float32),
            "labels": _extract_labels(d, task_ids),
        })
    if is_training:
        if rng is not None:
            rng.shuffle(processed)
        _apply_task_sample_ratios(processed, task_ids, task_sample_ratios)
    return processed


def _graph_edge_counts(g, num_edge_types: int) -> np.ndarray:
    counts = np.zeros(num_edge_types, dtype=np.int64)
    for e, lst in g["adjacency_lists"].items():
        counts[e] = len(lst)
    return counts


def plan_capacities(processed: Sequence[dict], num_edge_types: int,
                    node_budget: int,
                    margin: float = None) -> PackCapacities:
    """Derive padded capacities from one packing pass over the corpus.

    The margin absorbs shuffle-to-shuffle variation in batch composition;
    `pack_sparse_batches` enforces the caps regardless (a batch closes
    early rather than overflowing), so they are safe bounds. Packing the
    same unshuffled order the planner walked never binds the caps.
    """
    return plan_capacities_from_walk(
        ((len(g["init"]), _graph_edge_counts(g, num_edge_types))
         for g in processed),
        num_edge_types, node_budget, margin)


def plan_capacities_from_walk(sizes, num_edge_types: int, node_budget: int,
                              margin: float = None) -> PackCapacities:
    """The batch-composition walk: `sizes` yields (n_nodes, per-type
    edge-count vector) per graph in pack order."""
    if margin is None:
        margin = DEFAULT_PACK_MARGIN
    max_graphs = 1
    max_all = 0
    max_edges = np.zeros(num_edge_types, dtype=np.int64)
    cur_nodes, cur_graphs = 0, 0
    cur_edges = np.zeros(num_edge_types, dtype=np.int64)
    for n, edge_counts in sizes:
        if n >= node_budget:
            # Fail at plan time with the remedy: the packer's fit check
            # is strict <, so this graph can never be packed.
            raise ValueError(
                f"graph with {n} nodes cannot fit the node budget "
                f"{node_budget} (the packer's fit check is strict '<', "
                f"chem_tensorflow_sparse.py:289 semantics); raise "
                f"\"batch_size\" past {n}")
        if cur_nodes + n >= node_budget and cur_graphs > 0:
            max_graphs = max(max_graphs, cur_graphs)
            max_edges = np.maximum(max_edges, cur_edges)
            max_all = max(max_all, cur_edges.sum())
            cur_nodes, cur_graphs = 0, 0
            cur_edges = np.zeros(num_edge_types, dtype=np.int64)
        cur_nodes += n
        cur_graphs += 1
        cur_edges += edge_counts
    max_graphs = max(max_graphs, cur_graphs)
    max_edges = np.maximum(max_edges, cur_edges)
    max_all = max(max_all, cur_edges.sum())
    return PackCapacities(
        nodes=round_up(node_budget, 8),
        edges_per_type=round_up(int(np.ceil(max_edges.max() * margin)), 8),
        graphs=round_up(int(np.ceil(max_graphs * margin)), 8),
        edges_all=round_up(int(np.ceil(max_all * margin)), 8),
    )


def build_combined_lane(edge_sources, edge_targets, edge_mask,
                        edges_all_cap: int, node_capacity: int) -> Dict:
    """Type-combined (target, type)-sorted edge lane from per-type
    lanes. Returns {} when not planned (edges_all_cap falsy); RAISES on
    overflow — the packer pre-enforces the cap in fits(), so overflow
    here is a caller bug, and a batch without the lane would change the
    batch structure mid-stream."""
    if not edges_all_cap:
        return {}
    t_dim = edge_sources.shape[0]
    srcs, tgts, typs = [], [], []
    for t in range(t_dim):
        real = edge_mask[t] > 0
        srcs.append(edge_sources[t][real])
        tgts.append(edge_targets[t][real])
        typs.append(np.full(int(real.sum()), t, np.int32))
    src = np.concatenate(srcs)
    tgt = np.concatenate(tgts)
    typ = np.concatenate(typs)
    if len(src) > edges_all_cap:
        raise ValueError(
            f"combined edge lane overflow ({len(src)} > {edges_all_cap}): "
            "the packer's fits() check must enforce caps.edges_all "
            "before building the lane")
    order = np.lexsort((typ, tgt))
    ea = edges_all_cap
    out_src = np.zeros(ea, np.int32)
    out_tgt = np.full(ea, node_capacity, np.int32)
    out_typ = np.zeros(ea, np.int32)
    out_mask = np.zeros(ea, np.float32)
    m = len(order)
    out_src[:m] = src[order]
    out_tgt[:m] = tgt[order]
    out_typ[:m] = typ[order]
    out_mask[:m] = 1.0
    return {"edge_sources_all": out_src, "edge_types_all": out_typ,
            "edge_targets_all": out_tgt, "edge_mask_all": out_mask}


def ell_graph_batch(fields: Dict[str, Any], node_capacity: int,
                    ell_block: int, ell_k: Optional[int]) -> ELLGraphBatch:
    """The packed batch `fields` (a GraphBatch's) with the blocked-ELL
    layouts of its per-type lanes. An `ell_k` that one of its blocks
    overflows raises: a stream must not turn into plain GraphBatches
    midway, since its consumers were built for one batch class."""
    try:
        layout = build_ell_layout(
            fields["edge_sources"], fields["edge_targets"],
            fields["edge_mask"], node_capacity, ell_block, ell_k)
    except ELLOverflowError as e:
        raise ValueError(
            f"blocked-ELL layout overflow (ell_k={ell_k}, "
            f"block={ell_block}) — replan ell_k over this epoch "
            "or disable the ELL layout") from e
    return ELLGraphBatch(
        **fields, ell_fwd_src=layout.fwd_src, ell_fwd_tgt=layout.fwd_tgt,
        ell_bwd_tgt=layout.bwd_tgt, ell_bwd_src=layout.bwd_src)


def pack_sparse_batches(processed: List[dict], num_edge_types: int,
                        node_budget: int, caps: PackCapacities,
                        hidden_size: int, annotation_size: int,
                        is_training: bool,
                        rng: Optional[np.random.RandomState] = None,
                        ell_block: int = 0,
                        ell_k: Optional[int] = None
                        ) -> Iterator[GraphBatch]:
    """Pack graphs into padded disconnected super-graph batches.

    With `ell_block > 0` every batch also carries the blocked-ELL
    layouts of its edges (an ELLGraphBatch, `ell_graph_batch`); `ell_k`
    fixes the slots a (type, block) across batches, one shape for every
    batch. When None it is sized per batch (tests only)."""
    if is_training and rng is not None:
        # Shuffle a COPY: the caller's order must survive for replay.
        processed = list(processed)
        rng.shuffle(processed)
    if not processed:
        return  # empty split packs to zero batches
    num_tasks = len(processed[0]["labels"])
    idx = 0
    while idx < len(processed):
        feats, graph_ids, in_degs = [], [], []
        adj = [[] for _ in range(num_edge_types)]
        values, masks = [], []
        node_offset, graphs_in_batch = 0, 0
        edge_counts = np.zeros(num_edge_types, dtype=np.int64)

        while idx < len(processed):
            g = processed[idx]
            n = len(g["init"])
            g_edges = _graph_edge_counts(g, num_edge_types)
            fits = (
                node_offset + n < node_budget
                and graphs_in_batch + 1 <= caps.graphs
                and np.all(edge_counts + g_edges <= caps.edges_per_type)
                and (not caps.edges_all
                     or edge_counts.sum() + g_edges.sum() <= caps.edges_all)
            )
            if not fits:
                if graphs_in_batch == 0:
                    raise ValueError(
                        f"graph with {n} nodes / {g_edges.max()} edges "
                        f"exceeds pack capacities {caps}"
                    )
                break
            feats.append(np.pad(g["init"],
                                ((0, 0), (0, hidden_size - annotation_size))))
            graph_ids.append(np.full(n, graphs_in_batch, dtype=np.int32))
            in_degs.append(g["in_degrees"])
            for e in range(num_edge_types):
                if e in g["adjacency_lists"]:
                    adj[e].append(g["adjacency_lists"][e] + node_offset)
            v, m = _labels_to_values_and_mask(g["labels"])
            values.append(v)
            masks.append(m)
            idx += 1
            graphs_in_batch += 1
            node_offset += n
            edge_counts += g_edges

        # Assemble padded numpy leaves.
        node_features = pad_to(
            np.concatenate(feats, axis=0).astype(np.float32), caps.nodes)
        node_graph_ids = pad_to(np.concatenate(graph_ids), caps.nodes,
                                fill=caps.graphs)
        in_degrees = pad_to(
            np.concatenate(in_degs, axis=0).astype(np.float32), caps.nodes)
        e_cap = caps.edges_per_type
        edge_sources = np.zeros((num_edge_types, e_cap), dtype=np.int32)
        edge_targets = np.full((num_edge_types, e_cap), caps.nodes,
                               dtype=np.int32)
        edge_mask = np.zeros((num_edge_types, e_cap), dtype=np.float32)
        for e in range(num_edge_types):
            if adj[e]:
                lst = np.concatenate(adj[e], axis=0)
                # Sort by (target, source); the dump-slot padding
                # (target = caps.nodes, the largest id) keeps the whole
                # lane target-sorted.
                lst = lst[np.lexsort((lst[:, 0], lst[:, 1]))]
                k = len(lst)
                edge_sources[e, :k] = lst[:, 0]
                edge_targets[e, :k] = lst[:, 1]
                edge_mask[e, :k] = 1.0
        targets = pad_to(np.asarray(values, dtype=np.float32).T.reshape(
            num_tasks, graphs_in_batch), caps.graphs, axis=1)
        target_mask = pad_to(np.asarray(masks, dtype=np.float32).T.reshape(
            num_tasks, graphs_in_batch), caps.graphs, axis=1)

        fields = dict(
            node_features=node_features,
            node_graph_ids=node_graph_ids,
            edge_sources=edge_sources,
            edge_targets=edge_targets,
            edge_mask=edge_mask,
            in_degrees=in_degrees,
            targets=targets,
            target_mask=target_mask,
            num_graphs=np.int32(graphs_in_batch),
            num_nodes=np.int32(node_offset),
            **build_combined_lane(edge_sources, edge_targets, edge_mask,
                                  caps.edges_all, caps.nodes),
        )
        if ell_block:
            yield ell_graph_batch(fields, caps.nodes, ell_block, ell_k)
        else:
            yield GraphBatch(**fields)


# --------------------------------------------------------------------
# Dense (bucketed adjacency) preprocessing + packing
# --------------------------------------------------------------------

def build_dense_adjacency(edges, max_n_vertices: int, num_edge_types: int,
                          tie_fwd_bkwd: bool = True) -> np.ndarray:
    """Per-edge-type dense adjacency [T, V, V] with amat[t, dst, src] = 1.

    Mirrors chem_tensorflow_dense.py:30-36: tied backward edges land in
    the same type slice, untied ones in slice `t + num_edge_types // 2`.
    """
    bwd_offset = 0 if tie_fwd_bkwd else num_edge_types // 2
    num_fwd = num_edge_types if tie_fwd_bkwd else num_edge_types // 2
    amat = np.zeros((num_edge_types, max_n_vertices, max_n_vertices),
                    dtype=np.float32)
    for src, e, dst in edges:
        if not 1 <= e <= num_fwd:
            raise ValueError(
                f"edge type {e} out of range [1, {num_fwd}]")
        if src < 0 or dst < 0:
            # A negative id would numpy-wrap to the last vertex row.
            raise ValueError(
                f"edge vertex id out of range [0, {max_n_vertices}): "
                f"({src}, ., {dst})")
        amat[e - 1, dst, src] = 1
        amat[e - 1 + bwd_offset, src, dst] = 1
    return amat


def preprocess_dense(raw_data: Sequence[Any], num_edge_types: int,
                     tie_fwd_bkwd: bool, task_ids: Sequence[int],
                     task_sample_ratios: Dict, is_training: bool,
                     rng: Optional[np.random.RandomState] = None,
                     bucket_sizes: Optional[np.ndarray] = None):
    """Bucket graphs by vertex count and densify (dense.py:132-164).
    Returns ({bucket index: [graph dict]}, bucket_sizes); each graph
    keeps its corpus index as "graph_id", so a consumer can scatter
    outputs back to request order."""
    return _bucket_graphs(
        raw_data, task_ids, task_sample_ratios, is_training, rng,
        bucket_sizes, lambda edges, v, n_active: build_dense_adjacency(
            edges, v, num_edge_types, tie_fwd_bkwd))


def _bucket_graphs(raw_data, task_ids, task_sample_ratios, is_training,
                   rng, bucket_sizes, adjacency):
    """The dense family's bucketing: each graph into the smallest bucket
    that holds it, its adjacency block `adjacency(edges, V, n_active)`,
    features and node mask padded to the bucket's V."""
    if bucket_sizes is None:
        bucket_sizes = DENSE_BUCKET_SIZES
    bucketed: Dict[int, List[dict]] = {}
    if not raw_data:
        return bucketed, bucket_sizes  # empty split packs to nothing
    x_dim = len(raw_data[0]["node_features"][0])
    for graph_id, d in enumerate(raw_data):
        max_vertex = max((v for e in d["graph"] for v in (e[0], e[2])),
                         default=-1)
        n_active = len(d["node_features"])
        if max_vertex >= n_active:
            # An edge naming a vertex without a feature row is corrupt
            # input (the TF1 reference padded such phantoms silently).
            raise ValueError(
                f"graph {graph_id}: edge vertex id {max_vertex} >= "
                f"number of node-feature rows {n_active}")
        _validate_vertex_ids(d["graph"], n_active)
        # Bucket by the rows actually written too: trailing isolated
        # nodes must fit.
        needed = max(max_vertex + 1, n_active)
        if needed > int(bucket_sizes[-1]):
            raise ValueError(
                f"graph with {needed} vertices exceeds the largest "
                f"bucket ({int(bucket_sizes[-1])})")
        chosen_bucket_idx = int(np.argmax(bucket_sizes >= needed))
        chosen_bucket_size = int(bucket_sizes[chosen_bucket_idx])
        init = np.zeros((chosen_bucket_size, x_dim), dtype=np.float32)
        init[:n_active] = np.asarray(d["node_features"], dtype=np.float32)
        mask = np.zeros(chosen_bucket_size, dtype=np.float32)
        mask[:n_active] = 1.0
        bucketed.setdefault(chosen_bucket_idx, []).append({
            "adj_mat": adjacency(d["graph"], chosen_bucket_size, n_active),
            "init": init,
            "labels": _extract_labels(d, task_ids),
            "mask": mask,
            "graph_id": graph_id,
        })
    if is_training:
        for bucket in bucketed.values():
            if rng is not None:
                rng.shuffle(bucket)
            # Reference quirk kept: the ratio applies PER BUCKET
            # (chem_tensorflow_dense.py:154-157), not corpus-wide.
            _apply_task_sample_ratios(bucket, task_ids, task_sample_ratios)
    return bucketed, bucket_sizes


def pack_dense_batches(bucketed: Dict[int, List[dict]],
                       bucket_sizes: np.ndarray, batch_size: int,
                       hidden_size: int, annotation_size: int,
                       is_training: bool,
                       rng: Optional[np.random.RandomState] = None,
                       drop_remainder: bool = True
                       ) -> Iterator[DenseGraphBatch]:
    """Fixed-size batches drawn bucket-wise.

    `drop_remainder=True` reproduces the reference's floor-division
    schedule (chem_tensorflow_dense.py:160-162), which drops each
    bucket's remainder graphs every epoch, in training and validation.
    With False every graph is processed (the last batch of a bucket is
    zero-padded to `batch_size`, so shapes stay fixed).
    """
    if drop_remainder:
        bucket_at_step = [b for b, data in bucketed.items()
                          for _ in range(len(data) // batch_size)]
    else:
        bucket_at_step = [b for b, data in bucketed.items()
                          for _ in range(-(-len(data) // batch_size))]
    if is_training and rng is not None:
        rng.shuffle(bucket_at_step)
        # Copies, not in-place: epoch shuffles must not compose.
        bucketed = {b: list(data) for b, data in bucketed.items()}
        for data in bucketed.values():
            rng.shuffle(data)

    if not bucketed:
        return  # empty split packs to zero batches
    num_tasks = len(next(iter(bucketed.values()))[0]["labels"])
    counters: Dict[int, int] = {}
    for bucket in bucket_at_step:
        start = counters.get(bucket, 0) * batch_size
        counters[bucket] = counters.get(bucket, 0) + 1
        elements = bucketed[bucket][start:start + batch_size]
        v = int(bucket_sizes[bucket])

        init = np.zeros((batch_size, v, hidden_size), dtype=np.float32)
        adjacency = np.zeros(
            (batch_size, elements[0]["adj_mat"].shape[0], v, v),
            dtype=np.float32)
        node_mask = np.zeros((batch_size, v), dtype=np.float32)
        values = np.zeros((num_tasks, batch_size), dtype=np.float32)
        t_mask = np.zeros((num_tasks, batch_size), dtype=np.float32)
        for i, el in enumerate(elements):
            init[i, :, :annotation_size] = el["init"]
            adjacency[i] = el["adj_mat"]
            node_mask[i] = el["mask"]
            vals, msk = _labels_to_values_and_mask(el["labels"])
            values[:, i] = vals
            t_mask[:, i] = msk

        yield DenseGraphBatch(
            node_features=init,
            adjacency=adjacency,
            node_mask=node_mask,
            targets=values,
            target_mask=t_mask,
            num_graphs=np.int32(len(elements)),
        )


# --------------------------------------------------------------------
# GCN (normalised single-type COO) preprocessing + packing
# --------------------------------------------------------------------

def _normalized_dense_adjacency(edges, num_nodes: int) -> np.ndarray:
    """Symmetrised, self-looped, D^-1/2 (A+I) D^-1/2-normalised dense
    [num_nodes, num_nodes] float64 matrix, chem_tensorflow_gcn.py:116-142
    exactly, the +1e-7 on the D^-1/2 diagonal included. Edge types are
    discarded."""
    adj = np.zeros((num_nodes, num_nodes))
    for src, _, dst in edges:
        adj[src, dst] = 1
        adj[dst, src] = 1
    adj += np.eye(num_nodes)
    row_sum = np.sum(adj, axis=-1)
    d_inv_sqrt = np.diag(np.power(row_sum, -0.5).flatten() + 1e-7)
    return d_inv_sqrt.dot(adj).dot(d_inv_sqrt)


def normalized_adjacency_block(edges, v: int, n_active: int) -> np.ndarray:
    """[1, v, v] float32 block of a graph's normalised adjacency (the
    `gcn_blocked` batches' adjacency): padding rows and columns are zero,
    so padded vertices neither send nor receive."""
    adj = np.zeros((1, v, v), dtype=np.float32)
    adj[0, :n_active, :n_active] = _normalized_dense_adjacency(edges,
                                                               n_active)
    return adj


def graph_to_normalized_adjacency(edges, num_nodes: int):
    """(coo [K, 2] int32 of (target, source), weights [K] float32): the
    normalised adjacency's non-zeros in row-major order, the reference's
    i/j loop order, so the list is sorted by target."""
    _validate_vertex_ids(edges, num_nodes)
    adj = _normalized_dense_adjacency(edges, num_nodes)
    idx = np.nonzero(adj)
    order = np.lexsort((idx[1], idx[0]))
    coo = np.stack([idx[0][order], idx[1][order]], axis=1).astype(np.int32)
    weights = adj[idx][order].astype(np.float32)
    return coo, weights


def preprocess_gcn(raw_data: Sequence[Any], task_ids: Sequence[int],
                   task_sample_ratios: Dict, is_training: bool,
                   rng: Optional[np.random.RandomState] = None) -> List[dict]:
    processed = []
    for d in raw_data:
        coo, weights = graph_to_normalized_adjacency(
            d["graph"], len(d["node_features"]))
        processed.append({
            "adjacency_list": coo,
            "adjacency_weights": weights,
            "init": np.asarray(d["node_features"], dtype=np.float32),
            "labels": _extract_labels(d, task_ids),
        })
    if is_training:
        if rng is not None:
            rng.shuffle(processed)
        _apply_task_sample_ratios(processed, task_ids, task_sample_ratios)
    return processed


def preprocess_gcn_dense(raw_data: Sequence[Any], task_ids: Sequence[int],
                         task_sample_ratios: Dict, is_training: bool,
                         rng: Optional[np.random.RandomState] = None,
                         bucket_sizes: Optional[np.ndarray] = None):
    """Bucket graphs with their normalised adjacency as a dense [1, V, V]
    float block (one "type", so `pack_dense_batches` packs them), for the
    `gcn_blocked` variant; the per-bucket task-ratio quirk of
    `preprocess_dense` is kept."""
    return _bucket_graphs(raw_data, task_ids, task_sample_ratios,
                          is_training, rng, bucket_sizes,
                          normalized_adjacency_block)


def plan_gcn_capacities_from_walk(walk, node_budget: int,
                                  margin: float = None) -> PackCapacities:
    """The batch-composition walk over (num_nodes, coo_rows) per graph
    in pack order."""
    if margin is None:
        margin = DEFAULT_PACK_MARGIN
    max_graphs, max_edges = 1, 0
    cur_nodes, cur_graphs, cur_edges = 0, 0, 0
    for n, e in walk:
        if n >= node_budget:
            raise ValueError(
                f"graph with {n} nodes cannot fit the node budget "
                f"{node_budget} (strict '<' fit check); raise "
                f"\"batch_size\" past {n}")
        if cur_nodes + n >= node_budget and cur_graphs > 0:
            max_graphs = max(max_graphs, cur_graphs)
            max_edges = max(max_edges, cur_edges)
            cur_nodes, cur_graphs, cur_edges = 0, 0, 0
        cur_nodes += n
        cur_graphs += 1
        cur_edges += e
    max_graphs = max(max_graphs, cur_graphs)
    max_edges = max(max_edges, cur_edges)
    return PackCapacities(
        nodes=round_up(node_budget, 8),
        edges_per_type=round_up(int(np.ceil(max_edges * margin)), 8),
        graphs=round_up(int(np.ceil(max_graphs * margin)), 8),
    )


def plan_gcn_capacities(processed: Sequence[dict], node_budget: int,
                        margin: float = None) -> PackCapacities:
    return plan_gcn_capacities_from_walk(
        ((len(g["init"]), len(g["adjacency_list"])) for g in processed),
        node_budget, margin)


def pack_gcn_batches(processed: List[dict], node_budget: int,
                     caps: PackCapacities, hidden_size: int,
                     annotation_size: int, is_training: bool,
                     rng: Optional[np.random.RandomState] = None
                     ) -> Iterator[GCNGraphBatch]:
    """Pack graphs' normalised COO lists into padded super-graph batches
    under the sparse node budget; `caps.edges_per_type` is the COO
    capacity."""
    if is_training and rng is not None:
        processed = list(processed)  # copy: epoch shuffles must not compose
        rng.shuffle(processed)
    if not processed:
        return  # empty split packs to zero batches
    num_tasks = len(processed[0]["labels"])
    idx = 0
    while idx < len(processed):
        feats, graph_ids, coos, weights, values, masks = [], [], [], [], [], []
        node_offset, graphs_in_batch, edge_count = 0, 0, 0
        while idx < len(processed):
            g = processed[idx]
            n = len(g["init"])
            fits = (
                node_offset + n < node_budget
                and graphs_in_batch + 1 <= caps.graphs
                and edge_count + len(g["adjacency_list"]) <= caps.edges_per_type
            )
            if not fits:
                if graphs_in_batch == 0:
                    raise ValueError(f"graph exceeds pack capacities {caps}")
                break
            feats.append(np.pad(g["init"],
                                ((0, 0), (0, hidden_size - annotation_size))))
            graph_ids.append(np.full(n, graphs_in_batch, dtype=np.int32))
            coos.append(g["adjacency_list"] + node_offset)
            weights.append(g["adjacency_weights"])
            v, m = _labels_to_values_and_mask(g["labels"])
            values.append(v)
            masks.append(m)
            idx += 1
            graphs_in_batch += 1
            node_offset += n
            edge_count += len(g["adjacency_list"])

        coo = np.concatenate(coos, axis=0)
        k = len(coo)
        e_cap = caps.edges_per_type
        edge_sources = np.zeros(e_cap, dtype=np.int32)
        edge_targets = np.full(e_cap, caps.nodes, dtype=np.int32)
        edge_weights = np.zeros(e_cap, dtype=np.float32)
        # The reference's SparseTensor is [target_row, source_col]
        # (chem_tensorflow_gcn.py:64-69 computes A @ H over row-major
        # COO): column 0 is the message's target, column 1 its source.
        edge_targets[:k] = coo[:, 0]
        edge_sources[:k] = coo[:, 1]
        edge_weights[:k] = np.concatenate(weights)

        yield GCNGraphBatch(
            node_features=pad_to(
                np.concatenate(feats, axis=0).astype(np.float32), caps.nodes),
            node_graph_ids=pad_to(np.concatenate(graph_ids), caps.nodes,
                                  fill=caps.graphs),
            edge_sources=edge_sources,
            edge_targets=edge_targets,
            edge_weights=edge_weights,
            targets=pad_to(np.asarray(values, dtype=np.float32).T.reshape(
                num_tasks, graphs_in_batch), caps.graphs, axis=1),
            target_mask=pad_to(np.asarray(masks, dtype=np.float32).T.reshape(
                num_tasks, graphs_in_batch), caps.graphs, axis=1),
            num_graphs=np.int32(graphs_in_batch),
            num_nodes=np.int32(node_offset),
        )

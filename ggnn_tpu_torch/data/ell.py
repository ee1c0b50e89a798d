"""Host-side blocked-ELL edge layouts (numpy), a copy of
`ggnn_tpu/data/ell.py` without its pytree registration.

For each edge type, edges are grouped by the node *block* (BN rows) of
their key node — target for the forward aggregation, source for the
transpose — and packed into fixed KE slots per (type, block). Padded
slots carry gather index 0 (any valid row) and key index NP (out of
every block's range). `ops/kernels/ell_spmm.py:ell_aggregate_by_type`
takes the forward layout and, for its gradient, the backward one.
The packers (`data/packing.py`, `data/native_pack.py`) attach both to
each batch as an `ELLGraphBatch` when given `ell_block`.
"""

import dataclasses
import logging

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ELLLayout:
    """fwd_*: target-block-major (forward aggregation);
    bwd_*: source-block-major (gradient transpose). All [T, NB, KE]."""

    fwd_src: np.ndarray   # gather indices (edge sources), pad -> 0
    fwd_tgt: np.ndarray   # key indices (absolute targets), pad -> NP
    bwd_tgt: np.ndarray   # gather indices (edge targets), pad -> 0
    bwd_src: np.ndarray   # key indices (absolute sources), pad -> NP

    @property
    def ell_k(self) -> int:
        return self.fwd_src.shape[2]


def padded_node_count(node_capacity: int, block_nodes: int) -> int:
    return -(-node_capacity // block_nodes) * block_nodes


def plan_ell_k(edge_targets, edge_mask, block_nodes: int,
               edge_sources=None) -> int:
    """Max edges per (type, node-block), rounded up to 8. With
    `edge_sources` the plan covers both the target-block-major forward
    and the source-block-major backward packing."""
    ke = 1
    for keys in ([edge_targets] if edge_sources is None
                 else [edge_targets, edge_sources]):
        for t in range(keys.shape[0]):
            real = keys[t][edge_mask[t] > 0]
            if len(real):
                counts = np.bincount(real // block_nodes)
                ke = max(ke, int(counts.max()))
    return -(-ke // 8) * 8


class ELLOverflowError(ValueError):
    """A batch's per-(type, node-block) edge count exceeds the planned
    ell_k: the only error `try_build_ell_layout` swallows."""


def _pack_one(key_idx, other_idx, nb_count, ell_k, np_total):
    """(key, other) edge lists -> block-major [NB, KE] arrays."""
    key_out = np.full((nb_count, ell_k), np_total, dtype=np.int32)
    gather = np.zeros((nb_count, ell_k), dtype=np.int32)
    if len(key_idx) == 0:
        return gather, key_out
    order = np.argsort(key_idx, kind="stable")
    key_idx, other_idx = key_idx[order], other_idx[order]
    blocks = key_idx // (np_total // nb_count)
    # slot within block = rank among equal-block entries (blocks sorted)
    first = np.searchsorted(blocks, blocks, side="left")
    slots = np.arange(len(blocks)) - first
    if slots.max() >= ell_k:
        raise ELLOverflowError(
            f"ELL overflow: block needs {slots.max() + 1} slots > "
            f"ell_k={ell_k}")
    key_out[blocks, slots] = key_idx
    gather[blocks, slots] = other_idx
    return gather, key_out


def build_ell_layout(edge_sources, edge_targets, edge_mask,
                     node_capacity: int, block_nodes: int,
                     ell_k=None) -> ELLLayout:
    """Blocked-ELL layouts for one packed batch's per-type lanes.

    `ell_k` can be passed from a corpus-wide plan; it must be >= this
    batch's per-block maximum."""
    edge_sources = np.asarray(edge_sources)
    edge_targets = np.asarray(edge_targets)
    edge_mask = np.asarray(edge_mask)
    np_total = padded_node_count(node_capacity, block_nodes)
    nb_count = np_total // block_nodes
    if ell_k is None:
        ell_k = plan_ell_k(edge_targets, edge_mask, block_nodes,
                           edge_sources=edge_sources)
    t_dim = edge_sources.shape[0]
    fwd_src = np.zeros((t_dim, nb_count, ell_k), dtype=np.int32)
    fwd_tgt = np.full((t_dim, nb_count, ell_k), np_total, dtype=np.int32)
    bwd_tgt = np.zeros((t_dim, nb_count, ell_k), dtype=np.int32)
    bwd_src = np.full((t_dim, nb_count, ell_k), np_total, dtype=np.int32)
    for t in range(t_dim):
        real = edge_mask[t] > 0
        src, tgt = edge_sources[t][real], edge_targets[t][real]
        fwd_src[t], fwd_tgt[t] = _pack_one(tgt, src, nb_count, ell_k,
                                           np_total)
        bwd_tgt[t], bwd_src[t] = _pack_one(src, tgt, nb_count, ell_k,
                                           np_total)
    return ELLLayout(fwd_src=fwd_src, fwd_tgt=fwd_tgt,
                     bwd_tgt=bwd_tgt, bwd_src=bwd_src)


def try_build_ell_layout(edge_sources, edge_targets, edge_mask,
                         node_capacity: int, block_nodes: int, ell_k):
    """`build_ell_layout`, or None where a batch overflows the planned
    `ell_k` (a shuffle that puts more edges in a block than the plan
    saw). Only `ELLOverflowError` is swallowed, with a warning: a
    mis-shaped input or any other error propagates. The packers call
    `build_ell_layout` and raise a ValueError that names the remedy
    instead, so a stream never changes its batch class midway."""
    try:
        return build_ell_layout(edge_sources, edge_targets, edge_mask,
                                node_capacity, block_nodes, ell_k)
    except ELLOverflowError as e:
        # The JAX package's words, so a log reads the same from either.
        logger.warning(
            "ELL layout overflow (%s); falling back to the XLA path for "
            "this batch", e)
        return None

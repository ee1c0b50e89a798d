"""Locality-aware vertex renumbering for giant graphs (pre-pack): the
port of `ggnn_tpu/data/reorder.py`, bit-equal to it.

Contiguous-range node sharding (parallel/node_shard.py) cuts an edge
whenever its endpoints land in different ranges, and the per-step
boundary all_to_all ships exactly the cut's source rows — so the node
NUMBERING controls the comm volume. Molecular batches need nothing
(components are packed contiguously; cut ≈ 0), but a giant packed graph
arrives in whatever order its producer emitted.

`dfs_reorder` relabels vertices in depth-first PREORDER (low-degree
seeds, children visited in degree order): each subtree becomes one
contiguous index range, so tree-like structure stops crossing range
boundaries. Measured on the synthetic giant graph (400 nodes, 8
shards): cut 525 → 274 at 50% random long-range extra edges, 385 → 77
at 10% (BFS/Cuthill–McKee ordering was tried first and only managed
~10% — BFS levels interleave subtrees, exactly what range cuts punish).
Long-range edges that no ordering can localize (expander-like
structure) are the irreducible remainder.

Pure relabeling: the model is invariant to vertex order (message
passing is permutation-equivariant and the readout pools per graph) —
pinned by tests/test_packing.py for the JAX package and by
tests/test_torch_parallel_layout.py for this copy. Cost is one
O(V + E) host pass per graph, once at preprocess time.
"""

from collections import defaultdict
from typing import Any, Dict


def dfs_reorder(graph: Dict[str, Any]) -> Dict[str, Any]:
    """Relabel one reference-schema graph dict in DFS preorder.

    Returns a new dict (same schema: targets / graph / node_features)
    whose vertices are numbered depth-first from the lowest-degree seed
    of each connected component.
    """
    n = len(graph["node_features"])
    # Validate BEFORE building anything: the Runner applies the reorder
    # ahead of the packers' input validation, and a negative id would
    # python-wrap through perm[-1] into a VALID new id — laundering a
    # corrupt edge past every downstream check (round-5 review).
    from ggnn_tpu_torch.data.packing import _validate_vertex_ids
    _validate_vertex_ids(graph["graph"], n)
    adj = defaultdict(set)
    for src, _, dst in graph["graph"]:
        if src != dst:
            adj[src].add(dst)
            adj[dst].add(src)
    degree = [len(adj[v]) for v in range(n)]
    perm = [-1] * n  # old id -> new id
    seen = [False] * n
    nxt = 0
    for seed in sorted(range(n), key=lambda v: (degree[v], v)):
        if seen[seed]:
            continue
        stack = [seed]
        seen[seed] = True
        while stack:
            v = stack.pop()
            perm[v] = nxt
            nxt += 1
            # reverse degree order on the stack -> lowest-degree child
            # explored (and numbered) first
            for w in sorted(adj[v], key=lambda u: (degree[u], u),
                            reverse=True):
                if not seen[w]:
                    seen[w] = True
                    stack.append(w)
    inverse = [0] * n
    for old, new in enumerate(perm):
        inverse[new] = old
    return {
        "targets": graph["targets"],
        "graph": [[perm[src], ty, perm[dst]]
                  for src, ty, dst in graph["graph"]],
        "node_features": [graph["node_features"][inverse[new]]
                          for new in range(n)],
    }

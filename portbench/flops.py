"""Operations and bytes of the work a window ran, counted from shapes.

The yardstick of the per-layer metrics `mfu.*` and `agg_roofline.*`:

  * FLOPs count the products (2 per multiply-add) the models' equations
    need, forward, and twice that again for the backward of a training
    step. The sparse model is counted over real atoms and bonds; its
    messages as the cheaper of the two forms that give the same sums,
    the published per-edge product h[src] @ W[type] (2 E H^2 a step) or
    the per-(target, type) sums transformed once (2 N T H^2 a step), so
    that no route is credited with work it chose to add. The dense one
    is counted over its batches' shapes (its published algorithm
    multiplies the padded [V, V] adjacency). Elementwise work, the
    segment sums and the optimizer are not products and are not counted.
  * Aggregation bytes count what the sparse model's per-(target, type)
    sums and their transposes must move, read and written once each:
    source rows, indices and offsets, output rows (the formula of the
    port's kernel table: 4 (rows read x H + edges + segments + 1 +
    segments x H) bytes a call).

`dense_forward_flops` is the FLOP count of the dense GGNN's forward as
the port's bring-up smoke test counts it (message products and cell
products), with the edge bias's and the readout's products added, frozen
here with its peak.
"""

from typing import Dict

import numpy as np

# NVIDIA's data sheet, H100 SXM, 700 W: f32 outside the tensor cores
# (TF32 off), and HBM3 bandwidth.
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
FLOAT_BYTES = 4


def gru_flops(rows: int, d_in: int, hidden: int) -> int:
    """The GRU's products: [x, h] @ Wg ([d_in + H, 2H]) and [x, r h] @ Wc
    ([d_in + H, H])."""
    return 2 * rows * (d_in + hidden) * 3 * hidden


def cell_flops(cell: str, rows: int, d_in: int, hidden: int) -> int:
    """A GRU's products, or a plain RNN cell's: [x, h] @ W ([d_in + H,
    H])."""
    if cell.lower() == "rnn":
        return 2 * rows * (d_in + hidden) * hidden
    return gru_flops(rows, d_in, hidden)


def readout_flops(rows: int, hidden: int) -> int:
    """[h, x] @ Wg ([2H, 1]) and h @ Wt ([H, 1]) a node."""
    return 2 * rows * 3 * hidden


def sparse_forward_flops(model: Dict, hidden: int, edge_types: int,
                         atoms: int, edges: int) -> int:
    """One forward of the sparse GGNN over `atoms` real atoms and `edges`
    directed bonds: per step the messages (the cheaper of 2 E H^2 and
    2 N T H^2), the edge bias's [N, T] x [T, H] where the model has one,
    and the cell, whose input is the layer's residual states and the
    messages; the readout once."""
    total = 0
    residuals = model["residual_connections"]
    cell = model["graph_rnn_cell"]
    messages = min(2 * edges * hidden * hidden,
                   2 * atoms * edge_types * hidden * hidden)
    bias = (2 * atoms * edge_types * hidden
            if model["use_edge_bias"] else 0)
    for i, steps in enumerate(model["layer_timesteps"]):
        d_in = hidden * (1 + len(residuals.get(str(i), [])))
        total += steps * (messages + bias
                          + cell_flops(cell, atoms, d_in, hidden))
    return total + readout_flops(atoms, hidden)


def dense_forward_flops(batch: int, vertices: int, edge_types: int,
                        hidden: int, steps: int) -> int:
    """One forward of the dense GGNN over a [B, T, V, V] batch: per step
    the bmm with the adjacency (2 B V T V H) and the [B V, T H] x [T H,
    H] transform, and the cell; the edge bias (in-degrees [B V, T] x
    [T, H]) once, and the readout."""
    rows = batch * vertices
    messages = steps * (2 * batch * vertices * edge_types * vertices * hidden
                        + 2 * rows * edge_types * hidden * hidden)
    cells = steps * gru_flops(rows, hidden, hidden)
    return (messages + cells + 2 * rows * edge_types * hidden
            + readout_flops(rows, hidden))


def step_flops(forward: int, train: bool) -> int:
    """A training step is its forward and a backward of twice the
    forward's products."""
    return 3 * forward if train else forward


def aggregation_bytes(atoms: int, edges: int, segments_used: int,
                      calls: int, edge_types: int, hidden: int) -> Dict:
    """Bytes of one forward aggregation (B1) and one of its transposes
    (B2) in each of `calls` packed batches holding `atoms` atoms, `edges`
    directed bonds and `segments_used` distinct (target, type) pairs with
    a bond in all. B1 reads every source row once (every atom has a
    bond), the edges' source indices and the offsets of the atoms x T
    segments (one more a call), and writes atoms x T rows; B2 reads the
    used segments' rows, the edges' indices and the atoms' offsets (one
    more a call), and writes the atoms' rows."""
    segments = atoms * edge_types
    b1 = FLOAT_BYTES * (atoms * hidden + edges + segments + calls
                        + segments * hidden)
    b2 = FLOAT_BYTES * (segments_used * hidden + edges + atoms + calls
                        + atoms * hidden)
    return {"forward": b1, "transpose": b2}


def molecule_stats(num_atoms: np.ndarray, edges: np.ndarray,
                   bonds: np.ndarray,
                   edge_types: int) -> Dict[str, np.ndarray]:
    """Per molecule: atoms, directed edges and distinct (target, type)
    pairs with an incoming bond (both directions of every bond)."""
    graph = np.repeat(np.arange(len(num_atoms)), bonds)
    node_off = np.concatenate([[0], np.cumsum(num_atoms)])[:-1]
    tgt = np.concatenate([edges[:, 2], edges[:, 0]]) + np.tile(
        node_off[graph], 2)
    typ = np.concatenate([edges[:, 1], edges[:, 1]]) - 1
    pairs = np.unique(tgt * edge_types + typ)
    node_graph = np.repeat(np.arange(len(num_atoms)), num_atoms)
    used = np.bincount(node_graph[pairs // edge_types],
                       minlength=len(num_atoms))
    return {"atoms": num_atoms.astype(np.int64),
            "edges": 2 * bonds.astype(np.int64),
            "segments_used": used.astype(np.int64)}

"""Node-sharded edge partitioning with boundary exchange: the port of
`ggnn_tpu/parallel/node_shard.py`, its numpy layout code copied (that
module imports JAX) and its exchange on `torch.distributed`.

  * the packed batch's NODES are split into contiguous ranges, one per
    rank of the mesh's edge axis (graphs are packed contiguously, so a
    molecular batch's cut is near zero, while a deliberately split
    giant graph gets a proportional one);
  * each EDGE lives on the shard that owns its TARGET node, so every
    segment reduction, the attention's softmax included, is local;
  * per propagation step each shard sends exactly the boundary source
    rows its peers' edges read (`send_idx`) in one exchange;
  * each shard's edges are split into a LOCAL-source lane and a
    BOUNDARY-source lane, both type-combined and sorted by the composite
    key target*T + type (the pads, at Nl*T, sort last), so each lane is
    one launch of the segment-sum kernel (B1) over a CSR layout;
  * the per-graph readout pools partial sums (a graph may span shards)
    that one [K, G] sum over the edge axis completes.

Index spaces (per shard): the local lane's `loc_src` are local rows
[0, Nl); the boundary lane's `bnd_src` index the received boundary
table. Both lanes' targets are local rows with dump slot Nl.

The exchange (`exchange_boundary`) has three layouts, JAX's:

  * "alltoall": send_idx [S, S, B], every ordered pair padded to the
    worst pair; one `all_to_all_single` of equal splits;
  * "shift": a tuple of [S, B_k], one per ring shift k, each padded to
    that shift's worst pair; one P2P send/receive pair a shift;
  * "ragged": a `RaggedSendSpec` moving the true per-pair sizes, its
    routing rows int32 tensors on the device. On an nccl axis on cards
    one hand-written ragged all-to-all through peer memory
    (`collectives.ragged_exchange`, csrc/ragged_exchange.cu), which
    reads the sizes on the card, so a captured step replays every batch
    of its stack shape; on gloo (the CPU, or ranks sharing a card, whose
    steps run eagerly) one `all_to_all_single` whose split sizes are
    read on the host. The choice is the backend's, never a fallback.
    "ragged_emulated", JAX's all_gather stand-in for backends without a
    ragged collective, lays out the same and runs the same transport.

The backward of each is the reverse transfer (parallel/collectives.py).
Host side, these functions build [S, ...] arrays for every shard,
bit-equal to JAX's; a rank computes on `local_view(shard)`.
"""

import dataclasses
from typing import Iterable, List

import numpy as np
import torch

from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.ops.segment import sorted_gather
from ggnn_tpu_torch.parallel import collectives
from ggnn_tpu_torch.utils.padding import round_up

_RAGGED_DATA_FIELDS = ("gather", "input_offsets", "send_sizes",
                       "output_offsets", "recv_sizes")


def _to(value, device):
    if isinstance(value, tuple):
        return tuple(_to(v, device) for v in value)
    if isinstance(value, RaggedSendSpec):
        return _int32_rows(dataclasses.replace(value, **{
            f: _to(getattr(value, f), device) for f in _RAGGED_DATA_FIELDS}))
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.from_numpy(np.ascontiguousarray(value)).to(device)


def _int32_rows(spec: "RaggedSendSpec") -> "RaggedSendSpec":
    """`spec` with its routing rows int32 tensors: the host layout's
    `recv_sizes` are int64, as JAX's are, and a captured step's input
    buffers keep the host dtype, so the cast runs on the device, in the
    step."""
    return dataclasses.replace(spec, **{
        f: getattr(spec, f).to(torch.int32) for f in _RAGGED_DATA_FIELDS
        if getattr(spec, f).dtype != torch.int32})


def _shard_of(value, s: int):
    """Shard s's slice of a [S, ...] leaf, of a shift tuple of them or of
    a RaggedSendSpec of them."""
    if isinstance(value, tuple):
        return tuple(x[s] for x in value)
    if isinstance(value, RaggedSendSpec):
        return dataclasses.replace(
            value, **{f: np.asarray(getattr(value, f))[s]
                      for f in _RAGGED_DATA_FIELDS})
    return np.asarray(value)[s]


@dataclasses.dataclass(frozen=True)
class RaggedSendSpec:
    """Transport layout for `exchange="ragged"`: one all-to-all sized by
    the TRUE per-pair cut — no padding on the wire.

      gather          [S, SEND_CAP]  local rows packed dest-major
      input_offsets   [S, S]         row s: slice starts into s's pack
      send_sizes      [S, S]         row s: true rows s sends to d
      output_offsets  [S, S]         row s: where s's slice lands on d
                                     (owner-major on the receiver)
      recv_sizes      [S, S]         row s: true rows s receives from o

    `recv_cap` sizes the receiver table `bnd_src` indexes. `emulate`
    records that the layout was asked for as "ragged_emulated" (JAX
    runs that one through an all_gather; here both run the same
    transport). A shard's view drops the leading axis (rows [S] and
    [SEND_CAP]); its device copy holds them as int32 tensors, which no
    graph key and no host read on an nccl mesh's path looks into."""

    gather: object
    input_offsets: object
    send_sizes: object
    output_offsets: object
    recv_sizes: object
    recv_cap: int = 8
    emulate: bool = False


_SHARDED_FIELDS = ("node_features", "node_graph_ids", "in_degrees",
                   "loc_src", "loc_type", "loc_tgt", "loc_mask",
                   "bnd_src", "bnd_type", "bnd_tgt", "bnd_mask",
                   "send_idx")
_GCN_SHARDED_FIELDS = ("node_features", "node_graph_ids",
                       "loc_src", "loc_tgt", "loc_w",
                       "bnd_src", "bnd_tgt", "bnd_w", "send_idx")


class _Sharded:
    """`local_view(s)` (shard s's leaves, the shard axis dropped) and
    `to(device)` (torch tensors, the ragged routing rows too; the scalars
    python ints) of a node-sharded batch."""

    @property
    def graph_capacity(self) -> int:
        return self.targets.shape[1]

    @property
    def local_node_capacity(self) -> int:
        return self.node_features.shape[-2]

    def local_view(self, shard: int):
        return dataclasses.replace(self, **{
            f: _shard_of(getattr(self, f), shard)
            for f in self.SHARDED_FIELDS})

    def to(self, device):
        moved = {}
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if field.name in ("num_graphs", "num_nodes"):
                moved[field.name] = int(value)
            else:
                moved[field.name] = _to(value, device)
        return type(self)(**moved)


@dataclasses.dataclass(frozen=True)
class NodeShardedGraphBatch(_Sharded):
    """A GraphBatch re-laid-out for S node shards. Leaves marked [S, ...]
    carry a leading shard axis (dropped by `local_view`); the rest are
    every shard's.

      node_features  [S, Nl, H]
      node_graph_ids [S, Nl]        padding -> G (dump graph)
      in_degrees     [S, Nl, T]
      loc_src        [S, EL]        local source rows, padding -> 0
      loc_type       [S, EL]        edge type, padding -> 0
      loc_tgt        [S, EL]        local target rows, padding -> Nl
      loc_mask       [S, EL]
      bnd_src        [S, EB]        boundary-table rows
      bnd_type       [S, EB]
      bnd_tgt        [S, EB]        local target rows, padding -> Nl
      bnd_mask       [S, EB]
      send_idx       [S, S, B]      rows THIS shard sends to each dest
                                    (or the shift / ragged layouts)
      targets        [K, G]
      target_mask    [K, G]
      num_graphs     []
      num_nodes      []
    """

    node_features: object
    node_graph_ids: object
    in_degrees: object
    loc_src: object
    loc_type: object
    loc_tgt: object
    loc_mask: object
    bnd_src: object
    bnd_type: object
    bnd_tgt: object
    bnd_mask: object
    send_idx: object
    targets: object
    target_mask: object
    num_graphs: object
    num_nodes: object

    SHARDED_FIELDS = _SHARDED_FIELDS


@dataclasses.dataclass(frozen=True)
class NodeShardCaps:
    """Static capacities of a node-sharded layout.

    `boundary` sizes the dense all_to_all layout (every ordered pair
    padded to the worst pair). `boundary_shifts[k-1]` sizes shift k of
    the shift-bucketed layout (`exchange="shift"`): one P2P pair per
    ring shift, each padded only to that shift's worst pair — wire cost
    then tracks the actual cut distribution. `boundary_send_total` /
    `boundary_recv_total` size the `exchange="ragged"` pack/table
    buffers (max TOTAL rows any shard sends / receives): the
    ragged-all-to-all transport moves exactly the true per-pair sizes —
    zero wire padding — with the routing offsets as per-batch data."""
    n_shards: int
    nodes_local: int      # Nl
    edges_local: int      # EL (per shard, all types combined)
    edges_boundary: int   # EB (per shard, all types combined)
    boundary: int         # B (per ordered shard pair, all_to_all mode)
    boundary_shifts: tuple = ()  # B_k per ring shift (shift mode)
    boundary_send_total: int = 8  # SEND_CAP (ragged mode)
    boundary_recv_total: int = 8  # receive-table rows (ragged mode)


def _shard_ranges(node_capacity: int, n_shards: int) -> int:
    """Local node capacity: contiguous ranges of ceil(N/S) rows."""
    return -(-node_capacity // n_shards)


def _flatten_edges(batch: GraphBatch):
    """Real edges of a packed batch as flat (src, tgt, type) arrays."""
    src = np.asarray(batch.edge_sources)
    tgt = np.asarray(batch.edge_targets)
    real = np.asarray(batch.edge_mask) > 0
    t_dim = src.shape[0]
    counts = [int(real[t].sum()) for t in range(t_dim)]
    f_src = np.concatenate([src[t][real[t]] for t in range(t_dim)]
                           or [np.zeros(0, src.dtype)])
    f_tgt = np.concatenate([tgt[t][real[t]] for t in range(t_dim)]
                           or [np.zeros(0, tgt.dtype)])
    f_ty = np.concatenate([np.full(counts[t], t, np.int32)
                           for t in range(t_dim)]
                          or [np.zeros(0, np.int32)])
    return f_src, f_tgt, f_ty, t_dim


def _plan_caps(edge_lists, node_caps, n_shards: int,
               margin: float, nodes_local: int = None) -> NodeShardCaps:
    """Shared cap counting over per-batch flattened (src, tgt) arrays.

    `nl` must be the max over ALL batches before any owner arithmetic,
    so the callers stream their batches once, retaining only the int
    edge arrays (not the padded feature tensors).

    `nodes_local` PINS the per-shard node range to an existing layout
    (floored by what the batches require): a replan over a SUBSET of
    batches must count edges under the same owner arithmetic as the
    active caps, or its counts are incomparable — a smaller derived nl
    spreads the same nodes over more shards and under-counts per-shard
    edges, making an overflow pre-check pass while the real shard
    relayout overflows (round-5 review finding)."""
    nl = max([8] + [_shard_ranges(nc, n_shards) for nc in node_caps])
    if nodes_local is not None:
        nl = max(nl, int(nodes_local))
    max_el, max_eb = 1, 0
    send_tot, recv_tot = 0, 0
    pair_max = np.zeros((n_shards, n_shards), np.int64)
    for f_src, f_tgt in edge_lists:
        if not len(f_src):
            continue
        owner_s, owner_d = f_src // nl, f_tgt // nl
        cut = owner_s != owner_d
        max_el = max(max_el, int(np.bincount(
            owner_d[~cut], minlength=n_shards).max()))
        if np.any(cut):
            max_eb = max(max_eb, int(np.bincount(
                owner_d[cut], minlength=n_shards).max()))
            # unique (owner, dest, src-row) triples per ordered pair
            uniq = np.unique(np.stack(
                [owner_s[cut], owner_d[cut], f_src[cut]], 1), axis=0)
            pair_ids = uniq[:, 0] * n_shards + uniq[:, 1]
            pm = np.bincount(pair_ids, minlength=n_shards * n_shards
                             ).reshape(n_shards, n_shards)
            pair_max = np.maximum(pair_max, pm)
            # Ragged-mode totals come from THIS batch's matrix (the
            # elementwise max over batches would over-size them).
            send_tot = max(send_tot, int(pm.sum(axis=1).max()))
            recv_tot = max(recv_tot, int(pm.sum(axis=0).max()))
    cap8 = lambda x: max(8, round_up(int(np.ceil(x * margin)), 8))
    shifts = tuple(
        cap8(max(int(pair_max[o, (o + k) % n_shards])
                 for o in range(n_shards)))
        for k in range(1, n_shards))
    return NodeShardCaps(
        n_shards=n_shards,
        nodes_local=nl,
        edges_local=round_up(int(np.ceil(max_el * margin)), 8),
        edges_boundary=max(8, round_up(int(np.ceil(max_eb * margin)), 8)),
        boundary=cap8(int(pair_max.max())),
        boundary_shifts=shifts,
        boundary_send_total=cap8(send_tot),
        boundary_recv_total=cap8(recv_tot),
    )


def plan_node_shard_caps(batches: Iterable[GraphBatch], n_shards: int,
                         margin: float = 1.3,
                         nodes_local: int = None) -> NodeShardCaps:
    """Walk (dry-pack) batches and size EL/EB/B for the epoch, with a
    shuffle margin (same policy as the packers' capacity planning).
    Streams the iterable, keeping only flattened int edge arrays — a
    full-corpus dry pack must not hold every padded batch in memory.
    Pass `nodes_local` when replanning against existing caps (see
    _plan_caps)."""
    edge_lists, node_caps = [], []
    for batch in batches:
        f_src, f_tgt, _, _ = _flatten_edges(batch)
        edge_lists.append((f_src, f_tgt))
        node_caps.append(batch.node_capacity)
    return _plan_caps(edge_lists, node_caps, n_shards, margin,
                      nodes_local=nodes_local)


def _build_pair_sends(owner_s, owner_d, local_rows):
    """Deduplicated boundary send lists per ordered shard pair, plus
    the (owner, dest, local_row) -> slot map the receiving side's
    boundary lane indexes with."""
    slot_of = {}  # (owner, dest, local_row) -> slot within the pair
    pair_rows = {}  # (owner, dest) -> [local rows, in slot order]
    cut = owner_s != owner_d
    for o, d, j in zip(owner_s[cut], owner_d[cut], local_rows[cut]):
        key = (int(o), int(d), int(j))
        if key not in slot_of:
            rows = pair_rows.setdefault((int(o), int(d)), [])
            slot_of[key] = len(rows)
            rows.append(int(j))
    return slot_of, pair_rows


def _materialize_sends(pair_rows, caps: NodeShardCaps, exchange: str):
    """Transport container for the pair send lists + the function
    mapping (owner, dest, slot) to a row of the receiver's boundary
    table.

    "alltoall": ONE dense collective, every pair padded to `boundary`;
    receiver table is owner-major [S*B]. "shift": one P2P pair per ring
    shift k, each padded to `boundary_shifts[k-1]`; receiver table is
    shift-major [sum B_k] (the sender at shift k is (dest - k) mod S).
    "ragged" / "ragged_emulated": one all-to-all moving the TRUE
    per-pair sizes; receiver table is owner-major at true offsets
    [boundary_recv_total].
    """
    s_count = caps.n_shards

    def _pair(o, d):
        return pair_rows.get((o, d), [])

    if exchange in ("ragged", "ragged_emulated"):
        send_cap = caps.boundary_send_total
        recv_cap = caps.boundary_recv_total
        size = np.zeros((s_count, s_count), np.int64)
        for (o, d), rows in pair_rows.items():
            size[o, d] = len(rows)
        for kind, totals, cap in (("send", size.sum(axis=1), send_cap),
                                  ("recv", size.sum(axis=0), recv_cap)):
            worst = int(totals.max()) if s_count else 0
            if worst > cap:
                raise ValueError(
                    f"boundary capacity overflow: ragged {kind} total "
                    f"needs {worst} > {cap} rows")
        gather = np.zeros((s_count, send_cap), np.int32)
        input_off = np.zeros((s_count, s_count), np.int32)
        for o in range(s_count):
            off = 0
            for d in range(s_count):
                rows = _pair(o, d)
                input_off[o, d] = off
                gather[o, off:off + len(rows)] = rows
                off += len(rows)
        # recv_off[d, o]: where owner o's slice starts on receiver d
        # (owner-major by TRUE sizes: column-wise prefix sums of size).
        recv_off = np.cumsum(
            np.concatenate([np.zeros((1, s_count), np.int64),
                            size[:-1]]), axis=0).T.astype(np.int32)
        spec = RaggedSendSpec(
            gather=gather,
            input_offsets=input_off,
            send_sizes=size.astype(np.int32),
            output_offsets=recv_off.T.copy(),   # [sender, dest]
            recv_sizes=size.T.copy(),           # [receiver, owner]
            recv_cap=recv_cap,
            emulate=(exchange == "ragged_emulated"),
        )
        table_row = lambda o, d, slot: int(recv_off[d, o]) + slot
        return spec, table_row
    if exchange == "alltoall":
        b_cap = caps.boundary
        send_idx = np.zeros((s_count, s_count, b_cap), np.int32)
        for (o, d), rows in pair_rows.items():
            if len(rows) > b_cap:
                raise ValueError(
                    f"boundary capacity overflow: pair ({o}->{d}) "
                    f"needs {len(rows)} > {b_cap} rows")
            send_idx[o, d, :len(rows)] = rows
        table_row = lambda o, d, slot: o * b_cap + slot
        return send_idx, table_row
    if exchange != "shift":
        raise ValueError(f"unknown boundary exchange '{exchange}'")
    shifts = caps.boundary_shifts
    send_parts = []
    for k in range(1, s_count):
        b_k = shifts[k - 1]
        part = np.zeros((s_count, b_k), np.int32)
        for o in range(s_count):
            rows = _pair(o, (o + k) % s_count)
            if len(rows) > b_k:
                raise ValueError(
                    f"boundary capacity overflow: shift {k} pair "
                    f"({o}->{(o + k) % s_count}) needs {len(rows)} > "
                    f"{b_k} rows")
            part[o, :len(rows)] = rows
        send_parts.append(part)
    prefix = np.concatenate([[0], np.cumsum(shifts)]).astype(np.int64)

    def table_row(o, d, slot):
        k = (d - o) % s_count
        return int(prefix[k - 1]) + slot

    return tuple(send_parts), table_row


def ragged_spec(pair_rows, n_shards: int, send_cap: int,
                recv_cap: int) -> RaggedSendSpec:
    """The ragged layout ([S, ...] numpy rows) of given send lists:
    `pair_rows` {(owner, dest): [owner's local rows, in slot order]}, the
    pack and table capacities `send_cap` and `recv_cap` (raises where a
    shard's total exceeds them), as `shard_batch` lays out a batch's."""
    caps = NodeShardCaps(n_shards=n_shards, nodes_local=8, edges_local=8,
                         edges_boundary=8, boundary=8,
                         boundary_send_total=send_cap,
                         boundary_recv_total=recv_cap)
    return _materialize_sends(pair_rows, caps, "ragged")[0]


def _shard_node_rows(arr: np.ndarray, s_count: int, nl: int, fill=0):
    """Split [N, ...] node-indexed rows into contiguous [S, Nl, ...]
    ranges, padding with `fill`."""
    out = np.full((s_count, nl) + arr.shape[1:], fill, arr.dtype)
    n_cap = arr.shape[0]
    for s in range(s_count):
        lo, hi = s * nl, min((s + 1) * nl, n_cap)
        if hi > lo:
            out[s, :hi - lo] = arr[lo:hi]
    return out


def _shard_edge_split(s: int, f_src, f_tgt, nl: int, table_row, slot_of,
                      caps_l: int, caps_b: int):
    """Shard s's incoming edges split by source owner.

    Returns (mine, local, loc_tgt, local_rows, boundary_rows): `mine`
    selects s's edges out of the flat arrays, `local` splits them,
    `loc_tgt` are local target rows for ALL of s's edges, `local_rows`
    local source rows, `boundary_rows` received-table rows (resolved
    through `slot_of` and the transport's `table_row`). Raises on lane
    overflow."""
    mine = (f_tgt // nl) == s
    src_m = f_src[mine]
    loc_tgt = (f_tgt[mine] % nl).astype(np.int32)
    local = (src_m // nl) == s
    for kind, count, cap in (("local", int(local.sum()), caps_l),
                             ("boundary", int((~local).sum()), caps_b)):
        if count > cap:
            raise ValueError(
                f"per-shard {kind} edge capacity overflow: shard {s}"
                f" holds {count} > {cap} edges")
    local_rows = (src_m % nl)[local].astype(np.int32)
    o = (src_m // nl)[~local]
    j = (src_m % nl)[~local]
    boundary_rows = np.array(
        [table_row(int(oo), s, slot_of[(int(oo), s, int(jj))])
         for oo, jj in zip(o, j)], np.int64).astype(np.int32)
    return mine, local, loc_tgt, local_rows, boundary_rows


def exchange_boundary(h, send_idx, axis, h_dim):
    """The per-step boundary transport of one shard's states `h` [Nl, H],
    dispatched on the layout (of `local_view`, on the device) over the
    mesh's edge `axis` (`parallel/mesh.py:Axis`; None for a one-shard
    layout, which has no cut edges). Returns the received table that the
    batch's `bnd_src` index."""
    if isinstance(send_idx, RaggedSendSpec):
        spec = send_idx
        if axis is None:
            return h.new_zeros((spec.recv_cap, h_dim))
        if axis.backend == "nccl":
            # The sizes stay on the card: a step captured once replays
            # every batch of its stack shape.
            return collectives.ragged_exchange(h, _int32_rows(spec), axis)
        # gloo: its all_to_all_single takes the split sizes on the host
        # (those steps run eagerly). The pack is dest-major from row 0
        # (input_offsets are the prefix sums of send_sizes), and the
        # received slices land owner-major from row 0 (output_offsets
        # likewise).
        send_sizes = [int(x) for x in spec.send_sizes.tolist()]
        recv_sizes = [int(x) for x in spec.recv_sizes.tolist()]
        operand = sorted_gather(h, spec.gather[:sum(send_sizes)].long())
        got = collectives.exchange(operand, axis, recv_sizes, send_sizes)
        pad = spec.recv_cap - got.shape[0]
        return torch.cat([got, got.new_zeros((pad, h_dim))])
    if isinstance(send_idx, tuple):
        parts = []
        for k, idx in enumerate(send_idx, start=1):
            sendk = h[idx]
            if axis is not None:
                sendk = collectives.ring_shift(sendk, axis, k)
            parts.append(sendk)
        if not parts:  # single-shard degenerate case
            return h.new_zeros((1, h_dim))
        return torch.cat(parts)
    s_count, b_cap = send_idx.shape
    send = h[send_idx.reshape(-1)]                    # [S*B, H]
    if axis is None:
        return send  # single-shard degenerate case
    return collectives.exchange(send, axis, [b_cap] * s_count,
                                [b_cap] * s_count)


def _check_node_capacity(batch, caps: NodeShardCaps):
    """The shard layout must cover every node row, or nodes/edges past
    S*nl would be silently dropped (zero-filled rows, vanished edges)
    and out-of-range owners would crash _materialize_sends with a raw
    numpy IndexError that bypasses the runner's ValueError-triggered
    capacity regrow (round-5 review findings)."""
    total = caps.n_shards * caps.nodes_local
    if batch.node_capacity > total:
        raise ValueError(
            f"batch node capacity {batch.node_capacity} exceeds the "
            f"shard layout {caps.n_shards} x {caps.nodes_local} = "
            f"{total} rows; replan the caps over this batch "
            f"(plan_node_shard_caps / plan_gcn_shard_caps)")


def shard_batch(batch: GraphBatch, caps: NodeShardCaps,
                exchange: str = "alltoall") -> NodeShardedGraphBatch:
    """Re-lay one packed GraphBatch into S node shards (host, numpy)."""
    _check_node_capacity(batch, caps)
    s_count = caps.n_shards
    nl = caps.nodes_local
    el_l, el_b = caps.edges_local, caps.edges_boundary
    g_cap = batch.graph_capacity

    # ---- local node arrays (contiguous ranges, zero/dump padded)
    nf = _shard_node_rows(np.asarray(batch.node_features), s_count, nl)
    ng = _shard_node_rows(np.asarray(batch.node_graph_ids), s_count, nl,
                          fill=g_cap)
    nd = _shard_node_rows(np.asarray(batch.in_degrees), s_count, nl)

    f_src, f_tgt, f_ty, t_dim = _flatten_edges(batch)
    slot_of, pair_rows = _build_pair_sends(f_src // nl, f_tgt // nl,
                                           f_src % nl)
    send_idx, table_row = _materialize_sends(pair_rows, caps, exchange)

    # ---- per-shard type-combined lanes, split local/boundary sources
    def _lane(cap):
        return (np.zeros((s_count, cap), np.int32),
                np.zeros((s_count, cap), np.int32),
                np.full((s_count, cap), nl, np.int32),
                np.zeros((s_count, cap), np.float32))

    l_src, l_ty, l_tgt, l_mask = _lane(el_l)
    b_src, b_ty, b_tgt, b_mask = _lane(el_b)
    for s in range(s_count):
        mine, local, loc_tgt, lrows, brows = _shard_edge_split(
            s, f_src, f_tgt, nl, table_row, slot_of, el_l, el_b)
        e_ty = f_ty[mine]

        def _fill(lane, sel, src_vals):
            dst_s, dst_t, dst_g, dst_m = lane
            tgt, ty = loc_tgt[sel], e_ty[sel]
            order = np.argsort(tgt * t_dim + ty, kind="stable")
            k = len(order)
            dst_s[s, :k] = src_vals[order]
            dst_t[s, :k] = ty[order]
            dst_g[s, :k] = tgt[order]
            dst_m[s, :k] = 1.0

        _fill((l_src, l_ty, l_tgt, l_mask), local, lrows)
        _fill((b_src, b_ty, b_tgt, b_mask), ~local, brows)

    return NodeShardedGraphBatch(
        node_features=nf, node_graph_ids=ng, in_degrees=nd,
        loc_src=l_src, loc_type=l_ty, loc_tgt=l_tgt, loc_mask=l_mask,
        bnd_src=b_src, bnd_type=b_ty, bnd_tgt=b_tgt, bnd_mask=b_mask,
        send_idx=send_idx,
        targets=np.asarray(batch.targets),
        target_mask=np.asarray(batch.target_mask),
        num_graphs=np.asarray(batch.num_graphs),
        num_nodes=np.asarray(batch.num_nodes),
    )


def _zeros_like_send(send_idx):
    if isinstance(send_idx, tuple):
        return tuple(np.zeros_like(np.asarray(x)) for x in send_idx)
    if isinstance(send_idx, RaggedSendSpec):
        # All sizes/offsets zero: a valid ragged exchange that moves
        # nothing and leaves the receive table zeros.
        return dataclasses.replace(
            send_idx, **{f: np.zeros_like(np.asarray(getattr(send_idx, f)))
                         for f in _RAGGED_DATA_FIELDS})
    return np.zeros_like(np.asarray(send_idx))


def empty_sharded_batch_like(b: NodeShardedGraphBatch
                             ) -> NodeShardedGraphBatch:
    """All-padding filler (loss/gradient no-op under the masked loss)."""
    nl = b.local_node_capacity
    return NodeShardedGraphBatch(
        node_features=np.zeros_like(np.asarray(b.node_features)),
        node_graph_ids=np.full_like(np.asarray(b.node_graph_ids),
                                    b.graph_capacity),
        in_degrees=np.zeros_like(np.asarray(b.in_degrees)),
        loc_src=np.zeros_like(np.asarray(b.loc_src)),
        loc_type=np.zeros_like(np.asarray(b.loc_type)),
        loc_tgt=np.full_like(np.asarray(b.loc_tgt), nl),
        loc_mask=np.zeros_like(np.asarray(b.loc_mask)),
        bnd_src=np.zeros_like(np.asarray(b.bnd_src)),
        bnd_type=np.zeros_like(np.asarray(b.bnd_type)),
        bnd_tgt=np.full_like(np.asarray(b.bnd_tgt), nl),
        bnd_mask=np.zeros_like(np.asarray(b.bnd_mask)),
        send_idx=_zeros_like_send(b.send_idx),
        targets=np.zeros_like(np.asarray(b.targets)),
        target_mask=np.zeros_like(np.asarray(b.target_mask)),
        num_graphs=np.int32(0),
        num_nodes=np.int32(0),
    )


def shard_and_stack(batches: List[GraphBatch], caps: NodeShardCaps,
                    n_data: int, exchange: str = "alltoall"
                    ) -> List[NodeShardedGraphBatch]:
    """`shard_batch` each, as a stack padded to a multiple of n_data with
    empty fillers."""
    if not batches:
        raise ValueError("shard_and_stack: empty batch group (an empty "
                         "corpus split packs to zero batches)")
    sharded = [shard_batch(b, caps, exchange) for b in batches]
    filler = empty_sharded_batch_like(sharded[0])
    return sharded + [filler] * (-len(sharded) % n_data)


# --------------------------------------------------------------------
# GCN (single-type weighted COO) node sharding
# --------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GCNNodeShardedBatch(_Sharded):
    """A GCNGraphBatch re-laid-out for S node shards: the design of
    NodeShardedGraphBatch with one edge type and a per-edge weight lane
    (the pre-normalised adjacency values, chem_tensorflow_gcn.py:
    116-142), 0.0 on padding. The lanes are target-sorted (the packer's
    row-major COO contract); each is one launch of the weighted instance
    of B1's body."""

    node_features: object   # [S, Nl, H]
    node_graph_ids: object  # [S, Nl]
    loc_src: object         # [S, EL] local rows, padding -> 0
    loc_tgt: object         # [S, EL] local rows, padding -> Nl
    loc_w: object           # [S, EL]
    bnd_src: object         # [S, EB] boundary-table rows
    bnd_tgt: object         # [S, EB] local rows, padding -> Nl
    bnd_w: object           # [S, EB]
    send_idx: object        # [S, S, B] (or the shift / ragged layouts)
    targets: object         # [K, G]
    target_mask: object     # [K, G]
    num_graphs: object
    num_nodes: object

    SHARDED_FIELDS = _GCN_SHARDED_FIELDS


def _flatten_gcn_edges(batch):
    """Real edges of a packed GCN batch (weights 0.0 mark padding)."""
    w = np.asarray(batch.edge_weights)
    real = w != 0.0
    return (np.asarray(batch.edge_sources)[real],
            np.asarray(batch.edge_targets)[real], w[real])


def plan_gcn_shard_caps(batches: Iterable, n_shards: int,
                        margin: float = 1.3,
                        nodes_local: int = None) -> NodeShardCaps:
    """Size EL/EB/B for an epoch of GCN batches (see
    plan_node_shard_caps; identical policy, single edge type)."""
    edge_lists, node_caps = [], []
    for batch in batches:
        f_src, f_tgt, _ = _flatten_gcn_edges(batch)
        edge_lists.append((f_src, f_tgt))
        node_caps.append(batch.node_capacity)
    return _plan_caps(edge_lists, node_caps, n_shards, margin,
                      nodes_local=nodes_local)


def shard_gcn_batch(batch, caps: NodeShardCaps,
                    exchange: str = "alltoall") -> GCNNodeShardedBatch:
    """Re-lay one packed GCNGraphBatch into S node shards."""
    _check_node_capacity(batch, caps)
    s_count = caps.n_shards
    nl = caps.nodes_local
    el_l, el_b = caps.edges_local, caps.edges_boundary

    nf = _shard_node_rows(np.asarray(batch.node_features), s_count, nl)
    ng = _shard_node_rows(np.asarray(batch.node_graph_ids), s_count, nl,
                          fill=batch.graph_capacity)

    f_src, f_tgt, f_w = _flatten_gcn_edges(batch)
    slot_of, pair_rows = _build_pair_sends(f_src // nl, f_tgt // nl,
                                           f_src % nl)
    send_idx, table_row = _materialize_sends(pair_rows, caps, exchange)

    def _lane(cap):
        return (np.zeros((s_count, cap), np.int32),
                np.full((s_count, cap), nl, np.int32),
                np.zeros((s_count, cap), np.float32))

    l_src, l_tgt, l_w = _lane(el_l)
    b_src, b_tgt, b_w = _lane(el_b)
    for s in range(s_count):
        mine, local, loc_tgt, lrows, brows = _shard_edge_split(
            s, f_src, f_tgt, nl, table_row, slot_of, el_l, el_b)
        e_w = f_w[mine]

        def _fill(dst_s, dst_t, dst_w, sel, src_vals):
            tgt = loc_tgt[sel]
            order = np.argsort(tgt, kind="stable")
            k = len(order)
            dst_s[s, :k] = src_vals[order]
            dst_t[s, :k] = tgt[order]
            dst_w[s, :k] = e_w[sel][order]

        _fill(l_src, l_tgt, l_w, local, lrows)
        _fill(b_src, b_tgt, b_w, ~local, brows)

    return GCNNodeShardedBatch(
        node_features=nf, node_graph_ids=ng,
        loc_src=l_src, loc_tgt=l_tgt, loc_w=l_w,
        bnd_src=b_src, bnd_tgt=b_tgt, bnd_w=b_w,
        send_idx=send_idx,
        targets=np.asarray(batch.targets),
        target_mask=np.asarray(batch.target_mask),
        num_graphs=np.asarray(batch.num_graphs),
        num_nodes=np.asarray(batch.num_nodes),
    )


def empty_gcn_sharded_like(b: GCNNodeShardedBatch) -> GCNNodeShardedBatch:
    nl = b.local_node_capacity
    return GCNNodeShardedBatch(
        node_features=np.zeros_like(np.asarray(b.node_features)),
        node_graph_ids=np.full_like(np.asarray(b.node_graph_ids),
                                    b.graph_capacity),
        loc_src=np.zeros_like(np.asarray(b.loc_src)),
        loc_tgt=np.full_like(np.asarray(b.loc_tgt), nl),
        loc_w=np.zeros_like(np.asarray(b.loc_w)),
        bnd_src=np.zeros_like(np.asarray(b.bnd_src)),
        bnd_tgt=np.full_like(np.asarray(b.bnd_tgt), nl),
        bnd_w=np.zeros_like(np.asarray(b.bnd_w)),
        send_idx=_zeros_like_send(b.send_idx),
        targets=np.zeros_like(np.asarray(b.targets)),
        target_mask=np.zeros_like(np.asarray(b.target_mask)),
        num_graphs=np.int32(0),
        num_nodes=np.int32(0),
    )


def gcn_shard_and_stack(batches: List, caps: NodeShardCaps,
                        n_data: int, exchange: str = "alltoall"
                        ) -> List[GCNNodeShardedBatch]:
    """`shard_gcn_batch` each, as a stack padded to a multiple of n_data
    with empty fillers."""
    if not batches:
        raise ValueError("gcn_shard_and_stack: empty batch group (an "
                         "empty corpus split packs to zero batches)")
    sharded = [shard_gcn_batch(b, caps, exchange) for b in batches]
    filler = empty_gcn_sharded_like(sharded[0])
    return sharded + [filler] * (-len(sharded) % n_data)


def table_rows(send_idx) -> int:
    """Rows of the received table `exchange_boundary` returns for a
    shard's layout (`local_view`): S*B, the shifts' sum (1 for one
    shard) or the ragged `recv_cap`."""
    if isinstance(send_idx, RaggedSendSpec):
        return send_idx.recv_cap
    if isinstance(send_idx, tuple):
        return sum(int(x.shape[0]) for x in send_idx) or 1
    return int(send_idx.shape[0]) * int(send_idx.shape[1])

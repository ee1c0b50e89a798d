"""Asynchronous GGNN: propagation along a depth-first schedule.

Port of `ggnn_tpu/models/async_ggnn.py` (chem_tensorflow_async.py:59-218).
Per round, a fresh state buffer is seeded with the round's initial nodes'
previous-round states; each substep gathers the senders' states from the
current buffer (the async property: messages see states already updated
in this round, async.py:183), transforms them per edge type, sums them
into the step's receivers, combines the sum with the receivers'
previous-round states in the shared RNN cell and writes the result back.
The weights are one [H, H] matrix (and an optional bias) per edge type,
shared by every round and step, and one cell (async.py:112-129).

Two paths, as in the JAX model:

  * the segmented path (training and validation, a batch with a segment
    plan): round states live in a compact slot buffer, and per substep
    the receivers' sums over the composite id target * T + type are one
    launch of the sorted-segment kernel B1 (`GatherSegmentSum`, its
    gradient B2) over the segment's (target, type)-sorted send lane,
    then one [RC, T*H] x [T*H, H] product. The per-(receiver, type)
    edge counts that the edge bias needs are the kernel's CSR offsets'
    differences, added as counts @ biases: JAX instead sums a ones
    column beside the rows and multiplies one augmented weight, which
    would put the kernel on its scalar path (H + 1 = 101 columns).
  * the plain path (serving, the per-round states of `return_all_rounds`,
    and batches whose segments overflowed): uniform [T, SE] lanes per
    substep, messages transformed per edge by one `torch.bmm`, then
    summed into the step's receivers by B1 over the lane's targets in
    stable sorted order (JAX: XLA's unsorted `segment_sum`).

Every CSR offset and transpose layout is made once per batch, before the
rounds. Remat (`async_remat`; unset: on when the estimate of the saved
activations passes a sixth of the device's free memory, taken at the
first forward) recomputes each substep's sum, product and cell in the
backward (`torch.utils.checkpoint`); the buffer is then updated out of
place, so that no later write changes what a recomputation reads.
Dropout masks come from an explicit `torch.Generator`, outside the
recomputed part, so remat changes no draw.
"""

from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ggnn_tpu_torch.graph import AsyncGraphBatch
from ggnn_tpu_torch.models import base
from ggnn_tpu_torch.ops.cells import make_cell
from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.ops.kernels.ell_spmm import GatherSegmentSum
from ggnn_tpu_torch.ops.segment import sorted_gather
from ggnn_tpu_torch.utils.init import glorot_init, zeros_init

# The remat limit where the device reports no free memory (the CPU).
_DEFAULT_REMAT_LIMIT = int(2.5 * 2**30)


def _row_offsets(sorted_keys: torch.Tensor, num_segments: int):
    """[..., num_segments + 1] int32 CSR offsets of each row of SORTED
    segment ids [..., E]; ids at or past num_segments lie past the
    last offset."""
    bounds = torch.arange(num_segments + 1, device=sorted_keys.device,
                          dtype=sorted_keys.dtype)
    bounds = bounds.expand(*sorted_keys.shape[:-1], num_segments + 1)
    return torch.searchsorted(sorted_keys.contiguous(),
                              bounds.contiguous()).to(torch.int32)


def _row_transposes(sources: torch.Tensor, gather_ids: torch.Tensor,
                    num_nodes: int):
    """(bgather, boff) of B2 for each row of [..., E] edges: the edges
    stably sorted by source, their gather ids in that order, and CSR
    offsets over the sources [..., num_nodes + 1]. Pads must carry source
    num_nodes, so that they sort past boff[num_nodes], and a valid gather
    id."""
    perm = torch.argsort(sources, dim=-1, stable=True)
    return (torch.gather(gather_ids, -1, perm).to(torch.int32).contiguous(),
            _row_offsets(torch.gather(sources, -1, perm), num_nodes))


def compact_dump_row(batch: AsyncGraphBatch) -> int:
    """M, the dump row of the segmented path's compact buffer [M + 1, H]:
    I + N + the widest segment's RC, as the packer lays the slots out
    (data/async_schedule.py, `_finalize_async_batch`, which takes 8 for
    an empty plan)."""
    max_rc = max((seg.old_compact.shape[1]
                  for segs in batch.seg_rounds for seg in segs), default=8)
    return batch.initial_nodes.shape[-1] + batch.node_capacity + max_rc


def segment_layouts(batch: AsyncGraphBatch, num_edge_types: int,
                    with_transpose: bool):
    """The segmented path's layouts, made once per batch: per round, per
    segment, (offsets [n, RC*T + 1] int32, bgather [n, SEA] int32, boff
    [n, M + 2] int32) of its n send lanes, the last two None without
    `with_transpose`. B1 sums substep k's lane over segment ids
    target * T + type with offsets[k]; B2 sums its gradient back into
    the buffer's M + 1 rows over (bgather[k], boff[k]). The pads (target
    RC) lie past offsets[k][RC*T], which matches JAX's [:RC] slice; in
    the transpose they take source M + 1 and gather id 0, so that they
    sort past boff[k][M + 1]."""
    rows = compact_dump_row(batch) + 1
    layouts = []
    for segs in batch.seg_rounds:
        round_layouts = []
        for seg in segs:
            rc_cap = seg.old_compact.shape[1]
            comp = seg.msg_target * num_edge_types + seg.msg_type
            offsets = _row_offsets(comp, rc_cap * num_edge_types)
            bgather = boff = None
            if with_transpose:
                real = seg.msg_target < rc_cap
                bgather, boff = _row_transposes(
                    torch.where(real, seg.send_compact, rows),
                    torch.where(real, comp, 0), rows)
            round_layouts.append((offsets, bgather, boff))
        layouts.append(round_layouts)
    return layouts


def plain_layouts(batch: AsyncGraphBatch, with_transpose: bool):
    """The plain path's layouts, made once per batch: (perm [R, S, T*SE]
    int32, offsets [R, S, RC + 1] int32, bgather, boff), the last two
    [R, S, T*SE] and [R, S, T*SE + 1] int32 or None without
    `with_transpose`. The message targets of a substep's lane are in
    edge order, not sorted (data/async_schedule.py); `perm` is their
    stable sort, so that B1 sums each receiver's messages (rows
    perm[r, s] of the substep's [T*SE, H] messages) in edge order, and
    the pads (target RC) last, past offsets[r, s][RC]."""
    num_rounds, num_steps, t_dim, se_cap = batch.msg_targets.shape
    rc_cap = batch.receiving_nodes.shape[-1]
    targets = batch.msg_targets.reshape(num_rounds, num_steps, t_dim * se_cap)
    perm = torch.argsort(targets, dim=-1, stable=True)
    sorted_targets = torch.gather(targets, -1, perm)
    bgather = boff = None
    if with_transpose:
        real = sorted_targets < rc_cap
        bgather, boff = _row_transposes(
            torch.where(real, perm, t_dim * se_cap),
            torch.where(real, sorted_targets, 0), t_dim * se_cap)
    return (perm.to(torch.int32), _row_offsets(sorted_targets, rc_cap),
            bgather, boff)


class AsyncGGNN(nn.Module):
    """`forward(batch)` -> final node states [N, H];
    `readout(heads, task_ids, last_h, batch)` -> predictions [K, G]."""

    def __init__(self, config: Dict, num_edge_types: int,
                 generator: torch.Generator):
        super().__init__()
        self.config = config
        self.num_edge_types = num_edge_types
        self.hidden_size = config["hidden_size"]
        self.propagation_rounds = config["propagation_rounds"]
        self.use_edge_bias = config["use_edge_bias"]
        self.state_keep_prob = config["graph_state_dropout_keep_prob"]
        cell_type = config["graph_rnn_cell"]
        if cell_type.lower() not in ("gru", "rnn"):
            raise ValueError(f"Unknown RNN cell type '{cell_type}'.")
        h = self.hidden_size
        # One [H, H] leaf per type, as the reference's per-type variables
        # (async.py:113-118): the per-leaf clip is then its
        # per-variable clip.
        self.edge_weights = nn.ParameterList(
            nn.Parameter(glorot_init(generator, (h, h)))
            for _ in range(num_edge_types))
        self.cell = make_cell(cell_type, config["graph_rnn_activation"],
                              self.state_keep_prob)(h, h, generator)
        if self.use_edge_bias:
            self.edge_biases = nn.ParameterList(
                nn.Parameter(zeros_init(generator, (h,)))
                for _ in range(num_edge_types))
        # The remat limit, taken at the first forward (after the caller
        # has allocated parameters and optimizer state) and kept, so the
        # policy is the same for every batch of a run.
        self._remat_limit = None

    def _get_remat_limit(self, device: torch.device) -> int:
        if self._remat_limit is None:
            limit = _DEFAULT_REMAT_LIMIT
            if device.type == "cuda":
                limit = torch.cuda.mem_get_info(device)[0] // 6
            self._remat_limit = limit
        return self._remat_limit

    def _stacked(self):
        """([T, H, H] weights, [T, H] biases or None)."""
        weights = torch.stack(list(self.edge_weights))
        biases = (torch.stack(list(self.edge_biases))
                  if self.use_edge_bias else None)
        return weights, biases

    def _check_generator(self, is_training, generator):
        if is_training and self.state_keep_prob < 1.0 and generator is None:
            raise ValueError(
                "state dropout requires a torch.Generator (is_training=True "
                "with graph_state_dropout_keep_prob < 1 and generator=None)")

    def _needs_grad(self) -> bool:
        return torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())

    def _dropout(self, new_h, is_training, generator):
        if is_training:
            return dropout(new_h, self.state_keep_prob, generator)
        return new_h

    def forward(self, batch: AsyncGraphBatch, is_training: bool = False,
                generator: torch.Generator = None,
                return_all_rounds: bool = False):
        """Final node representations [N, H], or with `return_all_rounds`
        the list of each round's [N, H] states (plain path). Training
        draws its dropout masks from `generator`."""
        self._check_generator(is_training, generator)
        if return_all_rounds:
            return self._forward_plain(batch, is_training, generator, True)
        if (batch.seg_rounds is not None
                and self.config.get("async_compact", True)):
            return self._forward_segmented(batch, is_training, generator)
        return self._forward_plain(batch, is_training, generator)

    # ------------------------------------------------------------ plain

    def _forward_plain(self, batch, is_training, generator,
                       return_all_rounds=False):
        weights, biases = self._stacked()
        n_cap = batch.node_capacity
        h_dim = self.hidden_size
        _, num_steps, t_dim, se_cap = batch.sending_nodes.shape
        rc_cap = batch.receiving_nodes.shape[-1]
        with_transpose = self._needs_grad()
        perm, offsets, bgather, boff = plain_layouts(batch, with_transpose)
        # A dump row at n_cap: padded initial and receiving slots read and
        # write it harmlessly.
        cur_ext = torch.cat([batch.node_features,
                             batch.node_features.new_zeros(1, h_dim)])
        round_states = []
        for r in range(self.propagation_rounds):
            init_ids = batch.initial_nodes[r]
            new_ext = torch.zeros_like(cur_ext).index_copy(
                0, init_ids.long(), sorted_gather(cur_ext, init_ids))
            for s in range(num_steps):
                sending = batch.sending_nodes[r, s].reshape(-1)
                msgs = torch.bmm(sorted_gather(new_ext, sending)
                                 .view(t_dim, se_cap, h_dim), weights)
                if biases is not None:
                    msgs = msgs + biases[:, None, :]
                transpose = ((bgather[r, s], boff[r, s]) if with_transpose
                             else (None, None))
                agg = GatherSegmentSum.apply(
                    msgs.reshape(t_dim * se_cap, h_dim), perm[r, s],
                    offsets[r, s], rc_cap, *transpose)
                receiving = batch.receiving_nodes[r, s]
                new_h = self.cell.step(agg,
                                       sorted_gather(cur_ext, receiving))
                new_h = self._dropout(new_h, is_training, generator)
                new_ext = new_ext.index_put((receiving.long(),), new_h)
            cur_ext = torch.cat([new_ext[:n_cap],
                                 new_ext.new_zeros(1, h_dim)])
            if return_all_rounds:
                round_states.append(cur_ext[:n_cap])
        if return_all_rounds:
            return round_states
        return cur_ext[:n_cap]

    # -------------------------------------------------------- segmented

    def _use_remat(self, batch, m_dump: int) -> bool:
        """`async_remat` when set; else whether the saved activations'
        estimate (the JAX model's: per substep the buffer, the send lane
        and the receivers' sums, product and cell) passes the limit."""
        remat = self.config.get("async_remat")
        if remat is not None:
            return bool(remat)
        h_dim, t_dim = self.hidden_size, self.num_edge_types
        saved_floats = sum(
            seg.old_compact.shape[0]
            * ((m_dump + 1) * h_dim
               + seg.send_compact.shape[1] * (h_dim + 2)
               + seg.old_compact.shape[1]
               * (t_dim * (h_dim + 1) + 4 * h_dim))
            for segs in batch.seg_rounds for seg in segs)
        return saved_floats * 4 > self._get_remat_limit(
            batch.node_features.device)

    def _substep(self, buf, prev_buf, send, offsets, counts, bgather, boff,
                 old_idx, w_flat, biases):
        """One substep's new receiver states before dropout [RC, H]: B1
        over the send lane, the per-type transform, the cell."""
        rc_cap = old_idx.shape[0]
        t_dim = self.num_edge_types
        agg = GatherSegmentSum.apply(buf, send, offsets, rc_cap * t_dim,
                                     bgather, boff)
        incoming = torch.matmul(agg.view(rc_cap, t_dim * self.hidden_size),
                                w_flat)
        if biases is not None:
            incoming = incoming + torch.matmul(counts, biases)
        return self.cell.step(incoming, sorted_gather(prev_buf, old_idx))

    def _forward_segmented(self, batch, is_training, generator):
        weights, biases = self._stacked()
        w_flat = weights.reshape(-1, self.hidden_size)   # [T*H, H]
        t_dim, h_dim = self.num_edge_types, self.hidden_size
        i_cap = batch.initial_nodes.shape[-1]
        m_dump = compact_dump_row(batch)
        needs_grad = self._needs_grad()
        remat = needs_grad and self._use_remat(batch, m_dump)
        layouts = segment_layouts(batch, t_dim, needs_grad)
        prev_buf = torch.cat([batch.node_features,
                              batch.node_features.new_zeros(1, h_dim)])
        for r in range(self.propagation_rounds):
            buf = torch.cat([sorted_gather(prev_buf, batch.init_prev[r]),
                             prev_buf.new_zeros(m_dump + 1 - i_cap, h_dim)])
            for seg, (offsets, bgather, boff) in zip(batch.seg_rounds[r],
                                                     layouts[r]):
                rc_cap = seg.old_compact.shape[1]
                # The edge bias's per-(receiver, type) edge counts: the
                # CSR offsets' differences.
                counts = (None if biases is None else
                          (offsets[:, 1:] - offsets[:, :-1]).to(
                              torch.float32).view(-1, rc_cap, t_dim))
                for k, base_k in enumerate(seg.recv_base):
                    args = (buf, prev_buf, seg.send_compact[k], offsets[k],
                            None if counts is None else counts[k],
                            None if bgather is None else bgather[k],
                            None if boff is None else boff[k],
                            seg.old_compact[k], w_flat, biases)
                    if remat:
                        new_h = checkpoint(self._substep, *args,
                                           use_reentrant=False,
                                           preserve_rng_state=False)
                    else:
                        new_h = self._substep(*args)
                    new_h = self._dropout(new_h, is_training, generator)
                    start = i_cap + base_k
                    if remat:
                        # Out of place: the checkpoint keeps `buf` to
                        # recompute from, and it must not change.
                        buf = torch.slice_scatter(buf, new_h, 0, start,
                                                  start + rc_cap)
                    else:
                        # In place: B1 keeps no input rows, and autograd's
                        # version counter guards every other saved tensor.
                        buf[start:start + rc_cap] = new_h
            prev_buf = torch.cat([buf[:m_dump], buf.new_zeros(1, h_dim)])
        return sorted_gather(prev_buf, batch.final_compact)

    def readout(self, heads: nn.ModuleDict, task_ids, last_h: torch.Tensor,
                batch: AsyncGraphBatch, *, keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """Gated segment-sum pooling [K, G] (chem_tensorflow_async.py's
        readout is the base model's, chem_tensorflow.py:133-170)."""
        return base.segment_readout(
            heads, task_ids, last_h, batch.node_features,
            batch.node_graph_ids, batch.graph_capacity, keep_prob=keep_prob,
            generator=generator)

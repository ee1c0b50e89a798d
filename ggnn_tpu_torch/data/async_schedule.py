"""Propagation schedules and batch packing for the async GGNN (numpy).

A copy of the flat pipeline of `ggnn_tpu/data/async_schedule.py`
(chem_tensorflow_async.py:232-470, re-designed for static shapes); its
batches are bit-identical to that packer's, leaf for leaf.

Schedule of one graph (async.py:293-335): for each of
`propagation_rounds / 2` round pairs, seed a depth-first traversal, give
each node the depth of its first visit, then split the edges into a
forward pass (towards greater depth; the receiver at depth d fires at
step d-1) and its mirror, the backward pass. Depth-first search gives
adjacent nodes of an undirected graph different depths, the property
the schedule needs.

Three latent reference bugs stay fixed, as in the JAX package:
  * seed selection (async.py:308) indexed a (node, count) tuple, so the
    second round pair seeded from a degree count; here round pair p
    seeds from the p-th node in ascending (count, node) order;
  * edge types (async.py:264-266, 301): raw 1-based bond types were
    used unshifted and filtered against range(num_edge_types), dropping
    the last type; here types are 0-based as in every other variant, and
    untied backward types land in `num_fwd + e`;
  * batch message-target offsets (async.py:399-401) were kept per edge
    type while the receiver numbering is shared; here all types of a
    (round, step) share the step's receiver offset.

Three packers, as in JAX, give the same batches bit for bit:
`pack_async_batches` takes the corpus-level `AsyncPackCache` when one
matching the corpus is passed (whole-batch gathers and scatters, no
per-graph Python), else the flat packer over each graph's flat schedule
tables, else (a corpus whose graphs lack matching flat tables: stripped,
or preprocessed under another config) the legacy per-graph loop packer
over the nested schedules rebuilt from whatever each graph carries.
"""

import dataclasses
import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ggnn_tpu_torch.data.packing import (DEFAULT_PACK_MARGIN,
                                         _apply_task_sample_ratios,
                                         _extract_labels,
                                         _labels_to_values_and_mask)
from ggnn_tpu_torch.graph import AsyncGraphBatch, AsyncSegment
from ggnn_tpu_torch.utils.padding import pad_to, round_up

@dataclasses.dataclass(frozen=True)
class AsyncCapacities:
    nodes: int
    graphs: int
    initial_nodes: int      # per round
    sending_edges: int      # per (round, step, type)
    receiving_nodes: int    # per (round, step)
    # Segment plan of the compact path (models/async_ggnn.py): per round,
    # a tuple of (step_lo, step_hi, sea_cap, rc_cap) segments whose
    # type-combined send lanes are sized to the steps they cover. None:
    # the uniform (plain) layout only.
    plan: tuple = None


def plan_segments(send_profile: np.ndarray, recv_profile: np.ndarray,
                  margin: float = 1.3, max_segments: int = 4) -> tuple:
    """Optimal contiguous segmentation of one round's step range, by
    dynamic programming.

    `send_profile[s]` / `recv_profile[s]` are the largest (over the
    planned batches) type-combined send / receiver counts of step s.
    Minimises the sum over segments of n_steps * (sea_cap + rc_cap);
    steps with no work are dropped (their segments vanish).
    """
    sa = [round_up(int(np.ceil(x * margin)), 8) if x else 0
          for x in send_profile]
    ra = [round_up(int(np.ceil(x * margin)), 8) if x else 0
          for x in recv_profile]
    s_count = len(sa)
    inf = float("inf")
    # dp[i][k] = the least cost covering steps [0, i) with k segments.
    dp = [[inf] * (max_segments + 1) for _ in range(s_count + 1)]
    choice = [[None] * (max_segments + 1) for _ in range(s_count + 1)]
    dp[0][0] = 0.0
    for i in range(s_count):
        for k in range(max_segments):
            if dp[i][k] == inf:
                continue
            ma = mb = 0
            for j in range(i, s_count):
                ma, mb = max(ma, sa[j]), max(mb, ra[j])
                cost = dp[i][k] + (j - i + 1) * (ma + mb)
                if cost < dp[j + 1][k + 1]:
                    dp[j + 1][k + 1] = cost
                    choice[j + 1][k + 1] = i
    best_k = min(range(1, max_segments + 1), key=lambda k: dp[s_count][k])
    bounds = []
    i, k = s_count, best_k
    while i > 0:
        lo = choice[i][k]
        bounds.append((lo, i))
        i, k = lo, k - 1
    segments = []
    for lo, hi in reversed(bounds):
        sea = max(sa[lo:hi])
        rc = max(ra[lo:hi])
        if sea == 0 and rc == 0:
            continue  # empty head or tail steps: no work at all
        segments.append((lo, hi, max(sea, 8), max(rc, 8)))
    return tuple(segments)


def dfs_depths(outgoing: Dict[int, List[Tuple[int, int, int]]],
               seed: int,
               depths: Optional[Dict[int, int]] = None) -> Dict[int, int]:
    """Iterative pre-order depth-first depths (async.py:28-34, without
    Python's recursion limit). An existing `depths` dict is extended in
    place; assigned nodes are never revisited (disconnected
    components)."""
    if depths is None:
        depths = {}
    stack = [(seed, 0)]
    while stack:
        v, depth = stack.pop()
        if v in depths:
            continue
        depths[v] = depth
        # Reversed, so the first-listed neighbour is visited first, as in
        # the recursive visit.
        for (_, __, w) in reversed(outgoing.get(v, [])):
            if w not in depths:
                stack.append((w, depth + 1))
    return depths


def graph_to_propagation_schedules(edges, num_edge_types: int,
                                   tie_fwd_bkwd: bool,
                                   propagation_rounds: int,
                                   propagation_substeps: int,
                                   num_nodes: int = 0):
    """Per-graph schedules: a list over rounds of
    (initial_nodes, sending_nodes[step][type], msg_targets[step][type],
     receiving_nodes[step]).

    `num_nodes` (the node_features row count) makes nodes with no
    incident edge part of every round's initial set, so that they keep
    their features on both model paths."""
    if propagation_rounds % 2 != 0:
        raise ValueError(
            f"propagation_rounds must be even (forward/backward round "
            f"pairs); got {propagation_rounds}")
    num_fwd = num_edge_types if tie_fwd_bkwd else num_edge_types // 2

    num_incoming: Dict[int, int] = {}
    outgoing: Dict[int, List[Tuple[int, int, int]]] = {}
    for (v, typ, w) in edges:
        if not 1 <= typ <= num_fwd:
            raise ValueError(
                f"edge type {typ} out of range [1, {num_fwd}]")
        t = typ - 1  # 0-based, as every variant
        bwd_t = t if tie_fwd_bkwd else num_fwd + t
        num_incoming[v] = num_incoming.get(v, 0) + 1
        num_incoming[w] = num_incoming.get(w, 0) + 1
        outgoing.setdefault(v, []).append((v, t, w))
        outgoing.setdefault(w, []).append((w, bwd_t, v))

    seeds = [n for (n, _) in sorted(num_incoming.items(),
                                    key=lambda kv: (kv[1], kv[0]))]
    if not seeds:
        # No edge at all (a one-atom molecule): every round is step-free
        # with every node initial; the states pass through.
        return [_tensorise([], num_edge_types, num_nodes)
                for _ in range(propagation_rounds)]
    schedules = []
    for pair in range(propagation_rounds // 2):
        seed = seeds[pair % len(seeds)]
        depths = dfs_depths(outgoing, seed)
        # A disconnected graph: each further component from its own
        # least-degree seed, at depth 0 again (the reference raises a
        # KeyError here, chem_tensorflow_async.py:316).
        for extra_seed in seeds:
            if extra_seed not in depths:
                dfs_depths(outgoing, extra_seed, depths)
        max_depth = max(depths.values())
        if max_depth > propagation_substeps:
            raise ValueError(
                f"schedule depth {max_depth} exceeds propagation_substeps "
                f"{propagation_substeps}; raise \"propagation_substeps\" "
                f"in the config (the reference asserts here too, "
                f"chem_tensorflow_async.py:315)")
        fwd: List[List[Tuple[int, int, int]]] = [[] for _ in range(max_depth)]
        bwd: List[List[Tuple[int, int, int]]] = [[] for _ in range(max_depth)]
        for (v, typ, w) in edges:
            t = typ - 1
            bwd_t = t if tie_fwd_bkwd else num_fwd + t
            dv, dw = depths[v], depths[w]
            if dv < dw:
                fwd[dw - 1].append((v, t, w))
                bwd[-dv - 1].append((w, bwd_t, v))
            elif dw < dv:
                fwd[dv - 1].append((w, bwd_t, v))
                bwd[-dw - 1].append((v, t, w))
            else:
                # Self-loops are dropped from the schedule, as the
                # reference drops them (async.py:330): the async variant
                # sees self-loop-free graphs.
                if v != w:
                    raise ValueError(
                        "equal-depth edge between distinct nodes (broken "
                        "depth-first search)")
        schedules.append(_tensorise(fwd, num_edge_types, num_nodes))
        schedules.append(_tensorise(bwd, num_edge_types, num_nodes))
    return schedules


def _tensorise(step_edges_list, num_edge_types: int, num_nodes: int = 0):
    """Reference async.py:251-291: per step, the unique sorted receivers,
    numbered densely and shared by every edge type."""
    sending, msg_targets, receiving = [], [], []
    all_nodes = set()
    for step_edges in step_edges_list:
        recv_nodes = sorted({w for (_, __, w) in step_edges})
        local_id = {v: i for i, v in enumerate(recv_nodes)}
        send_step, target_step = [], []
        for t in range(num_edge_types):
            send_step.append(np.array(
                [v for (v, e, _) in step_edges if e == t], dtype=np.int32))
            target_step.append(np.array(
                [local_id[w] for (_, e, w) in step_edges if e == t],
                dtype=np.int32))
        sending.append(send_step)
        msg_targets.append(target_step)
        receiving.append(np.array(recv_nodes, dtype=np.int32))
        all_nodes.update(v for (v, _, __) in step_edges)
        all_nodes.update(w for (_, __, w) in step_edges)
    # Isolated nodes (rows with no incident edge) carry their state
    # through as initial nodes.
    all_nodes.update(range(num_nodes))
    updated = {v for step in receiving for v in step}
    initial = np.array(sorted(all_nodes - updated), dtype=np.int32)
    return initial, sending, msg_targets, receiving


def check_schedule_invariants(schedule, num_edge_types: int) -> None:
    """The reference's disabled `check_batch_invariants`
    (async.py:456-470) as a real check: every sender was initialised
    before it sends, and every receiver is updated once."""
    initial, sending, msg_targets, receiving = schedule
    initialised = set(int(v) for v in initial)
    for step in range(len(receiving)):
        for t in range(num_edge_types):
            for v in sending[step][t]:
                if int(v) not in initialised:
                    raise ValueError(f"uninitialised sender {v}")
        for v in receiving[step]:
            if int(v) in initialised:
                raise ValueError(f"receiver {v} updated twice")
        initialised.update(int(v) for v in receiving[step])


@dataclasses.dataclass(frozen=True)
class _FlatSchedules:
    """A graph's whole schedule as flat arrays, made when preprocessing:
    the packer's per-(round, step, type) appends become grouped numpy
    scatters and its fit check four vectorised compares over the count
    tables. Per round, the rows are step-major, type-major within a step
    and in edge order within (step, type)."""
    # Per-round tuples, each entry an int32 array of that round:
    key: tuple         # [E_r], s * T + t
    key_s: tuple       # [E_r], s (= key // T)
    send: tuple        # [E_r] graph-local sender ids
    tgt: tuple         # [E_r] graph-local per-step target index
    recv_s: tuple      # [RC_r] step of each receiver
    recv_node: tuple   # [RC_r] graph-local receiver ids
    initial: tuple     # [I_r]
    # Count tables (the fit check's operands):
    counts_st: np.ndarray    # [R, S, T] int32 sends per (r, step, type)
    counts_r: np.ndarray     # [R, S] int32 receivers per (r, step)
    counts_init: np.ndarray  # [R] int32 initial nodes per round
    depth: np.ndarray        # [R] int32 schedule length per round


def _flatten_schedules(prop_schedules, substeps: int, num_edge_types: int):
    S, T = substeps, num_edge_types
    R = len(prop_schedules)
    counts_st = np.zeros((R, S, T), np.int32)
    counts_r = np.zeros((R, S), np.int32)
    counts_init = np.zeros((R,), np.int32)
    depth = np.zeros((R,), np.int32)
    key_r, key_s_r, send_r, tgt_r = [], [], [], []
    recv_s_r, recv_node_r, initial_r = [], [], []
    for r, (initial, sending, msg_targets, receiving) in enumerate(
            prop_schedules):
        sends, tgts, recv_node = [], [], []
        d = len(receiving)
        depth[r] = d
        counts_init[r] = len(initial)
        for s in range(d):
            counts_r[r, s] = len(receiving[s])
            if len(receiving[s]):
                recv_node.append(np.asarray(receiving[s], np.int32))
            for t in range(T):
                e = len(sending[s][t])
                counts_st[r, s, t] = e
                if e:
                    sends.append(np.asarray(sending[s][t], np.int32))
                    tgts.append(np.asarray(msg_targets[s][t], np.int32))

        def cat(lst):
            return (np.concatenate(lst) if lst
                    else np.zeros(0, np.int32))

        key = np.repeat(np.arange(d * T, dtype=np.int32),
                        counts_st[r, :d].reshape(-1))
        key_r.append(key)
        key_s_r.append(key // T)
        send_r.append(cat(sends))
        tgt_r.append(cat(tgts))
        recv_s_r.append(np.repeat(np.arange(d, dtype=np.int32),
                                  counts_r[r, :d]))
        recv_node_r.append(cat(recv_node))
        initial_r.append(np.asarray(initial, np.int32))
    return _FlatSchedules(
        key=tuple(key_r), key_s=tuple(key_s_r), send=tuple(send_r),
        tgt=tuple(tgt_r), recv_s=tuple(recv_s_r),
        recv_node=tuple(recv_node_r), initial=tuple(initial_r),
        counts_st=counts_st, counts_r=counts_r, counts_init=counts_init,
        depth=depth)


def nested_schedules_from_flat(flat: "_FlatSchedules"):
    """Exact inverse of `_flatten_schedules`: rebuild the nested
    per-round (initial, sending, msg_targets, receiving) tuples from the
    flat tables. Used so `preprocess_async` only has to store the flat
    form (halving host memory for the async corpus) while the legacy
    planner/packer/oracle paths still see nested schedules on demand."""
    R, _S, T = flat.counts_st.shape
    rounds = []
    for r in range(R):
        d = int(flat.depth[r])
        st_sizes = flat.counts_st[r, :d].reshape(-1)
        send_parts = np.split(flat.send[r], np.cumsum(st_sizes)[:-1])
        tgt_parts = np.split(flat.tgt[r], np.cumsum(st_sizes)[:-1])
        recv_parts = np.split(flat.recv_node[r],
                              np.cumsum(flat.counts_r[r, :d])[:-1])
        sending = [[send_parts[s * T + t] for t in range(T)]
                   for s in range(d)]
        msg_targets = [[tgt_parts[s * T + t] for t in range(T)]
                       for s in range(d)]
        receiving = [recv_parts[s] for s in range(d)]
        rounds.append((flat.initial[r], sending, msg_targets, receiving))
    return rounds


def get_prop_schedules(g: dict):
    """Nested schedules for one processed graph; reconstructed (and
    cached on the dict) from the flat tables when not stored."""
    sched = g.get("prop_schedules")
    if sched is None:
        flat = g.get("flat_schedules")
        if flat is None:
            raise ValueError(
                "processed async graph carries neither prop_schedules "
                "nor flat_schedules — it cannot be packed; re-run "
                "preprocess_async on this corpus")
        sched = nested_schedules_from_flat(flat)
        g["prop_schedules"] = sched
    return sched


def _grouped_cumcount(key: np.ndarray) -> np.ndarray:
    """Each row's rank within its key group, row order kept (the scatter
    position inside each fixed-capacity lane)."""
    order = np.argsort(key, kind="stable")
    sk = key[order]
    n = len(sk)
    starts = np.nonzero(np.r_[True, sk[1:] != sk[:-1]])[0]
    lengths = np.diff(np.r_[starts, n])
    grp = np.repeat(np.arange(len(starts)), lengths)
    pos_sorted = np.arange(n) - starts[grp]
    pos = np.empty(n, np.int64)
    pos[order] = pos_sorted
    return pos


def preprocess_async(raw_data: Sequence, num_edge_types: int,
                     tie_fwd_bkwd: bool, propagation_rounds: int,
                     propagation_substeps: int, task_ids: Sequence[int],
                     task_sample_ratios: Dict, is_training: bool,
                     rng: Optional[np.random.RandomState] = None) -> List[dict]:
    """Processed graphs: node features, the flat schedule tables and the
    labels; training shuffles them with `rng` and blanks the labels past
    each task's sample ratio."""
    processed = []
    for d in raw_data:
        schedules = graph_to_propagation_schedules(
            d["graph"], num_edge_types, tie_fwd_bkwd,
            propagation_rounds, propagation_substeps,
            num_nodes=len(d["node_features"]))
        processed.append({
            "init": np.asarray(d["node_features"], dtype=np.float32),
            "flat_schedules": _flatten_schedules(
                schedules, propagation_substeps, num_edge_types),
            "labels": _extract_labels(d, task_ids),
        })
    if is_training:
        if rng is not None:
            rng.shuffle(processed)
        _apply_task_sample_ratios(processed, task_ids, task_sample_ratios)
    return processed


def plan_async_capacities(processed: Sequence[dict], num_edge_types: int,
                          node_budget: int, propagation_rounds: int,
                          margin: float = None) -> AsyncCapacities:
    return plan_async_capacities_multi([processed], num_edge_types,
                                       node_budget, propagation_rounds,
                                       margin)


def plan_async_capacities_multi(processed_lists, num_edge_types: int,
                                node_budget: int, propagation_rounds: int,
                                margin: float = None) -> AsyncCapacities:
    """Shared capacities + segmented-scan plan over several splits
    (train + valid must compile to the same shapes)."""
    if margin is None:
        margin = DEFAULT_PACK_MARGIN
    first = next((g for p in processed_lists for g in p), None)
    flat0 = first.get("flat_schedules") if first is not None else None
    if (flat0 is not None and flat0.counts_st.shape[0] == propagation_rounds
            and flat0.counts_st.shape[2] == num_edge_types
            and _all_flat_compatible(processed_lists, propagation_rounds,
                                     flat0.counts_st.shape[1],
                                     num_edge_types)):
        return _plan_async_capacities_flat(
            processed_lists, node_budget, propagation_rounds, margin,
            flat0.counts_st.shape[1], num_edge_types)
    max_graphs = 1
    max_init, max_send, max_recv = 1, 1, 1

    def fresh():
        return {"graphs": 0, "nodes": 0,
                "init": [0] * propagation_rounds,
                "send": {}, "recv": {}}

    stats = []
    for processed in processed_lists:
        cur = fresh()
        for g in processed:
            n = len(g["init"])
            if cur["nodes"] + n >= node_budget and cur["graphs"] > 0:
                stats.append(cur)
                cur = fresh()
            cur["graphs"] += 1
            cur["nodes"] += n
            for r, (initial, sending, _mt, receiving) in enumerate(
                    get_prop_schedules(g)):
                cur["init"][r] += len(initial)
                for s in range(len(receiving)):
                    cur["recv"][(r, s)] = (cur["recv"].get((r, s), 0)
                                           + len(receiving[s]))
                    for t in range(num_edge_types):
                        cur["send"][(r, s, t)] = (
                            cur["send"].get((r, s, t), 0)
                            + len(sending[s][t]))
        stats.append(cur)
    s_dim = 1 + max((s for st in stats for (_r, s) in st["recv"]),
                    default=0)
    send_prof = np.zeros((propagation_rounds, s_dim), np.int64)
    recv_prof = np.zeros((propagation_rounds, s_dim), np.int64)
    for st in stats:
        max_graphs = max(max_graphs, st["graphs"])
        max_init = max(max_init, max(st["init"]))
        if st["send"]:
            max_send = max(max_send, max(st["send"].values()))
        if st["recv"]:
            max_recv = max(max_recv, max(st["recv"].values()))
        for (r, s), v in st["recv"].items():
            recv_prof[r, s] = max(recv_prof[r, s], v)
        combined: Dict = {}
        for (r, s, _t), v in st["send"].items():
            combined[(r, s)] = combined.get((r, s), 0) + v
        for (r, s), v in combined.items():
            send_prof[r, s] = max(send_prof[r, s], v)
    plan = tuple(plan_segments(send_prof[r], recv_prof[r], margin)
                 for r in range(propagation_rounds))
    return AsyncCapacities(
        nodes=round_up(node_budget, 8),
        graphs=round_up(int(np.ceil(max_graphs * margin)), 8),
        initial_nodes=round_up(int(np.ceil(max_init * margin)), 8),
        sending_edges=round_up(int(np.ceil(max_send * margin)), 8),
        receiving_nodes=round_up(int(np.ceil(max_recv * margin)), 8),
        plan=plan,
    )


def _all_flat_compatible(processed_lists, rounds: int, substeps: int,
                         num_edge_types: int) -> bool:
    """True when every graph carries a flat table of the expected
    shape."""
    for processed in processed_lists:
        for g in processed:
            flat = g.get("flat_schedules")
            if flat is None or flat.counts_st.shape != (rounds, substeps,
                                                        num_edge_types):
                return False
    return True


def _plan_async_capacities_flat(processed_lists, node_budget: int,
                                propagation_rounds: int, margin: float,
                                substeps: int,
                                num_edge_types: int) -> AsyncCapacities:
    """The planner over the count tables: the packer's greedy budget
    walk, the largest counts of its batches, and the per-round segment
    plan over their step profiles."""
    R, S = propagation_rounds, substeps
    max_graphs, max_init, max_send, max_recv = 1, 1, 1, 1
    max_depth = 0
    send_prof = np.zeros((R, S), np.int64)
    recv_prof = np.zeros((R, S), np.int64)

    def flush(cur_graphs, cur_send, cur_recv, cur_init):
        nonlocal max_graphs, max_init, max_send, max_recv
        nonlocal send_prof, recv_prof
        max_graphs = max(max_graphs, cur_graphs)
        max_init = max(max_init, int(cur_init.max(initial=0)))
        max_send = max(max_send, int(cur_send.max(initial=0)))
        max_recv = max(max_recv, int(cur_recv.max(initial=0)))
        send_prof = np.maximum(send_prof, cur_send.sum(axis=2))
        recv_prof = np.maximum(recv_prof, cur_recv)

    for processed in processed_lists:
        if not processed:  # an empty validation split
            continue
        cur_graphs, cur_nodes = 0, 0
        cur_send = np.zeros((R, S, num_edge_types), np.int64)
        cur_recv = np.zeros((R, S), np.int64)
        cur_init = np.zeros((R,), np.int64)
        for g in processed:
            n = len(g["init"])
            if cur_nodes + n >= node_budget and cur_graphs > 0:
                flush(cur_graphs, cur_send, cur_recv, cur_init)
                cur_graphs, cur_nodes = 0, 0
                cur_send[:], cur_recv[:], cur_init[:] = 0, 0, 0
            flat = g["flat_schedules"]
            cur_graphs += 1
            cur_nodes += n
            cur_send += flat.counts_st
            cur_recv += flat.counts_r
            cur_init += flat.counts_init
            max_depth = max(max_depth, int(flat.depth.max(initial=0)))
        flush(cur_graphs, cur_send, cur_recv, cur_init)
    s_dim = max(max_depth, 1)
    plan = tuple(plan_segments(send_prof[r, :s_dim], recv_prof[r, :s_dim],
                               margin)
                 for r in range(propagation_rounds))
    return AsyncCapacities(
        nodes=round_up(node_budget, 8),
        graphs=round_up(int(np.ceil(max_graphs * margin)), 8),
        initial_nodes=round_up(int(np.ceil(max_init * margin)), 8),
        sending_edges=round_up(int(np.ceil(max_send * margin)), 8),
        receiving_nodes=round_up(int(np.ceil(max_recv * margin)), 8),
        plan=plan,
    )


class _SegmentOverflow(Exception):
    pass


def _expand_seg_caps(caps, R: int, S: int):
    """Per-(round, step) lane caps of the segment plan as dense [R, S]
    tables (no plan: unbounded)."""
    plan = caps.plan
    seg_sea_cap = np.full((R, S), np.iinfo(np.int64).max, np.int64)
    seg_rc_cap = np.full((R, S), np.iinfo(np.int64).max, np.int64)
    if plan is not None:
        for r in range(R):
            for (lo, hi, sea, rc) in plan[r]:
                seg_sea_cap[r, lo:min(hi, S)] = sea
                seg_rc_cap[r, lo:min(hi, S)] = rc
    return seg_sea_cap, seg_rc_cap


def _build_segments(plan, R, T, caps, m_dump, node_to_compact,
                    recv_base, recv_offsets, sending_nodes, msg_targets,
                    receiving_nodes):
    """Per-round AsyncSegment tuples from the uniform packed arrays."""
    rc_pad = caps.receiving_nodes  # the pad of the uniform msg_targets
    rounds = []
    for r in range(R):
        # A step with real receivers outside every planned segment (a
        # graph deeper or wider than the planning corpus) would be
        # dropped from the compact path: raise, and the batch takes the
        # plain path instead.
        covered = np.zeros(recv_offsets.shape[1], bool)
        for (lo, hi, _sea, _rc) in plan[r]:
            covered[lo:hi] = True
        uncovered = np.nonzero(~covered & (recv_offsets[r] > 0))[0]
        if len(uncovered):
            raise _SegmentOverflow(
                f"round {r}: steps {uncovered.tolist()} have receivers "
                f"outside the planned segments")
        segs = []
        for (lo, hi, sea_cap, rc_cap) in plan[r]:
            n = hi - lo
            sc = np.full((n, sea_cap), m_dump, np.int32)
            mtyp = np.zeros((n, sea_cap), np.int32)
            tg = np.full((n, sea_cap), rc_cap, np.int32)
            oc = np.full((n, rc_cap),
                         m_dump if r > 0 else caps.nodes, np.int32)
            rb = np.zeros((n,), np.int32)
            for k, s in enumerate(range(lo, hi)):
                rb[k] = recv_base[r, s]
                cnt = int(recv_offsets[r, s])
                if cnt > rc_cap:
                    raise _SegmentOverflow(
                        f"round {r} step {s}: {cnt} receivers > {rc_cap}")
                rn = receiving_nodes[r, s, :cnt]
                oc[k, :cnt] = rn if r == 0 else node_to_compact[r - 1][rn]
                sends, tgts, typs = [], [], []
                for t in range(T):
                    real = msg_targets[r, s, t] < rc_pad
                    sends.append(sending_nodes[r, s, t][real])
                    tgts.append(msg_targets[r, s, t][real])
                    typs.append(np.full(int(real.sum()), t, np.int32))
                sends = np.concatenate(sends)
                tgts = np.concatenate(tgts)
                typs = np.concatenate(typs)
                if len(sends) > sea_cap:
                    raise _SegmentOverflow(
                        f"round {r} step {s}: {len(sends)} sends > "
                        f"{sea_cap}")
                # (target, type)-sorted, so that the composite id
                # target * T + type is monotone along the lane.
                order = np.lexsort((typs, tgts))
                m = len(order)
                sc[k, :m] = node_to_compact[r][sends[order]]
                tg[k, :m] = tgts[order]
                mtyp[k, :m] = typs[order]
            segs.append(AsyncSegment(send_compact=sc, msg_type=mtyp,
                                     msg_target=tg, old_compact=oc,
                                     recv_base=rb))
        rounds.append(tuple(segs))
    return tuple(rounds)


def pack_async_batches(processed: List[dict], num_edge_types: int,
                       node_budget: int, caps: AsyncCapacities,
                       propagation_rounds: int, propagation_substeps: int,
                       hidden_size: int, annotation_size: int,
                       is_training: bool,
                       rng: Optional[np.random.RandomState] = None,
                       use_flat: Optional[bool] = None,
                       cache: Optional["AsyncPackCache"] = None
                       ) -> Iterator[AsyncGraphBatch]:
    """Packed async batches. Dispatches to the corpus-cached epoch
    packer (whole-batch gathers/scatters over `cache`, bit-identical —
    tests/test_torch_async_cache.py) when a matching `AsyncPackCache` is passed,
    else to the vectorized per-graph fast path (grouped scatters over
    preprocess-time flat tables) whenever the processed graphs carry
    matching `flat_schedules`; the legacy per-(graph, step, type) loop
    remains as the fallback/oracle."""
    if not processed:
        # Zero batches, not an IndexError from the loop packer's
        # processed[0] — an empty validation split is a supported input
        # (the planner handles it explicitly).
        return iter(())
    if (cache is not None and use_flat is not False
            and cache.matches(processed, propagation_rounds,
                              propagation_substeps, num_edge_types)):
        return _pack_async_batches_cached(
            cache, num_edge_types, node_budget, caps, propagation_rounds,
            propagation_substeps, hidden_size, annotation_size,
            is_training, rng)
    flat_ok = (
        use_flat is not False
        and bool(processed)
        # EVERY graph must carry a matching flat table — same check the
        # planner makes; a heterogeneous corpus (mixed configs, stripped
        # tables) falls back to the legacy loop instead of crashing on
        # graph k mid-epoch.
        and _all_flat_compatible([processed], propagation_rounds,
                                 propagation_substeps, num_edge_types))
    packer = _pack_async_batches_flat if flat_ok else _pack_async_batches_loop
    return packer(processed, num_edge_types, node_budget, caps,
                  propagation_rounds, propagation_substeps, hidden_size,
                  annotation_size, is_training, rng)


def _pack_async_batches_flat(processed: List[dict], num_edge_types: int,
                             node_budget: int, caps: AsyncCapacities,
                             propagation_rounds: int,
                             propagation_substeps: int, hidden_size: int,
                             annotation_size: int, is_training: bool,
                             rng: Optional[np.random.RandomState] = None
                             ) -> Iterator[AsyncGraphBatch]:
    if is_training and rng is not None:
        processed = list(processed)  # a copy: epoch shuffles must not compose
        rng.shuffle(processed)
    num_tasks = len(processed[0]["labels"])
    R, S, T = propagation_rounds, propagation_substeps, num_edge_types
    seg_sea_cap, seg_rc_cap = _expand_seg_caps(caps, R, S)
    rc_eff = np.minimum(seg_rc_cap, caps.receiving_nodes)  # [R, S]
    idx = 0
    while idx < len(processed):
        g_inits, node_counts, values, masks = [], [], [], []
        keys = [[] for _ in range(R)]
        sends = [[] for _ in range(R)]
        tgts = [[] for _ in range(R)]
        recv_ss = [[] for _ in range(R)]
        recv_nodes = [[] for _ in range(R)]
        inits = [[] for _ in range(R)]
        send_type_totals = np.zeros((R, S, T), np.int64)
        recv_totals = np.zeros((R, S), np.int64)
        init_totals = np.zeros((R,), np.int64)
        node_offset, graphs_in_batch = 0, 0
        while idx < len(processed):
            g = processed[idx]
            flat = g["flat_schedules"]
            n = len(g["init"])
            new_st = send_type_totals + flat.counts_st
            fits = (node_offset + n < node_budget
                    and graphs_in_batch + 1 <= caps.graphs
                    and not np.any(init_totals + flat.counts_init
                                   > caps.initial_nodes)
                    and not np.any(recv_totals + flat.counts_r > rc_eff)
                    and new_st.max(initial=0) <= caps.sending_edges
                    and not np.any(new_st.sum(axis=2) > seg_sea_cap))
            if not fits:
                if graphs_in_batch == 0:
                    raise ValueError(f"graph exceeds async capacities {caps}")
                break
            g_inits.append(g["init"])
            node_counts.append(n)
            for r in range(R):
                if len(flat.key[r]):
                    keys[r].append(flat.key[r])
                    sends[r].append(flat.send[r] + node_offset)
                    # Every type shares the step's receiver offset: the
                    # batch's receiver count at (r, s) before this graph,
                    # looked up per edge row.
                    tgts[r].append(flat.tgt[r]
                                   + recv_totals[r][flat.key_s[r]])
                if len(flat.recv_s[r]):
                    recv_ss[r].append(flat.recv_s[r])
                    recv_nodes[r].append(flat.recv_node[r] + node_offset)
                if len(flat.initial[r]):
                    inits[r].append(flat.initial[r] + node_offset)
            send_type_totals = new_st
            recv_totals += flat.counts_r
            init_totals += flat.counts_init
            v, m = _labels_to_values_and_mask(g["labels"])
            values.append(v)
            masks.append(m)
            idx += 1
            graphs_in_batch += 1
            node_offset += n

        node_features = np.zeros((caps.nodes, hidden_size), np.float32)
        off = 0
        for gi, n in zip(g_inits, node_counts):
            node_features[off:off + n, :annotation_size] = gi
            off += n
        node_graph_ids = np.full((caps.nodes,), caps.graphs, np.int32)
        node_graph_ids[:node_offset] = np.repeat(
            np.arange(graphs_in_batch, dtype=np.int32), node_counts)

        # Fixed-shape slabs, one grouped scatter per array: a row's rank
        # within its lane is its position there (graph-major order).
        initial_nodes = np.full((R, caps.initial_nodes), caps.nodes, np.int32)
        sending_nodes = np.zeros((R, S, T, caps.sending_edges), np.int32)
        msg_targets = np.full((R, S, T, caps.sending_edges),
                              caps.receiving_nodes, np.int32)
        receiving_nodes = np.full((R, S, caps.receiving_nodes),
                                  caps.nodes, np.int32)
        for r in range(R):
            if inits[r]:
                arr = np.concatenate(inits[r])
                initial_nodes[r, :len(arr)] = arr
            if keys[r]:
                key = np.concatenate(keys[r])
                pos = _grouped_cumcount(key)
                sending_nodes[r].reshape(S * T, -1)[key, pos] = (
                    np.concatenate(sends[r]))
                msg_targets[r].reshape(S * T, -1)[key, pos] = (
                    np.concatenate(tgts[r]))
            if recv_ss[r]:
                ks = np.concatenate(recv_ss[r])
                pos = _grouped_cumcount(ks)
                receiving_nodes[r][ks, pos] = np.concatenate(recv_nodes[r])

        yield _finalize_async_batch(
            caps, R, S, T, num_tasks, values, masks,
            graphs_in_batch, node_offset, initial_nodes, sending_nodes,
            msg_targets, receiving_nodes, recv_totals,
            node_features=node_features, node_graph_ids=node_graph_ids)


def _run_ranks(comp: np.ndarray) -> np.ndarray:
    """Rank within contiguous equal-value runs of `comp` (the static
    within-(graph, lane) scatter position — rows are lane-sorted within
    each graph, so runs are contiguous by construction)."""
    n = len(comp)
    if n == 0:
        return np.zeros(0, np.int32)
    idx = np.arange(n)
    starts = np.r_[True, comp[1:] != comp[:-1]]
    run_start = np.maximum.accumulate(np.where(starts, idx, 0))
    return (idx - run_start).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class AsyncPackCache:
    """Corpus-level relayout cache for the async epoch packer.

    Shuffling permutes BATCH COMPOSITION, not per-graph schedules — so
    everything except the batch split and the final scatters is
    epoch-invariant and computed ONCE here: the per-graph flat tables
    concatenated into whole-corpus arrays (with per-graph offsets), the
    stacked count tables the batch split needs, and the static
    within-(graph, lane) scatter ranks. An epoch then reduces to, per
    batch, one window cumsum (split), a handful of index-arithmetic
    gathers and one grouped scatter per slab — no per-graph python.
    Replaces the reference's per-epoch feed-dict assembly
    (chem_tensorflow_async.py:337-455).

    Labels are snapshotted at build time; build the cache AFTER
    task_sample_ratios blanking (preprocess_async does this), and
    rebuild if labels are mutated afterwards.
    """
    num_graphs: int
    R: int
    S: int
    T: int
    s_used: int              # max schedule depth over the corpus (<= S)
    # Batch-split operands, stacked over the corpus (step axis trimmed
    # to s_used — steps past the deepest schedule are identically 0):
    n_nodes: np.ndarray      # [G] int64
    counts_st: np.ndarray    # [G, R, s_used, T] int32
    counts_r: np.ndarray     # [G, R, s_used] int32
    counts_init: np.ndarray  # [G, R] int32
    values: np.ndarray       # [G, K] float32
    masks: np.ndarray        # [G, K] float32
    # Node features, corpus-concatenated:
    feats: np.ndarray        # [N_all, A] float32
    fstart: np.ndarray       # [G + 1] int64
    # Per-round corpus-concatenated schedule rows (tuples over R):
    ekey: tuple              # [E_r] int32, s * T + t
    ekey_s: tuple            # [E_r] int32
    esend: tuple             # [E_r] int32 graph-local sender ids
    etgt: tuple              # [E_r] int32 per-(graph, step) target idx
    erank: tuple             # [E_r] int32 rank within (graph, key) run
    egstart: tuple           # [G + 1] int64 row offsets per graph
    rkey_s: tuple            # [RC_r] int32 step per receiver
    rnode: tuple             # [RC_r] int32 graph-local receiver ids
    rrank: tuple             # [RC_r] int32 rank within (graph, step) run
    rgstart: tuple           # [G + 1] int64
    inits: tuple             # [I_r] int32 graph-local initial nodes
    igstart: tuple           # [G + 1] int64

    def matches(self, processed, rounds: int, substeps: int,
                num_edge_types: int) -> bool:
        """Corpus fingerprint: a cache built for a DIFFERENT corpus
        must fall back to a rebuild, not silently emit batches for the
        wrong graphs. Checked per graph: node counts, exact labels
        (values AND masks), float64 feature sums, and every round's
        edge/receiver/initial table lengths, once per pack call.
        Residual blind spot
        (documented): an edit that preserves ALL of those — e.g.
        permuting edge targets within one graph's schedule step — can
        still slip; in-repo callers additionally guard by cache object
        identity (AsyncAdapter)."""
        G = len(processed)
        if not (self.num_graphs == G
                and (self.R, self.S, self.T)
                == (rounds, substeps, num_edge_types)):
            return False
        if not np.array_equal(
                self.n_nodes,
                np.fromiter((len(g["init"]) for g in processed),
                            np.int64, G)):
            return False
        for g_idx, g in enumerate(processed):
            v, m = _labels_to_values_and_mask(g["labels"])
            # Stored values were cast f32 on assignment at build time;
            # compare post-cast or exact labels would spuriously reject.
            if (not np.array_equal(self.values[g_idx],
                                   np.asarray(v, np.float32))
                    or not np.array_equal(self.masks[g_idx],
                                          np.asarray(m, np.float32))):
                return False
        # Per-graph sums via cumsum-diff, NOT np.add.reduceat: reduceat
        # misbehaves on repeated indices (a zero-node graph would read
        # its neighbour's first row) and raises when the final index
        # equals len(feats).
        row_cum = np.concatenate(
            [[0.0], np.cumsum(self.feats.sum(axis=1, dtype=np.float64))])
        feat_sums = row_cum[self.fstart[1:]] - row_cum[self.fstart[:-1]]
        got_sums = np.fromiter(
            (float(np.asarray(g["init"], np.float64).sum())
             for g in processed), np.float64, G)
        # allclose, not equality: the two sides reduce in different
        # orders (reduceat vs pairwise); a last-ulp difference must not
        # spuriously reject the cache (that would silently disable it).
        if not np.allclose(feat_sums, got_sums, rtol=1e-9, atol=1e-6):
            return False
        for r in range(self.R):
            if not (np.array_equal(
                        np.diff(self.egstart[r]),
                        np.fromiter((len(g["flat_schedules"].key[r])
                                     for g in processed), np.int64, G))
                    and np.array_equal(
                        np.diff(self.rgstart[r]),
                        np.fromiter((len(g["flat_schedules"].recv_s[r])
                                     for g in processed), np.int64, G))
                    and np.array_equal(
                        np.diff(self.igstart[r]),
                        np.fromiter((len(g["flat_schedules"].initial[r])
                                     for g in processed), np.int64, G))):
                return False
        return True


def build_async_pack_cache(processed: List[dict], propagation_rounds: int,
                           propagation_substeps: int, num_edge_types: int
                           ) -> Optional[AsyncPackCache]:
    """Build the epoch-packing cache (one pass over the corpus), or
    None when any graph lacks a matching flat table (the heterogeneous
    fallback cases keep the per-graph packers)."""
    R, S, T = propagation_rounds, propagation_substeps, num_edge_types
    if not processed or not _all_flat_compatible([processed], R, S, T):
        return None
    G = len(processed)
    n_nodes = np.zeros(G, np.int64)
    counts_st = np.zeros((G, R, S, T), np.int32)
    counts_r = np.zeros((G, R, S), np.int32)
    counts_init = np.zeros((G, R), np.int32)
    values = np.zeros((G, len(processed[0]["labels"])), np.float32)
    masks = np.zeros_like(values)
    feats_list = []
    ekey = [[] for _ in range(R)]
    esend = [[] for _ in range(R)]
    etgt = [[] for _ in range(R)]
    rkey_s = [[] for _ in range(R)]
    rnode = [[] for _ in range(R)]
    inits = [[] for _ in range(R)]
    egstart = np.zeros((R, G + 1), np.int64)
    rgstart = np.zeros((R, G + 1), np.int64)
    igstart = np.zeros((R, G + 1), np.int64)
    for g_idx, g in enumerate(processed):
        flat = g["flat_schedules"]
        n_nodes[g_idx] = len(g["init"])
        counts_st[g_idx] = flat.counts_st
        counts_r[g_idx] = flat.counts_r
        counts_init[g_idx] = flat.counts_init
        v, m = _labels_to_values_and_mask(g["labels"])
        values[g_idx] = v
        masks[g_idx] = m
        feats_list.append(np.asarray(g["init"], np.float32))
        for r in range(R):
            ekey[r].append(flat.key[r])
            esend[r].append(flat.send[r])
            etgt[r].append(flat.tgt[r])
            rkey_s[r].append(flat.recv_s[r])
            rnode[r].append(flat.recv_node[r])
            inits[r].append(flat.initial[r])
            egstart[r, g_idx + 1] = egstart[r, g_idx] + len(flat.key[r])
            rgstart[r, g_idx + 1] = rgstart[r, g_idx] + len(flat.recv_s[r])
            igstart[r, g_idx + 1] = igstart[r, g_idx] + len(flat.initial[r])

    def cat(parts):
        return (np.concatenate(parts) if parts else np.zeros(0, np.int32))

    ekey_c, ekey_s_c, erank_c = [], [], []
    rkey_c, rrank_c = [], []
    for r in range(R):
        key = cat(ekey[r])
        ekey_c.append(key)
        ekey_s_c.append((key // T).astype(np.int32))
        # Static scatter rank: rows are (graph, key)-run contiguous.
        gid = np.repeat(np.arange(G, dtype=np.int64),
                        np.diff(egstart[r]))
        erank_c.append(_run_ranks(gid * (S * T) + key))
        ks = cat(rkey_s[r])
        rkey_c.append(ks)
        gid_r = np.repeat(np.arange(G, dtype=np.int64),
                          np.diff(rgstart[r]))
        rrank_c.append(_run_ranks(gid_r * S + ks))
    feats = (np.concatenate(feats_list, axis=0) if feats_list
             else np.zeros((0, 0), np.float32))
    s_used = max(1, int(max((int(g["flat_schedules"].depth.max(initial=0))
                             for g in processed), default=1)))
    return AsyncPackCache(
        num_graphs=G, R=R, S=S, T=T, s_used=s_used, n_nodes=n_nodes,
        counts_st=np.ascontiguousarray(counts_st[:, :, :s_used]),
        counts_r=np.ascontiguousarray(counts_r[:, :, :s_used]),
        counts_init=counts_init, values=values,
        masks=masks, feats=feats,
        fstart=np.r_[0, np.cumsum(n_nodes)],
        ekey=tuple(ekey_c), ekey_s=tuple(ekey_s_c),
        esend=tuple(cat(esend[r]) for r in range(R)),
        etgt=tuple(cat(etgt[r]) for r in range(R)),
        erank=tuple(erank_c), egstart=tuple(egstart),
        rkey_s=tuple(rkey_c),
        rnode=tuple(cat(rnode[r]) for r in range(R)),
        rrank=tuple(rrank_c), rgstart=tuple(rgstart),
        inits=tuple(cat(inits[r]) for r in range(R)),
        igstart=tuple(igstart))


def _window_rows(gstart: np.ndarray, win: np.ndarray):
    """Corpus row indices for the graphs `win`, graph-major — the
    vectorized form of per-graph slice concatenation. Returns
    (rows, rep_g, within): source rows, per-row window-graph index,
    per-row within-graph position."""
    starts = gstart[win]
    cnts = (gstart[win + 1] - starts).astype(np.int64)
    total = int(cnts.sum())
    rep_g = np.repeat(np.arange(len(win)), cnts)
    off = np.r_[0, np.cumsum(cnts)[:-1]]
    within = np.arange(total, dtype=np.int64) - np.repeat(off, cnts)
    return starts[rep_g] + within, rep_g, within


def _pack_async_batches_cached(cache: AsyncPackCache, num_edge_types: int,
                               node_budget: int, caps: AsyncCapacities,
                               propagation_rounds: int,
                               propagation_substeps: int, hidden_size: int,
                               annotation_size: int, is_training: bool,
                               rng: Optional[np.random.RandomState] = None
                               ) -> Iterator[AsyncGraphBatch]:
    """Epoch packing over the corpus cache: per batch, ONE window
    cumsum finds the split (same greedy fits() as the per-graph
    packers — all conditions are monotone in the prefix length), then
    whole-batch gathers/scatters assemble the slabs. Bit-identical to
    `_pack_async_batches_flat` including the shuffle stream (the
    Fisher-Yates draw count depends only on the corpus length)."""
    R, S, T = propagation_rounds, propagation_substeps, num_edge_types
    su = cache.s_used
    G = cache.num_graphs
    order = list(range(G))
    if is_training and rng is not None:
        rng.shuffle(order)  # same RandomState consumption as the
        # flat packer's rng.shuffle(processed) — length-only algorithm
    order = np.asarray(order, np.int64)
    num_tasks = cache.values.shape[1]

    seg_sea_cap, seg_rc_cap = _expand_seg_caps(caps, R, su)
    rc_eff = np.minimum(seg_rc_cap, caps.receiving_nodes)  # [R, su]

    i = 0
    while i < G:
        win_all = order[i:i + int(caps.graphs)]
        # Inclusive cumulative capacity tables over the window; every
        # fits() condition is monotone in the prefix, so the batch is
        # the longest all-True prefix. (int32 is safe: counts are
        # bounded by the per-batch capacities, all < 2^31.)
        cn = np.cumsum(cache.n_nodes[win_all])
        ci = np.cumsum(cache.counts_init[win_all], axis=0,
                       dtype=np.int32)
        cr = np.cumsum(cache.counts_r[win_all], axis=0, dtype=np.int32)
        cst = np.cumsum(cache.counts_st[win_all], axis=0,
                        dtype=np.int32)
        ok = ((cn < node_budget)
              & (ci <= caps.initial_nodes).all(axis=1)
              & (cr <= rc_eff).all(axis=(1, 2))
              & (cst <= caps.sending_edges).all(axis=(1, 2, 3))
              & (cst.sum(axis=3, dtype=np.int64)
                 <= seg_sea_cap).all(axis=(1, 2)))
        if not ok[0]:
            raise ValueError(f"graph exceeds async capacities {caps}")
        nb = len(win_all) if ok.all() else int(np.argmin(ok))
        win = win_all[:nb]
        i += nb

        n = cache.n_nodes[win]
        node_off = np.r_[0, np.cumsum(n)[:-1]]
        node_total = int(cn[nb - 1])
        # Exclusive per-graph cumulative tables (scatter bases / the
        # receiver offsets each graph's targets shift by).
        cst_w = cst[:nb] - cache.counts_st[win]      # [nb, R, su, T]
        cr_w = cr[:nb] - cache.counts_r[win]         # [nb, R, su]
        ci_w = ci[:nb] - cache.counts_init[win]      # [nb, R]
        # recv_offsets for _finalize is [R, S] (plan segments may
        # reference steps past s_used; they hold zero receivers).
        recv_totals = np.zeros((R, S), np.int64)
        recv_totals[:, :su] = cr[nb - 1]              # inclusive sums

        node_features = np.zeros((caps.nodes, hidden_size), np.float32)
        frows, _f_rep, _f_within = _window_rows(cache.fstart, win)
        node_features[:node_total, :annotation_size] = cache.feats[frows]
        node_graph_ids = np.full((caps.nodes,), caps.graphs, np.int32)
        node_graph_ids[:node_total] = np.repeat(
            np.arange(nb, dtype=np.int32), n)

        initial_nodes = np.full((R, caps.initial_nodes), caps.nodes,
                                np.int32)
        sending_nodes = np.zeros((R, S, T, caps.sending_edges), np.int32)
        msg_targets = np.full((R, S, T, caps.sending_edges),
                              caps.receiving_nodes, np.int32)
        receiving_nodes = np.full((R, S, caps.receiving_nodes),
                                  caps.nodes, np.int32)
        for r in range(R):
            rows, rep_g, _w = _window_rows(cache.egstart[r], win)
            if len(rows):
                key = cache.ekey[r][rows]
                cst_w_r = cst_w[:, r].reshape(nb, su * T)
                pos = cst_w_r[rep_g, key] + cache.erank[r][rows]
                flat_send = sending_nodes[r].reshape(S * T, -1)
                flat_tgt = msg_targets[r].reshape(S * T, -1)
                flat_send[key, pos] = (cache.esend[r][rows]
                                       + node_off[rep_g])
                flat_tgt[key, pos] = (
                    cache.etgt[r][rows]
                    + cr_w[rep_g, r, cache.ekey_s[r][rows]])
            rrows, rrep_g, _w = _window_rows(cache.rgstart[r], win)
            if len(rrows):
                ks = cache.rkey_s[r][rrows]
                posr = cr_w[rrep_g, r, ks] + cache.rrank[r][rrows]
                receiving_nodes[r][ks, posr] = (cache.rnode[r][rrows]
                                                + node_off[rrep_g])
            irows, irep_g, iwithin = _window_rows(cache.igstart[r], win)
            if len(irows):
                initial_nodes[r, ci_w[irep_g, r] + iwithin] = (
                    cache.inits[r][irows] + node_off[irep_g])

        yield _finalize_async_batch(
            caps, R, S, T, num_tasks, cache.values[win], cache.masks[win],
            nb, node_total, initial_nodes, sending_nodes, msg_targets,
            receiving_nodes, recv_totals,
            node_features=node_features, node_graph_ids=node_graph_ids)


def _pack_async_batches_loop(processed: List[dict], num_edge_types: int,
                             node_budget: int, caps: AsyncCapacities,
                             propagation_rounds: int,
                             propagation_substeps: int, hidden_size: int,
                             annotation_size: int, is_training: bool,
                             rng: Optional[np.random.RandomState] = None
                             ) -> Iterator[AsyncGraphBatch]:
    if is_training and rng is not None:
        processed = list(processed)  # copy: epoch shuffles must not compose
        rng.shuffle(processed)
    num_tasks = len(processed[0]["labels"])
    R, S, T = propagation_rounds, propagation_substeps, num_edge_types
    # Per-step segment caps from the plan become part of the fits()
    # check below, so a shuffled batch can never overflow a planned
    # segment mid-epoch (the _SegmentOverflow fallback would change the
    # batch pytree structure, which the stacked mesh paths cannot absorb).
    seg_sea_cap, seg_rc_cap = _expand_seg_caps(caps, R, S)
    idx = 0
    while idx < len(processed):
        feats, graph_ids, values, masks = [], [], [], []
        init_lists = [[] for _ in range(R)]
        send_lists = [[[[] for _ in range(T)] for _ in range(S)] for _ in range(R)]
        target_lists = [[[[] for _ in range(T)] for _ in range(S)] for _ in range(R)]
        recv_lists = [[[] for _ in range(S)] for _ in range(R)]
        recv_offsets = np.zeros((R, S), dtype=np.int64)
        send_totals = np.zeros((R, S), dtype=np.int64)
        # Incremental counters for fits(): re-summing the append lists
        # per candidate graph would be O(graphs^2) per batch (the
        # reference-default 100k-node budget packs ~5k molecules).
        send_type_totals = np.zeros((R, S, T), dtype=np.int64)
        init_totals = np.zeros((R,), dtype=np.int64)
        node_offset, graphs_in_batch = 0, 0

        def fits(g) -> bool:
            n = len(g["init"])
            if node_offset + n >= node_budget or graphs_in_batch + 1 > caps.graphs:
                return False
            for r, (initial, sending, _mt, receiving) in enumerate(
                    get_prop_schedules(g)):
                if init_totals[r] + len(initial) > caps.initial_nodes:
                    return False
                for s in range(len(receiving)):
                    new_recv = recv_offsets[r, s] + len(receiving[s])
                    if new_recv > caps.receiving_nodes or new_recv > seg_rc_cap[r, s]:
                        return False
                    g_send = 0
                    for t in range(T):
                        if (send_type_totals[r, s, t] + len(sending[s][t])
                                > caps.sending_edges):
                            return False
                        g_send += len(sending[s][t])
                    if send_totals[r, s] + g_send > seg_sea_cap[r, s]:
                        return False
            return True

        while idx < len(processed):
            g = processed[idx]
            if not fits(g):
                if graphs_in_batch == 0:
                    raise ValueError(f"graph exceeds async capacities {caps}")
                break
            n = len(g["init"])
            feats.append(np.pad(g["init"],
                                ((0, 0), (0, hidden_size - annotation_size))))
            graph_ids.append(np.full(n, graphs_in_batch, dtype=np.int32))
            for r, (initial, sending, msg_targets, receiving) in enumerate(
                    get_prop_schedules(g)):
                init_lists[r].append(initial + node_offset)
                init_totals[r] += len(initial)
                for s in range(len(receiving)):
                    step_offset = recv_offsets[r, s]
                    for t in range(T):
                        send_lists[r][s][t].append(sending[s][t] + node_offset)
                        send_type_totals[r, s, t] += len(sending[s][t])
                        # All types share the step's receiver offset —
                        # the fixed version of async.py:399-401.
                        target_lists[r][s][t].append(
                            msg_targets[s][t] + step_offset)
                    recv_lists[r][s].append(receiving[s] + node_offset)
                    recv_offsets[r, s] += len(receiving[s])
                    send_totals[r, s] += sum(len(sending[s][t])
                                             for t in range(T))
            v, m = _labels_to_values_and_mask(g["labels"])
            values.append(v)
            masks.append(m)
            idx += 1
            graphs_in_batch += 1
            node_offset += n

        # Assemble fixed-shape arrays with dump-slot padding.
        initial_nodes = np.full((R, caps.initial_nodes), caps.nodes, np.int32)
        sending_nodes = np.zeros((R, S, T, caps.sending_edges), np.int32)
        msg_targets = np.full((R, S, T, caps.sending_edges),
                              caps.receiving_nodes, np.int32)
        receiving_nodes = np.full((R, S, caps.receiving_nodes),
                                  caps.nodes, np.int32)
        for r in range(R):
            if init_lists[r]:
                arr = np.concatenate(init_lists[r])
                initial_nodes[r, :len(arr)] = arr
            for s in range(S):
                if recv_lists[r][s]:
                    arr = np.concatenate(recv_lists[r][s])
                    receiving_nodes[r, s, :len(arr)] = arr
                for t in range(T):
                    if send_lists[r][s][t]:
                        arr = np.concatenate(send_lists[r][s][t])
                        sending_nodes[r, s, t, :len(arr)] = arr
                        tgt = np.concatenate(target_lists[r][s][t])
                        msg_targets[r, s, t, :len(tgt)] = tgt

        yield _finalize_async_batch(
            caps, R, S, T, num_tasks, values, masks,
            graphs_in_batch, node_offset, initial_nodes, sending_nodes,
            msg_targets, receiving_nodes, recv_offsets,
            node_features=pad_to(
                np.concatenate(feats, axis=0).astype(np.float32),
                caps.nodes),
            node_graph_ids=pad_to(np.concatenate(graph_ids), caps.nodes,
                                  fill=caps.graphs))


def _finalize_async_batch(caps, R, S, T, num_tasks,
                          values, masks, graphs_in_batch, node_offset,
                          initial_nodes, sending_nodes, msg_targets,
                          receiving_nodes, recv_offsets, *,
                          node_features, node_graph_ids) -> AsyncGraphBatch:
    """The compact-state layout of the segmented path, when the caps have
    a plan: slots [0, I_cap) the initial nodes, [I_cap, I_cap +
    cumulative receivers) the receivers packed by their real counts, the
    dump slot M; the steps grouped into the plan's segments with
    type-combined, (target, type)-sorted send lanes. Then the
    AsyncGraphBatch."""
    i_cap = caps.initial_nodes
    plan = caps.plan
    seg_rounds = None
    init_prev = None
    final_compact = None
    # The compact-slot tables serve the segmented path only: without a
    # plan the batch carries None there.
    if plan is not None:
        # default=8 must match models/async_ggnn.py's fallback: the model
        # derives the dump row from the batch's segment shapes.
        max_rc_seg = max((seg[3] for segs in plan for seg in segs),
                         default=8)
        m_dump = i_cap + caps.nodes + max_rc_seg
        node_to_compact = np.full((R, caps.nodes + 1), m_dump, np.int32)
        recv_base = np.zeros((R, S), np.int32)
        for r in range(R):
            real = initial_nodes[r] != caps.nodes
            node_to_compact[r][initial_nodes[r][real]] = (
                np.nonzero(real)[0].astype(np.int32))
            base = 0
            for s in range(S):
                cnt = int(recv_offsets[r, s])
                recv_base[r, s] = base
                rn = receiving_nodes[r, s, :cnt]
                node_to_compact[r][rn] = i_cap + base + np.arange(
                    cnt, dtype=np.int32)
                base += cnt
        init_prev = np.empty_like(initial_nodes)
        for r in range(R):
            if r == 0:
                # Round 0 reads the previous states from the [N+1, H]
                # feature buffer: node ids.
                init_prev[r] = initial_nodes[r]
            else:
                init_prev[r] = node_to_compact[r - 1][initial_nodes[r]]
        final_compact = node_to_compact[R - 1][:caps.nodes]
        try:
            seg_rounds = _build_segments(
                plan, R, T, caps, m_dump, node_to_compact,
                recv_base, recv_offsets, sending_nodes, msg_targets,
                receiving_nodes)
        except _SegmentOverflow as e:
            logging.getLogger(__name__).warning(
                "async segment capacity overflow (%s); batch falls "
                "back to the plain path", e)
            seg_rounds = None

    return AsyncGraphBatch(
        node_features=node_features,
        node_graph_ids=node_graph_ids,
        initial_nodes=initial_nodes,
        sending_nodes=sending_nodes,
        msg_targets=msg_targets,
        receiving_nodes=receiving_nodes,
        seg_rounds=seg_rounds,
        init_prev=init_prev,
        final_compact=final_compact,
        targets=pad_to(np.asarray(values, np.float32).T.reshape(
            num_tasks, graphs_in_batch), caps.graphs, axis=1),
        target_mask=pad_to(np.asarray(masks, np.float32).T.reshape(
            num_tasks, graphs_in_batch), caps.graphs, axis=1),
        num_graphs=np.int32(graphs_in_batch),
        num_nodes=np.int32(node_offset),
    )

#!/usr/bin/env python3
"""The port's mesh over nccl, one rank a card, on a machine with four
NVIDIA GPUs: the multi-card counterpart of `chip_smoke.py` phase 21, whose
gloo ranks share one card.

    python3 tools/torch_mesh_nccl.py [--parent DIR ...] [--exchange-only]

Four nccl ranks (`parallel/launch.py:RankPool`, rank r on cuda:r) run
each case of CASES with phase 21's functions and checks, every keep
probability 1.0: `sparse` at configs/sparse_tpu.json's 20,000-node budget
node-sharded at (2,2) under the alltoall, shift, ragged and "auto"
(ragged on nccl) exchanges and at (1,4) under shift and ragged,
data-parallel at (4,1) and type-TP at (2,2);
configs/sparse_attention.json node-sharded at (1,4) under shift and
ragged; `gcn` node-sharded at (2,2) under alltoall, shift and ragged;
`dense` (one bucket of 32) and `async` at (4,1). Each case: one train
step of `make_parallel_steps` over the step corpus' first batches
against the single-device step on cuda:0 (loss rtol 1e-5, every gradient
leaf rtol 2e-4 / atol 1e-6) with the launches each rank's batches
predict; 2 epochs of `synthetic_molecules(6000, seed=40)` through
`Runner(mesh=)` under deterministic algorithms: the weights bit-equal
across ranks after each epoch, the validation loss below the initial
weights', each rank's launches equal to the prediction. Every Runner
replays its steps, the ragged exchange's included (the hand-written
peer-memory ragged all-to-all, csrc/ragged_exchange.cu, its split sizes
on the card): on every rank alike it holds one train and one validation
graph for each distinct shape of the stacks each split stepped, and no
more (a capacity regrow, JAX's policy, adds a stack shape and so a key;
the count after each epoch is printed), and its weights after each
epoch equal those of an eager twin (its steps run eagerly) bit for bit;
its ms a train step replayed and eager, in turns, are printed.

Each ragged and "auto" case also times the exchange itself, on the
device (`exchange_yardstick`): on each rank's rows of its last training
stack, of chip_smoke.py phase 24's first wide batch laid out at the
case's layout, and of an exchange that moves nothing (the signalling
and launch floor), a rank's forward and reverse transfer through the
kernel and through nccl's `all_to_all_single` with the batch's split
sizes fixed at capture (its gather and zero pad included, so it
computes the same table and pack, which must be bit-equal), each as a
CUDA graph of GRAPH_EXCHANGES calls replayed in turns between CUDA
events, the ranks lined up on the device first; beside them each
rank's HBM and NVLink bounds, and the max over the ranks. Each
`--parent DIR` (another tree of the repository: an earlier commit
unpacked with `git archive` where .gitignore lists it, or a copy of the
ragged exchange's source and wrapper with a design choice changed)
times that tree's kernels too, built from its own source, named by its
directory, in the same turns. `--exchange-only` runs
the timing alone, at EXCHANGE_LAYOUTS, on the first 20,000-node batches
of the case corpus, and no case. Nothing is staged through the host:
nccl moves every CUDA tensor, point-to-point sends included.

It prints a line a case and, last, one JSON object with each case's
kind, exchange, devices, step mode, graphs a rank, losses, launches, ms
a step and exchange µs, and the cards' name and power limit
(nvidia-smi). It fails without four cards, and on any check. The step
times are a record of these cards, not a scaling result.
"""

import itertools
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORLD = 4
CASES = [(f"sparse 2x2 {x}", "sparse", {"boundary_exchange": x}, 2, 2)
         for x in ("alltoall", "shift", "ragged", "auto")] + [
    (f"sparse 1x4 {x}", "sparse", {"boundary_exchange": x}, 1, 4)
    for x in ("shift", "ragged")] + [
    ("sparse 4x1", "sparse", {}, 4, 1),
    ("sparse 2x2 type_tp", "sparse", {"edge_parallelism": "type_tp"}, 2, 2)
] + [(f"sparse_attention 1x4 {x}", cs.MESH_ATTENTION,
      {"boundary_exchange": x}, 1, 4) for x in ("shift", "ragged")] + [
    (f"gcn 2x2 {x}", "gcn", {"boundary_exchange": x}, 2, 2)
    for x in ("alltoall", "shift", "ragged")] + [
    ("dense 4x1", "dense", {"dense_bucket_sizes": [32]}, 4, 1),
    ("async 4x1", "async", {}, 4, 1)]
# Exchanges one CUDA graph holds when timing an exchange, and replays of
# each graph a turn.
GRAPH_EXCHANGES = 20
REPLAYS = 5
# The layouts `--exchange-only` times the exchange at: (n_data, n_edge).
EXCHANGE_LAYOUTS = ((2, 2), (1, 4))


def nccl_mesh(n_data, n_edge):
    """This rank's mesh: nccl, on card `rank`."""
    from ggnn_tpu_torch.parallel.mesh import make_mesh
    cs._tf32_off()
    mesh = make_mesh(n_data, n_edge)
    if mesh.backend != "nccl" or mesh.device != torch.device("cuda",
                                                             mesh.rank):
        raise RuntimeError(f"rank {mesh.rank} runs {mesh.backend} on "
                           f"{mesh.device}")
    return mesh


def step_rank(*args):
    cs.rank_mesh = nccl_mesh
    return cs.mesh_step_rank(*args)


def runner_rank(*args, **kwargs):
    cs.rank_mesh = nccl_mesh
    with cs.deterministic_algorithms():
        return cs.mesh_runner_rank(*args, **kwargs)


def parent_kernels(parent_dir):
    """The ragged exchange's wrapper module of another tree (`--parent`),
    its kernels built from that tree's own source."""
    import importlib.util
    from ggnn_tpu_torch.ops.kernels import _build
    path = os.path.join(parent_dir, "ggnn_tpu_torch", "ops", "kernels",
                        "ragged_exchange.py")
    spec = importlib.util.spec_from_file_location("parent_ragged_exchange",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    source = parent_source(parent_dir)
    module._build = SimpleNamespace(
        load=lambda name: _build.load(name, source=source))
    return module


def takes_routes(rx):
    """Whether a tree's wrapper hands each forward's routes to its
    backward (this tree's does; PR 19's kept the exchange's state on the
    card)."""
    import inspect
    return "routes" in inspect.signature(rx.exchange_backward).parameters


def parent_source(parent_dir):
    return os.path.join(parent_dir, "ggnn_tpu_torch", "csrc",
                        "ragged_exchange.cu")


def shared_regions(rx, axis, buffer_bytes, device):
    """`rx`'s peer regions over `axis`, as `Axis.reserve_peer_buffers`
    makes them: one region a rank, the IPC handles swapped over the axis'
    group."""
    import torch.distributed as dist
    address, handle = rx.allocate(buffer_bytes, device)
    mine = torch.frombuffer(bytearray(handle), dtype=torch.uint8).to(device)
    parts = [torch.empty_like(mine) for _ in range(axis.size)]
    dist.all_gather(parts, mine, group=axis.group)
    return rx.regions_of(
        [address if i == axis.index else rx.open_peer(
            bytes(p.cpu().numpy()), device) for i, p in enumerate(parts)],
        buffer_bytes, device)


def wide_rows(axis, nl, dev):
    """This rank's rows of chip_smoke.py phase 24's first wide batch laid
    out over `axis` (random send lists of 1 to RAGGED_WIDE_ROWS of its
    `nl` rows a pair, from seed 91, alike on every rank)."""
    import numpy as np
    from ggnn_tpu_torch.parallel import node_shard
    s_count = axis.size
    rng = np.random.RandomState(91)
    rows = {(o, d): sorted(rng.choice(nl, rng.randint(
        1, min(cs.RAGGED_WIDE_ROWS, nl) + 1), replace=False).tolist())
        for o in range(s_count) for d in range(s_count) if o != d}
    sizes = np.zeros((s_count, s_count), np.int64)
    for (o, d), r in rows.items():
        sizes[o, d] = len(r)
    spec = node_shard.ragged_spec(rows, s_count, int(sizes.sum(1).max()),
                                  int(sizes.sum(0).max()))
    return cs.ragged_rank_rows(spec, dev)[axis.index]


def empty_rows(spec):
    """`spec` with every size and offset 0: an exchange that moves no row
    (the signalling and launch floor)."""
    import dataclasses
    return dataclasses.replace(spec, **{
        f: torch.zeros_like(getattr(spec, f)) for f in (
            "gather", "input_offsets", "send_sizes", "output_offsets",
            "recv_sizes")})


def exchange_yardstick(mesh, spec, nl, h_dim, parents=()):
    """A rank's ragged exchange inside CUDA graphs, on this rank's rows
    `spec` of a stack (int32 on the card), phase 24's first wide batch at
    this layout and an exchange that moves nothing, each with node
    states [nl, h_dim] and table cotangents from a seed a rank: each
    design's forward (`Axis.ragged_exchange`, "change"; and each other
    tree's of `parents`, named by its directory) and reverse transfer,
    and nccl's
    `all_to_all_single` with this batch's split sizes fixed at capture
    (with its gather of the operand and the zero pad, so it computes the
    same table; backward the same pack), each table and pack bit-equal
    to nccl's. Each is a graph of GRAPH_EXCHANGES calls captured once,
    replayed REPLAYS times a turn in turns (designs, nccl, nccl,
    designs reversed), each replay between CUDA events after an
    all-reduce over the world lines the ranks up on the device: µs an
    exchange, the median. Beside them the rank's bounds: HBM bytes
    (forward: sent rows and their ids read, the table written; backward:
    the received slices read, the pack written) over 3.35 TB/s, and the
    larger of the rows it sends and receives over NVLink's 450 GB/s.
    Every rank makes the same calls in the same order."""
    import statistics
    import torch.distributed as dist
    axis, dev, me = mesh.edge, mesh.device, mesh.rank
    gen = torch.Generator(device=dev).manual_seed(1000 + me)
    row_bytes = 4 * h_dim
    cases = [("20k", spec), ("wide", wide_rows(axis, nl, dev)),
             ("empty", empty_rows(spec))]
    rows = max(max(c.recv_cap, c.gather.shape[0]) for _, c in cases)
    axis.reserve_peer_buffers(rows, row_bytes, dev)
    # Each design's forward and backward of one exchange; a design that
    # hands routes from forward to backward keeps its latest forward's.
    received = {}

    def design(name, fwd, bwd, routed):
        def forward(h, s):
            out = fwd(h, s)
            if not routed:
                return out
            table, received[name] = out
            return table

        def backward(g, s):
            return bwd(g, s, received[name]) if routed else bwd(g, s)
        return forward, backward

    designs = {"change": design("change", axis.ragged_exchange,
                                axis.ragged_exchange_backward, True)}
    for tree in parents:
        prx = parent_kernels(tree)
        regions = shared_regions(prx, axis, prx.buffer_bytes_for(
            rows, row_bytes), dev)
        name = os.path.basename(os.path.normpath(tree))
        if takes_routes(prx):
            designs[name] = design(
                name, lambda h, s, m=prx, r=regions: m.exchange(
                    h, s, r, axis.index),
                lambda g, s, t, m=prx, r=regions: m.exchange_backward(
                    g, s, t, r, axis.index), True)
        else:
            designs[name] = design(
                name, lambda h, s, m=prx, r=regions: m.exchange(
                    h, s, r, axis.index),
                lambda g, s, m=prx, r=regions: m.exchange_backward(
                    g, s, r, axis.index), False)
    tick = torch.zeros(1, device=dev)

    def lined_up_us(graph):
        times = []
        for _ in range(REPLAYS):
            dist.all_reduce(tick)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / GRAPH_EXCHANGES)
        return times

    def captured(call):
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_EXCHANGES):
                call()
        torch.cuda.synchronize()
        return graph

    out = {}
    for name, rows_spec in cases:
        h = torch.randn(nl, h_dim, generator=gen, device=dev)
        g = torch.randn(rows_spec.recv_cap, h_dim, generator=gen, device=dev)
        sends = rows_spec.send_sizes.tolist()
        recvs = rows_spec.recv_sizes.tolist()
        send_cap = rows_spec.gather.shape[0]
        index = rows_spec.gather[:sum(sends)].long()

        def nccl_forward():
            got = axis.all_to_all(h[index], recvs, sends)
            return torch.cat([got, got.new_zeros(
                (rows_spec.recv_cap - got.shape[0], h_dim))])

        def nccl_backward():
            got = axis.all_to_all(g[:sum(recvs)], sends, recvs)
            return torch.cat([got, got.new_zeros(
                (send_cap - got.shape[0], h_dim))])

        want = (nccl_forward(), nccl_backward())
        equal = True
        for fwd, bwd in designs.values():
            # Each reverse transfer after its forward of the same rows:
            # its routes, or the parent's state on the card.
            equal &= torch.equal(fwd(h, rows_spec), want[0])
            equal &= torch.equal(bwd(g, rows_spec), want[1])
        calls = {k: (lambda f=f: f(h, rows_spec), lambda b=b: b(g, rows_spec))
                 for k, (f, b) in designs.items()}
        if name != "empty":
            calls["nccl"] = (nccl_forward, nccl_backward)
        rec = {"rows_sent": sum(sends), "rows_received": sum(recvs),
               "send_cap": send_cap, "recv_cap": rows_spec.recv_cap,
               "bit_equal": bool(equal)}
        # Forward graphs first: the backward graphs read the routes the
        # last captured forward returns, filled by its replays.
        for way, label in enumerate(("forward", "backward")):
            graphs = {k: captured(c[way]) for k, c in calls.items()}
            times = {k: [] for k in graphs}
            for k in list(graphs) + list(graphs)[::-1]:
                times[k] += lined_up_us(graphs[k])
            for k, t in times.items():
                rec[f"{k}_{label}_us"] = statistics.median(t)
        sent, got = sum(sends), sum(recvs)
        rec["hbm_bound_forward_us"] = (sent * (row_bytes + 4)
                                       + rows_spec.recv_cap * row_bytes
                                       ) / cs.HBM_BYTES_PER_S * 1e6
        rec["hbm_bound_backward_us"] = (got * row_bytes + send_cap
                                        * row_bytes) / cs.HBM_BYTES_PER_S \
            * 1e6
        rec["nvlink_bound_us"] = max(sent, got) * row_bytes / \
            cs.NVLINK_BYTES_PER_S * 1e6
        out[name] = rec
    return out


def exchange_turns(runner, stack, parents=()):
    """`exchange_yardstick` on this rank's rows of a Runner's last
    training stack."""
    from ggnn_tpu_torch.parallel.node_shard import _int32_rows
    from ggnn_tpu_torch.parallel.step import local_batches
    batch = local_batches(stack, runner.mesh, runner._mesh_kind)[0]
    return exchange_yardstick(runner.mesh, _int32_rows(batch.send_idx),
                              batch.local_node_capacity,
                              runner.config["hidden_size"], parents)


def exchange_rank(n_data, n_edge, parents=()):
    """`exchange_yardstick` on this rank's rows of the first n_data
    20,000-node `sparse` batches of the case corpus, node-sharded over
    n_edge ranks (`--exchange-only`)."""
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.parallel.node_shard import _int32_rows
    from ggnn_tpu_torch.parallel.step import local_batches, plan_caps, \
        stack_for
    from ggnn_tpu_torch.training.variants import make_adapter
    mesh = nccl_mesh(n_data, n_edge)
    config = cs.mesh_config("sparse", {"boundary_exchange": "ragged"})
    data = synthetic_molecules(6000, seed=40)
    adapter = make_adapter("sparse", config, infer_metadata(
        [data], config["tie_fwd_bkwd"]))
    processed = adapter.preprocess(data, False)
    adapter.plan(processed)
    batches = list(itertools.islice(adapter.batches(processed, False),
                                    n_data))
    caps = plan_caps("sparse", batches, n_edge)
    batch = local_batches(stack_for("sparse", batches, n_data, caps,
                                    "ragged"), mesh, "sparse")[0]
    return exchange_yardstick(mesh, _int32_rows(batch.send_idx),
                              batch.local_node_capacity,
                              config["hidden_size"], parents)


def worst_over_ranks(recs):
    """{batch: {number: max over the ranks}} of the ranks'
    `exchange_yardstick` records, and whether every rank's tables and
    packs were bit-equal to nccl's."""
    out = {}
    for name in recs[0]:
        keys = [k for k in recs[0][name] if k != "bit_equal"]
        out[name] = {k: max(r[name][k] for r in recs) for k in keys}
    return out, all(r[n]["bit_equal"] for r in recs for n in r)


def check_replay(label, runs, twins):
    """A case's ranks: the same keys and stack shapes on every rank; one
    train and one validation graph for each shape of a stack its split
    stepped, and none more; the weights after each epoch those of the
    eager twin. Returns (train, validation) graphs after each epoch and
    the stack shapes epoch 2 stepped that epoch 1 did not (a capacity
    regrow: each adds one key, epoch 2 none without them)."""
    first = runs[0]
    if any(r["keys"] != first["keys"] or r["shapes"] != first["shapes"]
           for r in runs):
        raise RuntimeError(f"{label}: the ranks' keys or stack shapes part")
    seen = {"train": set(), "validation": set()}
    for split, shapes in first["shapes"]:
        seen[split].update(shapes)
    if first["keys"][-1] != [sorted(seen["train"]),
                             sorted(seen["validation"])]:
        raise RuntimeError(f"{label}: the graphs are not one a stack shape "
                           f"({[len(k) for k in first['keys'][-1]]} graphs, "
                           f"{[len(v) for v in seen.values()]} shapes)")
    if any(r["digests"] != t["digests"] for r, t in zip(runs, twins)):
        raise RuntimeError(f"{label}: the replayed weights differ from the "
                           "eager twin's")
    trained = [set(shapes) for split, shapes in first["shapes"]
               if split == "train"]
    return ([[len(k) for k in keys] for keys in first["keys"]],
            len(trained[1] - trained[0]))


def exchange_only(pool, me, parents):
    """`--exchange-only`: the yardstick at each of EXCHANGE_LAYOUTS."""
    out = {}
    for n_data, n_edge in EXCHANGE_LAYOUTS:
        label = f"sparse {n_data}x{n_edge} ragged"
        ranks = pool.run(me.exchange_rank, n_data, n_edge, parents)
        worst, equal = worst_over_ranks(ranks)
        if not equal:
            raise RuntimeError(f"{label}: a kernel's table or pack is not "
                               "nccl's")
        out[label] = {"ranks": ranks, "max_over_ranks": worst}
        print(f"{label} exchange: {json.dumps(worst)}", flush=True)
    return out


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", action="append", default=[],
                   help="another tree (an earlier commit unpacked where "
                   ".gitignore lists it) whose ragged exchange kernels are "
                   "timed beside this tree's, named by its directory "
                   "(repeatable)")
    p.add_argument("--exchange-only", action="store_true",
                   help="time the ragged exchange alone at "
                   "EXCHANGE_LAYOUTS; no case runs")
    args = p.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"torch_mesh_nccl: needs {WORLD} CUDA devices",
              file=sys.stderr)
        return 1
    # The ranks import the rank functions by this module's name.
    import torch_mesh_nccl as me
    from ggnn_tpu_torch.ops.kernels import _build
    from ggnn_tpu_torch.parallel.launch import RankPool
    start = time.perf_counter()
    cs._tf32_off()
    _build.build_all(("ell_spmm", "gather_floor", "edge_dot",
                      "ragged_exchange"))
    parents = tuple(os.path.abspath(p) for p in args.parent)
    for tree in parents:
        _build.build("ragged_exchange", source=parent_source(tree))
    cs.native_build()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    pool = RankPool(WORLD, "nccl", timeout=600, env=env, python_path=[
        REPO, os.path.dirname(os.path.abspath(__file__))])
    with pool:
        if args.exchange_only:
            cases = exchange_only(pool, me, parents)
        else:
            cases = run_cases(pool, me, parents)
    # Every card's name and power limit, one line each.
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps({"cases": cases, "world": WORLD, "backend": "nccl",
                      "parents": args.parent,
                      "seconds": time.perf_counter() - start}))
    return 0


def run_cases(pool, me, parents):
    """Every case of CASES (see the module docstring)."""
    import functools
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.training.runner import RAGGED_TRANSPORTS, mesh_kind
    from ggnn_tpu_torch.training.variants import make_adapter
    corpus = (synthetic_molecules(6000, seed=40),
              synthetic_molecules(600, seed=41))
    train, valid = (synthetic_molecules(1300, seed=42),
                    synthetic_molecules(50, seed=43))
    single = torch.device("cuda:0")
    work_dir = os.path.join(REPO, "build", "mesh_nccl")
    cases = {}
    for label, variant, over, n_data, n_edge in CASES:
        t0 = time.perf_counter()
        config = cs.mesh_config(variant, over)
        meta = infer_metadata([train, valid], config["tie_fwd_bkwd"])
        adapter = make_adapter(cs.model_variant(variant), config, meta)
        processed = adapter.preprocess(train, False)
        adapter.plan(processed)
        batches = list(itertools.islice(
            adapter.batches(processed, False), WORLD))
        gen = torch.Generator().manual_seed(0)
        weights = {n: p.detach().numpy() for n, p in ModelParams(
            adapter.build_model(gen), init_output_heads(
                gen, config["hidden_size"],
                config["task_ids"])).named_parameters()}
        kind = mesh_kind(cs.model_variant(variant), config,
                         SimpleNamespace(shape={"data": n_data,
                                                "edge": n_edge}),
                         meta.num_edge_types)
        oracle = cs.single_step(variant, config, meta, weights,
                                batches, single)
        exchange = config.get("boundary_exchange", "alltoall")
        if exchange == "auto":   # as the Runner resolves it on nccl
            exchange = ("ragged" if ("nccl", "cuda") in RAGGED_TRANSPORTS
                        else "shift")
        steps = pool.run(me.step_rank, variant, config, meta, weights,
                         batches, n_data, n_edge, kind, exchange)
        worst = cs.check_mesh_step(label, steps, oracle)
        log_dir = os.path.join(work_dir, label.replace(" ", "_"))
        ragged = (kind in ("sparse", "gcn") and n_edge > 1 and
                  over.get("boundary_exchange") in ("ragged", "auto"))
        runs = pool.run(me.runner_rank, variant, config, corpus, n_data,
                        n_edge, log_dir,
                        after=(functools.partial(me.exchange_turns,
                                                 parents=parents)
                               if ragged else None))
        devices = [f"cuda:{r}" for r in range(WORLD)]
        if runs[0]["step_mode"]["mode"] != "replayed" or (
                ragged and runs[0]["exchange"] != "ragged"):
            raise RuntimeError(f"{label}: steps {runs[0]['step_mode']}"
                               f", exchange {runs[0]['exchange']}")
        cs.check_mesh_runner(label, runs, devices)
        twins = pool.run(me.runner_rank, variant, config, corpus,
                         n_data, n_edge, log_dir, eager=True)
        graphs_by_epoch, new_shapes = check_replay(label, runs, twins)
        exchange_us = None
        if ragged:
            exchange_us, equal = worst_over_ranks([r["after"] for r in runs])
            if not equal:
                raise RuntimeError(f"{label}: a kernel's table or pack is "
                                   "not nccl's")
        first = runs[0]
        cases[label] = {
            "kind": kind, "exchange": first["exchange"],
            "devices": devices, "step_mode": first["step_mode"],
            "graphs_a_rank": first["graph_counts"],
            "graphs_after_each_epoch": graphs_by_epoch,
            "stack_shapes_new_in_epoch_2": new_shapes,
            "exchange_us_max_over_ranks": exchange_us,
            "exchange_us": ([r["after"] for r in runs] if ragged
                            else None),
            "bit_equal_to_eager_twin": True,
            "step_loss": steps[0]["loss"],
            "single_loss": oracle[0], "step_max_rel_grad_err": worst,
            "launches": [r["launches"] for r in runs],
            "step_ms": [r["step_ms"] for r in runs],
            "valid_losses": [first["initial_valid_loss"]]
            + first["valid_losses"],
            "weights_equal_across_ranks": True,
            "seconds": time.perf_counter() - t0}
        print(f"{label}: {json.dumps(cases[label])}", flush=True)
    return cases


if __name__ == "__main__":
    sys.exit(main())

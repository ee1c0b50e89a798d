#!/usr/bin/env python3
"""The port's mesh over nccl, one rank a card, on a machine with four
NVIDIA GPUs: the multi-card counterpart of `chip_smoke.py` phase 21, whose
gloo ranks share one card.

    python3 tools/torch_mesh_nccl.py

Four nccl ranks (`parallel/launch.py:RankPool`, rank r on cuda:r) run
each case of CASES with phase 21's functions and checks, every keep
probability 1.0: `sparse` at configs/sparse_tpu.json's 20,000-node budget
node-sharded at (2,2) under the alltoall, shift, ragged and "auto"
(ragged on nccl) exchanges and at (1,4) under shift and ragged,
data-parallel at (4,1) and type-TP at (2,2);
configs/sparse_attention.json node-sharded at (1,4) under shift and
ragged; `gcn` node-sharded at (2,2) under alltoall, shift and ragged;
`dense` (one bucket of 32) and `async` at (4,1). Each case: one train
step of
`make_parallel_steps` over the step corpus' first batches against the
single-device step on cuda:0 (loss rtol 1e-5, every gradient leaf rtol
2e-4 / atol 1e-6) with the launches each rank's batches predict; 2
epochs of `synthetic_molecules(6000, seed=40)` through `Runner(mesh=)`
under deterministic algorithms: the weights bit-equal across ranks after
each epoch, the validation loss below the initial weights', each rank's
launches equal to the prediction. Every Runner replays its steps, the
ragged exchange's included (the hand-written peer-memory ragged
all-to-all, csrc/ragged_exchange.cu, its split sizes on the card): it
holds the same train and validation keys on every rank, one graph a
shape of the stacks each split stepped (so epoch 2 adds a key only for a
stack shape epoch 1 did not step, as a capacity regrow makes; the count
is printed; a ragged case no more than the shift case of its layout),
and its weights after each epoch equal those of an eager twin (its steps
run eagerly) bit for bit; its ms a train step replayed and eager, in
turns, are printed. Each ragged case also times, on its last training
stack and in turns, one exchange through the kernel against
`all_to_all_single` over nccl with the split sizes on the host (CUDA
events around 20 calls a turn; the two tables bit-equal). Nothing is
staged through the host: nccl moves every CUDA tensor, point-to-point
sends included.

It prints a line a case and, last, one JSON object with each case's
kind, exchange, devices, step mode, graphs a rank, losses, launches and
ms a step, and the cards' name and power limit (nvidia-smi). It fails
without four cards, and on any check. The step times are a record of
these cards, not a scaling result.
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
# Calls a turn and turns of each when timing one exchange.
EXCHANGE_CALLS = 20


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


def exchange_turns(runner, stack):
    """One ragged exchange of this rank's shard of `stack` (random node
    states, H of the config) through the peer-memory kernel
    (`Axis.ragged_exchange`) and through `all_to_all_single` over nccl
    with the split sizes read on the host, the two tables bit-equal; µs a
    call of each, in turns kernel, nccl, nccl, kernel, CUDA events around
    EXCHANGE_CALLS calls a turn (the median of the two turns). Every rank
    makes the same calls in the same order."""
    from ggnn_tpu_torch.parallel.node_shard import _int32_rows
    from ggnn_tpu_torch.parallel.step import local_batches
    mesh = runner.mesh
    axis, dev = mesh.edge, mesh.device
    batch = local_batches(stack, mesh, runner._mesh_kind)[0]
    spec = _int32_rows(batch.send_idx)
    h = torch.randn(batch.local_node_capacity, runner.config["hidden_size"],
                    generator=torch.Generator(device=dev).manual_seed(
                        mesh.rank), device=dev)
    sends, recvs = spec.send_sizes.tolist(), spec.recv_sizes.tolist()
    operand = h[spec.gather[:sum(sends)].long()]

    def nccl():
        got = axis.all_to_all(operand, recvs, sends)
        return torch.cat([got, got.new_zeros(
            (spec.recv_cap - got.shape[0], h.shape[1]))])

    calls = {"kernel": lambda: axis.ragged_exchange(h, spec),
             "nccl": nccl}
    equal = torch.equal(calls["kernel"](), calls["nccl"]())
    times = {"kernel": [], "nccl": []}
    for name in ("kernel", "nccl", "nccl", "kernel"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(EXCHANGE_CALLS):
            calls[name]()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) * 1e3 / EXCHANGE_CALLS)
    return {"bit_equal": equal, "rows_sent": sum(sends),
            "rows_received": sum(recvs), "recv_cap": spec.recv_cap,
            "kernel_us": sorted(times["kernel"]),
            "nccl_all_to_all_us": sorted(times["nccl"])}


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


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"torch_mesh_nccl: needs {WORLD} CUDA devices",
              file=sys.stderr)
        return 1
    # The ranks import the rank functions by this module's name.
    import torch_mesh_nccl as me
    from ggnn_tpu_torch.data.loader import infer_metadata
    from ggnn_tpu_torch.data.synthetic import synthetic_molecules
    from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
    from ggnn_tpu_torch.ops.kernels import _build
    from ggnn_tpu_torch.parallel.launch import RankPool
    from ggnn_tpu_torch.training.runner import RAGGED_TRANSPORTS, mesh_kind
    from ggnn_tpu_torch.training.variants import make_adapter
    start = time.perf_counter()
    cs._tf32_off()
    _build.build_all(("ell_spmm", "gather_floor", "edge_dot",
                      "ragged_exchange"))
    cs.native_build()
    corpus = (synthetic_molecules(6000, seed=40),
              synthetic_molecules(600, seed=41))
    train, valid = (synthetic_molecules(1300, seed=42),
                    synthetic_molecules(50, seed=43))
    single = torch.device("cuda:0")
    work_dir = os.path.join(REPO, "build", "mesh_nccl")
    # (variant, n_data, n_edge) -> graphs a rank of its shift case.
    cases, shift_keys, more_keys = {}, {}, []
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with RankPool(WORLD, "nccl", timeout=600, env=env, python_path=[
            REPO, os.path.dirname(os.path.abspath(__file__))]) as pool:
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
                            after=me.exchange_turns if ragged else None)
            devices = [f"cuda:{r}" for r in range(WORLD)]
            if runs[0]["step_mode"]["mode"] != "replayed" or (
                    ragged and runs[0]["exchange"] != "ragged"):
                raise RuntimeError(f"{label}: steps {runs[0]['step_mode']}"
                                   f", exchange {runs[0]['exchange']}")
            cs.check_mesh_runner(label, runs, devices)
            twins = pool.run(me.runner_rank, variant, config, corpus,
                             n_data, n_edge, log_dir, eager=True)
            graphs_by_epoch, new_shapes = check_replay(label, runs, twins)
            layout = (variant, n_data, n_edge)
            if over.get("boundary_exchange") == "shift":
                shift_keys[layout] = graphs_by_epoch[-1]
            if ragged:
                exchanges = [r["after"] for r in runs]
                if not all(x["bit_equal"] for x in exchanges):
                    raise RuntimeError(f"{label}: the kernel's table is not "
                                       "nccl's")
                shift = shift_keys.get(layout)
                if shift is not None and any(
                        g > k for g, k in zip(graphs_by_epoch[-1], shift)):
                    # Recorded, and the run fails at its end: the other
                    # cases still run.
                    more_keys.append(f"{label}: {graphs_by_epoch[-1]} "
                                     f"graphs, the shift case of its "
                                     f"layout {shift}")
                    print(f"{label}: MORE GRAPHS THAN SHIFT: "
                          f"{more_keys[-1]}", flush=True)
            first = runs[0]
            cases[label] = {
                "kind": kind, "exchange": first["exchange"],
                "devices": devices, "step_mode": first["step_mode"],
                "graphs_a_rank": first["graph_counts"],
                "graphs_after_each_epoch": graphs_by_epoch,
                "stack_shapes_new_in_epoch_2": new_shapes,
                "shift_case_graphs": (shift_keys.get(layout) if ragged
                                      else None),
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
    # Every card's name and power limit, one line each.
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps({"cases": cases, "world": WORLD, "backend": "nccl",
                      "more_graphs_than_shift": more_keys,
                      "seconds": time.perf_counter() - start}))
    return 1 if more_keys else 0


if __name__ == "__main__":
    sys.exit(main())

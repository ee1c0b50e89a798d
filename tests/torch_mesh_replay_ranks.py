"""What tests/test_torch_mesh_replay.py runs inside each rank of a gloo
`RankPool` on the CPU: mesh Runners whose steps take the replay path
with fake graphs (tests/torch_fake_card.py), each against a twin whose
steps run eagerly. The ranks import this module by name, so it imports
no JAX."""

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggnn_tpu_torch.parallel.mesh import make_mesh
from ggnn_tpu_torch.training.runner import Runner
from ggnn_tpu_torch.utils.timing import graph_key

import torch_fake_card

torch.set_num_threads(1)


def _runner(variant, config, train, valid, n_data, n_edge, log_dir,
            restore=None):
    return Runner(variant, config, train_data=train, valid_data=valid,
                  log_dir=log_dir, quiet=True, tensorboard=False,
                  mesh=make_mesh(n_data, n_edge, device="cpu"),
                  restore=restore)


def _whole(runner):
    with runner._whole_weights():
        return {n: p.detach().numpy().copy()
                for n, p in runner.params.named_parameters()}


def _recorded_train(runner):
    """`train()` of `runner`, recording every step's loss and MAE by
    split, the whole weights and the train and validation keys after
    each epoch, and the key of each step's stack by split."""
    rec = {"steps": {"train": [], "validation": []}, "weights": [],
           "keys": [], "stack_keys": {"train": set(), "validation": set()}}
    split = []
    runner.summaries.add_batch = (
        lambda name, step, loss, accs, tasks:
        rec["steps"][name].append((float(loss), np.asarray(accs).copy())))
    run_epoch, mesh_stack = runner.run_epoch, runner._mesh_stack

    def epoch(name, processed, is_training):
        split[:] = ["train" if is_training else "validation"]
        out = run_epoch(name, processed, is_training)
        if is_training:
            rec["weights"].append(_whole(runner))
        else:
            rec["keys"].append((sorted(map(repr, runner.train_graphs.graphs)),
                                sorted(map(repr,
                                           runner.eval_graphs.graphs))))
        return out

    def stack(group):
        out = mesh_stack(group)
        rec["stack_keys"][split[0]].add(repr(graph_key(tuple(out))))
        return out

    runner.run_epoch, runner._mesh_stack = epoch, stack
    rec["log"] = runner.train()
    rec["step_mode"] = runner.step_mode
    rec["graph_counts"] = runner.graph_counts()
    for name in rec["stack_keys"]:
        rec["stack_keys"][name] = sorted(rec["stack_keys"][name])
    return rec


def replayed_and_eager(variant, config, train, valid, n_data, n_edge,
                       log_dir):
    """Two mesh Runners of one seed on this rank, each trained by
    `train()`: one whose steps replay fake graphs, one whose steps run
    eagerly (its `step_mode` set to the eager rule's). Returns each's
    record (`_recorded_train`) and the replayed run's captures."""
    with torch_fake_card.fake_card() as captured:
        replayed = _recorded_train(_runner(variant, config, train, valid,
                                           n_data, n_edge, log_dir))
    eager_runner = _runner(variant, config, train, valid, n_data, n_edge,
                           log_dir)
    eager_runner.step_mode = {"mode": "eager", "reason": "the eager twin"}
    with torch_fake_card.fake_card() as eager_captured:
        eager = _recorded_train(eager_runner)
    return {"replayed": replayed, "eager": eager,
            "captured": [(name, repr(key)) for name, key in captured],
            "eager_captured": len(eager_captured)}


def regrown(config, train, valid, n_data, n_edge, log_dir):
    """A node-sharded (1, n_edge) mesh Runner with fake graphs whose local
    lanes are planned for the epoch's first batch alone, trained one
    epoch, so that a later batch regrows them: for each training step,
    whether its stack regrew the capacities and the train keys before
    it, then the keys after the epoch."""
    with torch_fake_card.fake_card():
        runner = _runner("sparse", config, train, valid, n_data, n_edge,
                         log_dir)
        caps = runner._nodeshard_caps
        rng = np.random.RandomState()
        rng.set_state(runner.np_rng.get_state())
        first = next(iter(runner.adapter.batches(runner.train_processed,
                                                 True, rng)))
        need = runner._nodeshard_plan([first], n_edge, margin=1.0,
                                      nodes_local=caps.nodes_local)
        runner._nodeshard_caps = dataclasses.replace(
            caps, edges_local=need.edges_local)
        steps, regrows, training = [], [], [True]
        merge, mesh_stack = runner._merge_grown_caps, runner._mesh_stack
        run_epoch = runner.run_epoch

        def merged(old, grown):
            regrows.append(1)
            return merge(old, grown)

        def stack(group):
            before = len(regrows)
            keys = len(runner.train_graphs.graphs)
            out = mesh_stack(group)
            if training[0]:
                steps.append((len(regrows) > before, keys))
            return out

        def epoch(name, processed, is_training):
            training[0] = is_training
            return run_epoch(name, processed, is_training)

        runner._merge_grown_caps, runner._mesh_stack = merged, stack
        runner.run_epoch = epoch
        runner.train()
    return {"steps": steps, "keys_after": len(runner.train_graphs.graphs),
            "train_keys": sorted(map(repr, runner.train_graphs.graphs))}


def eager_by_rule(variant, config, train, valid, n_data, n_edge, log_dir):
    """A mesh Runner under fake graphs trained by `train()`: its step
    mode, its resolved exchange, its graph counts and what it
    captured."""
    with torch_fake_card.fake_card() as captured:
        runner = _runner(variant, config, train, valid, n_data, n_edge,
                         log_dir)
        log = runner.train()
    return {"step_mode": runner.step_mode,
            "exchange": runner._resolve_exchange(),
            "graph_counts": runner.graph_counts(), "captured": len(captured),
            "loss": log[-1]["train_results"][0]}


class _NoHostRead(TorchDispatchMode):
    """Refuses every read of a tensor's value by the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError(f"a host read: {func}")
        return func(*args, **(kwargs or {}))


def no_host_read(variant, config, train, valid, n_data, n_edge, log_dir):
    """One epoch (train and validation) of a mesh Runner with fake graphs
    whose mesh steps run under a dispatch mode that refuses host reads;
    returns the epoch's train loss and the steps run."""
    calls = []
    with torch_fake_card.fake_card():
        runner = _runner(variant, config, train, valid, n_data, n_edge,
                         log_dir)

        def refusing(step):
            def run(*args, **kwargs):
                calls.append(1)
                with _NoHostRead():
                    return step(*args, **kwargs)
            return run

        runner._mesh_train = refusing(runner._mesh_train)
        runner._mesh_eval = refusing(runner._mesh_eval)
        log = runner.train()
    return {"loss": log[-1]["train_results"][0], "steps": len(calls),
            "step_mode": runner.step_mode}


def predicted_twice(variant, config, train, valid, n_data, n_edge, log_dir,
                    graphs, restore):
    """A mesh Runner with fake graphs restored from `restore`: `predict`
    before and after one training epoch, the collective-free copy's
    identity at each call, the prediction captures, and the best
    checkpoint that epoch wrote."""
    with torch_fake_card.fake_card():
        runner = _runner(variant, config, train, valid, n_data, n_edge,
                         log_dir, restore=restore)
        before = [np.asarray(o) for o in runner.predict(graphs)]
        copy = id(runner._free_params)
        runner.train()
        after = [np.asarray(o) for o in runner.predict(graphs)]
    return {"before": before, "after": after,
            "same_copy": copy == id(runner._free_params),
            "copy_is_runner": runner._free_params is runner.params,
            "predict_graphs": runner.graph_counts()["predict"],
            "best": runner.best_model_file}


def nccl_replay(config, train, valid, log_dir):
    """On the card, in a one-rank nccl world: `sparse` trained by
    `train()` through the plain Runner, the mesh Runner of
    `make_mesh(1, 1)` and its eager twin, under deterministic algorithms
    with TF32 off. Each run's log, weights, graph counts and step
    mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, 1)
    if mesh.backend != "nccl" or mesh.device.type != "cuda":
        raise RuntimeError(f"the mesh runs {mesh.backend} on {mesh.device}")
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label in ("plain", "mesh", "mesh eager"):
            where = ({"device": mesh.device} if label == "plain"
                     else {"mesh": mesh})
            runner = Runner("sparse", config, train_data=train,
                            valid_data=valid, log_dir=log_dir, quiet=True,
                            tensorboard=False, **where)
            if label == "mesh eager":
                runner.step_mode = {"mode": "eager",
                                    "reason": "the eager twin"}
            log = runner.train()
            out[label] = {
                "log": [(e["train_results"][:2], e["valid_results"][:2])
                        for e in log],
                "weights": {n: p.detach().cpu().numpy()
                            for n, p in runner.params.named_parameters()},
                "graph_counts": runner.graph_counts(),
                "step_mode": runner.step_mode}
    finally:
        torch.use_deterministic_algorithms(False)
    return out

"""What the port's mesh tests run inside each rank of a
`ggnn_tpu_torch.parallel.launch.RankPool` (gloo ranks on the CPU, or
sharing a card): one parallel step from given weights and batches, the
single-device step it is held to, and mesh Runners. The ranks import
this module by name, so it imports no JAX."""

import dataclasses

import numpy as np
import torch

from ggnn_tpu_torch.models.base import ModelParams, init_output_heads
from ggnn_tpu_torch.parallel.mesh import make_mesh
from ggnn_tpu_torch.parallel.step import (local_batches,
                                          make_parallel_steps, plan_caps,
                                          stack_for)
from ggnn_tpu_torch.parallel.tp import (is_tp_sharded_path,
                                        shard_parameters, type_range)
from ggnn_tpu_torch.training.optimizer import TFAdam
from ggnn_tpu_torch.training.variants import make_adapter

torch.set_num_threads(1)


@dataclasses.dataclass
class StepCase:
    """One parallel step: the variant and its config and metadata, the
    starting weights {port name: array}, the batches of the global stack
    (numpy), the mesh shape, the step's kind and the exchange layout."""
    variant: str
    config: dict
    meta: object
    weights: dict
    batches: list
    n_data: int
    n_edge: int
    kind: str
    exchange: str = "alltoall"
    combined: bool = False
    device: str = "cpu"
    host_staged: tuple = ()


def rank() -> int:
    """This process's rank in its group."""
    return torch.distributed.get_rank()


def build_params(variant, config, meta, weights, edge_axis=None):
    adapter = make_adapter(variant, config, meta)
    gen = torch.Generator().manual_seed(0)
    model = (adapter.build_model(gen, edge_axis=edge_axis)
             if edge_axis is not None else adapter.build_model(gen))
    params = ModelParams(model, init_output_heads(
        gen, config["hidden_size"], config["task_ids"]))
    params.load_state_dict({k: torch.as_tensor(np.asarray(v))
                            for k, v in weights.items()}, strict=True)
    return params


def global_stack(case: StepCase):
    """The case's stack, built alike on every rank."""
    caps = (plan_caps(case.kind, case.batches, case.n_edge)
            if case.kind in ("sparse", "gcn") and case.n_edge > 1 else None)
    return stack_for(case.kind, case.batches, case.n_data, caps,
                     case.exchange, case.combined)


def step_case(case: StepCase, train: bool = True) -> dict:
    """The mesh step of `case` on this rank: the evaluation metrics, and
    with `train` one train step's metrics and synchronised gradients
    {name: array} (a type-sharded leaf's as its slice) and the types it
    holds."""
    mesh = make_mesh(case.n_data, case.n_edge, device=case.device,
                     host_staged=case.host_staged)
    edge_axis = mesh.edge if case.n_edge > 1 else None
    params = build_params(case.variant, case.config, case.meta,
                          case.weights, edge_axis).to(mesh.device)
    type_tp = case.kind == "sparse_tp" and case.n_edge > 1
    opt = TFAdam(params, case.config["learning_rate"],
                 case.config["clamp_gradient_norm"],
                 tp_axis=mesh.edge if type_tp else None,
                 tp_is_sharded=is_tp_sharded_path if type_tp else None)
    types = None
    if type_tp:
        t_dim = case.meta.num_edge_types
        shard_parameters(params, opt, mesh.edge, t_dim)
        tr = type_range(t_dim, mesh.edge)
        types = (tr.start, tr.stop)
    train_step, eval_step = make_parallel_steps(
        params, opt, case.config, case.config["task_ids"], mesh,
        return_grads=True, batch_kind=case.kind)
    batches = local_batches(global_stack(case), mesh, case.kind)
    out = {"eval": _numpy(eval_step(batches)), "types": types}
    if train:
        gen = torch.Generator(device=mesh.device).manual_seed(1)
        metrics = train_step(batches, gen)
        out["train"] = _numpy({k: v for k, v in metrics.items()
                               if k != "grads"})
        out["grads"] = {n: g.cpu().numpy()
                        for n, g in metrics["grads"].items()}
    return out


def _numpy(metrics):
    return {k: np.asarray(v.detach().cpu()) for k, v in metrics.items()}


def oracle(variant, config, meta, weights, batches, device="cpu"):
    """The single-device global-batch step: (loss, MAE, {name:
    gradient}) of every batch as one batch."""
    from ggnn_tpu_torch.utils.constants import SMALL_NUMBER
    params = build_params(variant, config, meta, weights).to(device)
    abs_s = sq_s = mask_s = 0.0
    for b in batches:
        b = b.to(device)
        final = (params.graph(b) if config["use_graph"]
                 else torch.zeros_like(b.node_features))
        out = params.graph.readout(params.heads, config["task_ids"], final,
                                   b)
        diff = (out - b.targets) * b.target_mask
        abs_s = abs_s + diff.abs().sum(1)
        sq_s = sq_s + (0.5 * diff.square()).sum(1)
        mask_s = mask_s + b.target_mask.sum(1)
    count = mask_s + SMALL_NUMBER
    loss = (sq_s / count).sum()
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return (float(loss.detach()), (abs_s / count).detach().cpu().numpy(),
            {n: (np.zeros(tuple(p.shape), np.float32) if g is None
                 else g.cpu().numpy()) for (n, p), g in zip(named, grads)})


def mesh_runner(variant, config, train, valid, n_data, n_edge, log_dir,
                predict=None, restore=None):
    """A mesh Runner on this rank trained by `train()`: its log, its
    whole weights (gathered under type-TP), its best checkpoint's path,
    the node-shard capacities and, given `predict` graphs, its
    predictions."""
    from ggnn_tpu_torch.training.runner import Runner
    mesh = make_mesh(n_data, n_edge, device="cpu")
    runner = Runner(variant, config, train_data=train, valid_data=valid,
                    log_dir=log_dir, quiet=True, tensorboard=False,
                    mesh=mesh, restore=restore)
    log = runner.train()
    with runner._whole_weights():
        weights = {n: p.detach().numpy().copy()
                   for n, p in runner.params.named_parameters()}
    out = {"log": log, "weights": weights, "best": runner.best_model_file,
           "caps": runner._nodeshard_caps, "kind": runner._mesh_kind,
           "exchange": (runner._resolve_exchange()
                        if runner._nodeshard_caps is not None else None),
           "train_step_id": runner.train_step_id}
    if predict is not None:
        out["predict"] = [np.asarray(o) for o in runner.predict(predict)]
    return out


def runner_raises(variant, config, train, valid, n_data, n_edge, log_dir,
                  restore=None, call="train"):
    """The error a mesh Runner raises from `call` ("train" or
    "train_on_device"), as (type name, message), or None."""
    from ggnn_tpu_torch.training.runner import Runner
    mesh = make_mesh(n_data, n_edge, device="cpu")
    try:
        runner = Runner(variant, config, train_data=train,
                        valid_data=valid, log_dir=log_dir, quiet=True,
                        tensorboard=False, mesh=mesh, restore=restore)
        if call == "train":
            runner.train()
        else:
            runner.train_on_device(1)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    return None


def regrow_case(config, train, valid, n_data, n_edge, log_dir):
    """A node-sharded mesh Runner whose lanes are planned too small
    (edges_local 8): one epoch grows them. Returns (the sabotaged
    edges_local, the grown one, the epoch's train loss)."""
    from ggnn_tpu_torch.training.runner import Runner
    mesh = make_mesh(n_data, n_edge, device="cpu")
    runner = Runner("sparse", config, train_data=train, valid_data=valid,
                    log_dir=log_dir, quiet=True, tensorboard=False,
                    mesh=mesh)
    runner._nodeshard_caps = dataclasses.replace(runner._nodeshard_caps,
                                                 edges_local=8)
    log = runner.train()
    return 8, runner._nodeshard_caps.edges_local, log[0]["train_results"][0]


def mesh_orbax_save(variant, config, train, valid, n_data, n_edge, log_dir,
                    path):
    """A mesh Runner on this rank trained by `train()`, then saved to the
    Orbax directory `path` through `Runner._save` (every rank calls it):
    how many checkpoints this rank wrote, the mesh kind and its whole
    weights."""
    from ggnn_tpu_torch.training import runner as runner_mod
    from ggnn_tpu_torch.training.runner import Runner
    mesh = make_mesh(n_data, n_edge, device="cpu")
    runner = Runner(variant, config, train_data=train, valid_data=valid,
                    log_dir=log_dir, quiet=True, tensorboard=False,
                    mesh=mesh)
    runner.train()
    wrote = []
    save = runner_mod.save_checkpoint
    runner_mod.save_checkpoint = lambda p, *a, **k: (wrote.append(p),
                                                     save(p, *a, **k))
    try:
        runner._save(path)
    finally:
        runner_mod.save_checkpoint = save
    with runner._whole_weights():
        weights = {n: p.detach().numpy().copy()
                   for n, p in runner.params.named_parameters()}
    return {"wrote": len(wrote), "kind": runner._mesh_kind,
            "weights": weights}

"""Training runner — the reference's `ChemModel` training framework, for
one device.

The port of the single-device path of `ggnn_tpu/training/runner.py`
(chem_tensorflow.py:39-307):
  * run id `<timestamp>_<pid>`, resolved-config archive
    (`<run_id>_params.json`), per-epoch JSON log rewritten in place
    (`<run_id>_log.json`);
  * epoch runner with threaded batch prefetch, graph-weighted loss/MAE
    accumulation, `error_ratio = MAE / chemical_accuracy`, instances/s
    and the edge-messages/s counter;
  * outer loop with patience-based early stopping on the summed
    validation MAE, best-model checkpointing (Adam state included),
    restore-then-revalidate, optional per-epoch rolling checkpoint;
  * `use_graph=False` ablation (zeroes the propagated states);
  * `--freeze-graph-model` (graph subtree excluded from updates);
  * mid-epoch resume: every `checkpoint_every_steps` training steps the
    rolling checkpoint also holds the iterator state (epoch, steps
    consumed, the numpy RNG state as of the epoch's start and the
    dropout generator's state), and a restore from it replays the
    epoch's batch stream, drops the consumed batches and continues;
  * TensorBoard scalars (training/summaries.py), written after the
    epoch's one device-to-host copy;
  * `profile_dir`: a `torch.profiler` Chrome trace of epoch 1's
    training epoch;
  * `predict` and `example_evaluation` (sparse.py:364-376).

It runs on the GPU unless the caller passes `device="cpu"`, and without
CUDA it raises. The numpy stream is the JAX Runner's:
`np.random.RandomState(random_seed)` shuffles the preprocessed training
split once, then each epoch's pack, so with the same seed both Runners
see the same batches in the same order. Dropout masks come from a
`torch.Generator` on the run's device and differ from the JAX masks by
design; initial weights come from a CPU `torch.Generator`, so a run
starts from the same weights on either device. Only training steps draw
from the generator (validation and prediction run with every keep
probability at 1.0), so a resumed run that restores the generator's
state replays the uninterrupted run's dropout masks. A generator state
saved on another device type (or none, as in a JAX checkpoint) does not
fit, and the resumed run keeps its seeded stream.

Where the JAX Runner jits a step, the port replays it on the card
(`utils/timing.py:StepCache`): the train and validation steps of
`run_epoch` and `predict`'s forward are each captured once per batch
shape into a CUDA graph, after one eager warm-up step, and replayed; on
the CPU they run eagerly. `train_on_device` is the JAX Runner's compiled
fast path: the training split packed once, every epoch's steps replayed
from the same train-step graphs (`make_epochs_fn`'s `EpochsFn`), with
one host read at the end.

`Runner(..., mesh=make_mesh(n_data, n_edge))` trains on the (data, edge)
mesh (parallel/, the JAX Runner's mesh paths, `ggnn_tpu/training/
runner.py:136-200` and `:435-758`). Every rank builds the same Runner:
it packs the same epoch from the same RandomState, groups n_data batches
a step (topped up with no-op fillers) and takes its own row, so no batch
crosses ranks. The kind follows the variant and the config as in JAX:
data parallelism for every variant; on an edge axis, `sparse`/`rgcn`
node-sharded (`boundary_exchange`, default "alltoall") or type-TP
(`"edge_parallelism": "type_tp"`) and `gcn` node-sharded, the shard
capacities planned from a dry pack of both splits and grown mid-epoch
when a group overflows them. The epoch's metrics are global. Rank 0
alone prints, writes the log, the summaries and the checkpoints (at
epoch granularity; a type-TP checkpoint gathers the whole weights
first, on every rank). A mid-epoch iterator state restored into a mesh
Runner raises when its epoch starts, and `train_on_device` on a mesh
raises. `predict` runs a collective-free copy of the model, built once
and refreshed in place from the whole weights before each call; under
type-TP gathering them is collective, so every rank calls it.

A mesh Runner's train and validation steps, collectives included, go
through its graph caches as the single-device steps do (JAX jits them,
`ggnn_tpu/parallel/step.py:191-209`): on the card one CUDA graph a rank
for each shape of the step's whole stack, so every rank captures the
same keys at the same step; its prediction forward too. The ragged
boundary exchange ("auto" on nccl) replays too: over nccl it is a
hand-written ragged all-to-all through peer memory that reads its
per-pair sizes on the card (parallel/node_shard.py), its peer buffers
reserved before a new key's capture (`_reserve_peer_buffers`). One mesh
runs its steps eagerly instead, for a stated reason (`mesh_eager_reason`,
reported as `step_mode`): gloo ranks on a card (gloo copies CUDA tensors
through the host, which a graph cannot hold).
"""

import contextlib
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ggnn_tpu_torch.data import native_pack
from ggnn_tpu_torch.data.loader import infer_metadata, load_graphs_json
from ggnn_tpu_torch.data.packing import DEFAULT_PACK_MARGIN
from ggnn_tpu_torch.data.reorder import dfs_reorder
from ggnn_tpu_torch.graph import (AsyncGraphBatch, DenseGraphBatch,
                                  GCNGraphBatch)
from ggnn_tpu_torch.models.base import (ModelParams, init_output_heads,
                                        masked_regression_loss, task_rescale)
from ggnn_tpu_torch.ops.kernels import ragged_exchange
from ggnn_tpu_torch.parallel import tp
from ggnn_tpu_torch.parallel.mesh import DATA_AXIS, EDGE_AXIS
from ggnn_tpu_torch.parallel.node_shard import RaggedSendSpec
from ggnn_tpu_torch.parallel.step import (local_batches, local_rows,
                                          make_parallel_steps, plan_caps,
                                          rank_generator, stack_for)
from ggnn_tpu_torch.training.checkpoint import (load_iterator_state,
                                                restore_checkpoint,
                                                save_checkpoint)
from ggnn_tpu_torch.training.optimizer import TFAdam
from ggnn_tpu_torch.training.summaries import SummarySink
from ggnn_tpu_torch.training.variants import make_adapter
from ggnn_tpu_torch.utils.constants import CHEMICAL_ACCURACIES
from ggnn_tpu_torch.utils.device import resolve_device
from ggnn_tpu_torch.utils.prefetch import ThreadedIterator
from ggnn_tpu_torch.utils.timing import (EpochsFn, GraphPool, StepCache,
                                         graph_key, shape_groups)


# (backend, device type) pairs with a ragged transport: "auto" resolves
# to the ragged exchange there. nccl on cards runs the hand-written peer
# memory exchange, gloo its all_to_all_single with host split sizes
# (gloo on the card measured on an H100, torch 2.11).
RAGGED_TRANSPORTS = {("nccl", "cuda"), ("gloo", "cpu"), ("gloo", "cuda")}


def mesh_eager_reason(backend: Optional[str],
                      device_type: str) -> Optional[str]:
    """Why a mesh Runner's train and validation steps run eagerly, or
    None where they go through its graph caches (CUDA graphs on the
    card; on the CPU a cache runs each step eagerly). The rule's only
    case: gloo ranks on a card, since gloo copies CUDA tensors through
    the host (parallel/mesh.py), which a captured graph cannot hold.
    Every boundary exchange replays over nccl, the ragged one included
    (its split sizes stay on the card)."""
    if backend == "gloo" and device_type == "cuda":
        return ("gloo on a card: gloo copies CUDA tensors through the "
                "host, which a CUDA graph cannot hold")
    return None


def _batch_edge_count(batch) -> float:
    """Real (unpadded) edge count of one numpy batch: the GCN's counts
    its COO rows, self-loops included, and the async one its real
    message slots over the rounds (each edge fires once a round), as the
    JAX Runner does."""
    if isinstance(batch, DenseGraphBatch):
        if isinstance(batch.adjacency, torch.Tensor):  # the bf16 one
            return float(torch.count_nonzero(batch.adjacency))
        return float(np.count_nonzero(batch.adjacency))
    if isinstance(batch, GCNGraphBatch):
        return float(np.count_nonzero(batch.edge_weights))
    if isinstance(batch, AsyncGraphBatch):
        targets = np.asarray(batch.msg_targets)
        rc_cap = batch.receiving_nodes.shape[-1]
        return float((targets < rc_cap).sum()) / max(targets.shape[0], 1)
    return float(np.asarray(batch.edge_mask).sum())


def mesh_kind(variant: str, config: Dict, mesh,
              num_edge_types: int) -> str:
    """The mesh step's `batch_kind` for a variant, as the JAX Runner picks
    it (`ggnn_tpu/training/runner.py:136-200`): `sparse`/`rgcn`
    node-sharded ("sparse") or type-TP ("sparse_tp") on an edge axis,
    by `edge_parallelism`; `gcn` node-sharded on an edge axis ("gcn"),
    else "data_only"; the dense family "dense" and `async` "data_only",
    both data-parallel only."""
    n_edge = mesh.shape[EDGE_AXIS]
    if variant in ("sparse", "rgcn"):
        if (n_edge > 1 and config.get("edge_parallelism",
                                      "node_shard") == "type_tp"):
            tp.validate_tp(num_edge_types, n_edge)
            return "sparse_tp"
        return "sparse"
    if variant in ("dense", "blocked", "gcn_blocked"):
        if n_edge > 1:
            raise ValueError("dense-family mesh training is data-parallel "
                             "only (use n_edge=1)")
        return "dense"
    if variant == "gcn":
        return "gcn" if n_edge > 1 else "data_only"
    if n_edge > 1:
        raise ValueError(f"{variant} mesh training is data-parallel only "
                         "(use n_edge=1)")
    return "data_only"


class Runner:
    def __init__(self, variant: str, config: Dict, *,
                 data_dir: str = "", log_dir: str = ".",
                 restore: Optional[str] = None,
                 freeze_graph_model: bool = False,
                 train_data: Optional[List] = None,
                 valid_data: Optional[List] = None,
                 restrict_data: Optional[int] = None,
                 quiet: bool = False,
                 tensorboard: bool = True,
                 profile_dir: Optional[str] = None,
                 save_every_epoch: bool = False,
                 checkpoint_every_steps: int = 0,
                 device=None, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"a mesh Runner computes on its mesh's "
                                 f"device {mesh.device}, not {device}")
            self.device = mesh.device
        # Rank 0 alone prints and writes.
        self.is_chief = mesh is None or mesh.rank == 0
        quiet = quiet or not self.is_chief
        self.variant = variant
        self.config = config
        self.quiet = quiet
        self.data_dir = data_dir
        self.task_ids = list(config["task_ids"])

        # Run management (chem_tensorflow.py:48-54).
        self.run_id = "_".join([time.strftime("%Y-%m-%d-%H-%M-%S"),
                                str(os.getpid())])
        os.makedirs(log_dir, exist_ok=True)
        self.log_file = os.path.join(log_dir, f"{self.run_id}_log.json")
        self.best_model_file = os.path.join(
            log_dir, f"{self.run_id}_model_best.pickle")
        self.last_model_file = os.path.join(
            log_dir, f"{self.run_id}_model_last.pickle")
        if self.is_chief:
            with open(os.path.join(log_dir, f"{self.run_id}_params.json"),
                      "w") as f:
                json.dump(config, f)
        # TB scalars under <log_dir>/tb/<run_id>/{train,validation}
        # (chem_tensorflow.py:53-54,101-102).
        self.summaries = SummarySink(log_dir, self.run_id,
                                     enabled=tensorboard and self.is_chief)
        if not quiet:
            print(f"Run {self.run_id} starting with following parameters:\n"
                  f"{json.dumps(config)}")

        seed = config["random_seed"]
        self.np_rng = np.random.RandomState(seed)

        # Data loading + metadata inference (chem_tensorflow.py:104-123).
        if train_data is None:
            train_data = load_graphs_json(
                os.path.join(data_dir, config["train_file"]), restrict_data)
        if valid_data is None:
            valid_data = load_graphs_json(
                os.path.join(data_dir, config["valid_file"]), restrict_data)
        if config.get("locality_reorder", False):
            # DFS-preorder relabelling (data/reorder.py): shrinks a giant
            # graph's contiguous-range cut, and so the node shards'
            # exchange; results are unchanged. Off by default.
            train_data = [dfs_reorder(g) for g in train_data]
            valid_data = [dfs_reorder(g) for g in valid_data]
        self.meta = infer_metadata([train_data, valid_data],
                                   config["tie_fwd_bkwd"])
        self.adapter = make_adapter(variant, config, self.meta)
        self.train_processed = self.adapter.preprocess(
            train_data, True, self.np_rng)
        self.valid_processed = self.adapter.preprocess(valid_data, False)
        self.adapter.plan(self.train_processed, self.valid_processed)

        self._mesh_kind = (None if mesh is None else mesh_kind(
            variant, config, mesh, self.meta.num_edge_types))
        self.generator = (
            torch.Generator(device=self.device).manual_seed(seed)
            if mesh is None else rank_generator(seed, mesh, self._mesh_kind))

        # Model + parameters, drawn on the CPU, then moved.
        init_gen = torch.Generator().manual_seed(seed)
        if mesh is not None and mesh.shape[EDGE_AXIS] > 1 and \
                self._mesh_kind in ("sparse", "sparse_tp", "gcn"):
            self.model = self.adapter.build_model(init_gen,
                                                  edge_axis=mesh.edge)
        else:
            self.model = self.adapter.build_model(init_gen)
        self.params = ModelParams(
            self.model, init_output_heads(init_gen, config["hidden_size"],
                                          self.task_ids)).to(self.device)
        if freeze_graph_model:
            self.params.graph.requires_grad_(False)
        self._type_tp = (self._mesh_kind == "sparse_tp"
                         and mesh.shape[EDGE_AXIS] > 1)
        self.optimizer = TFAdam(
            self.params, config["learning_rate"],
            config["clamp_gradient_norm"], freeze_graph_model,
            tp_axis=mesh.edge if self._type_tp else None,
            tp_is_sharded=tp.is_tp_sharded_path if self._type_tp else None)
        # The loss's per-task weights, made once: a captured step cannot
        # copy them from the host.
        self.loss_rescale = task_rescale(
            self.task_ids, config["task_sample_ratios"], self.device)
        # The steps JAX jits (`ggnn_tpu/training/runner.py:276-278`,
        # `:954-966`), each a cache of CUDA graphs on the card (one a
        # batch shape) and eager on the CPU: the train step (the
        # parameters, Adam's state and the dropout generator its state),
        # the validation step and `predict`'s forward. Apart, because a
        # training and a validation batch can share a shape; one pool,
        # because they replay strictly in turn.
        self._graph_pool = graph_pool = GraphPool()
        self.train_graphs = StepCache(
            lambda batch: self.train_step(batch), self.device,
            state=[*self.params.parameters(),
                   *self.optimizer.state_tensors()],
            generators=[self.generator], pool=graph_pool, name="train step")
        self.eval_graphs = StepCache(
            lambda batch: self.eval_step(batch), self.device,
            generators=[self.generator], pool=graph_pool,
            name="validation step")
        self.predict_graphs = StepCache(
            lambda batch: self._predict_step(batch), self.device,
            generators=[self.generator], pool=graph_pool,
            name="prediction forward")
        # train_on_device's epochs function over the train step's graphs,
        # and the kernel launches a replay of each step of its last call
        # held ({"module.counter": n}, in step order; None on the CPU).
        self._epochs_fn = EpochsFn(self.train_graphs)
        self.replay_launches = None

        self.profile_dir = profile_dir
        self.save_every_epoch = save_every_epoch
        self.checkpoint_every_steps = int(checkpoint_every_steps)
        self.train_step_id = 0
        self.valid_step_id = 0
        # The restored iterator state, the current epoch's (epoch, numpy
        # RNG state at its start) and the batches of the resumed epoch
        # to drop.
        self._resume_iter = None
        self._epoch_iter_ctx = None
        self._skip_steps = 0
        if restore is not None:
            _, self.train_step_id, self.valid_step_id = restore_checkpoint(
                restore, config, self.params, optimizer=self.optimizer,
                variant=variant, num_edge_types=self.meta.num_edge_types)
            self._resume_iter = load_iterator_state(restore)
        self.restored = restore is not None
        self._nodeshard_caps = None
        # How the steps run: "replayed" through the caches, or "eager"
        # for `reason` (a mesh, `mesh_eager_reason`).
        self.step_mode = {"mode": "replayed", "reason": None}
        # predict's collective-free copy of an edge-axis mesh's model,
        # built at the first prediction.
        self._free_params = None
        if mesh is not None:
            self._setup_mesh()

        # Propagation steps per forward: the edge-messages/s multiplier.
        if "layer_timesteps" in config:
            self.prop_steps = int(sum(config["layer_timesteps"]))
        elif variant == "async":
            self.prop_steps = int(config["propagation_rounds"])
        else:
            self.prop_steps = int(config["num_timesteps"])
        self.last_edge_msg_per_sec = None

    # -------------------------------------------------------------- mesh

    def _setup_mesh(self) -> None:
        """The type-TP slices, the node-shard capacities and the mesh
        steps (JAX's `Runner.__init__`, `ggnn_tpu/training/runner.py:
        243-274`)."""
        mesh, kind = self.mesh, self._mesh_kind
        n_edge = mesh.shape[EDGE_AXIS]
        if self._type_tp:
            tp.shard_parameters(self.params, self.optimizer, mesh.edge,
                                self.meta.num_edge_types)
        if kind in ("sparse", "gcn") and n_edge > 1:
            # Size the shards' lanes and exchange buffers from a dry pack
            # of both splits.
            self._nodeshard_caps = self._nodeshard_plan(
                itertools.chain(
                    self.adapter.batches(self.train_processed, False),
                    self.adapter.batches(self.valid_processed, False)),
                n_edge)
        # A data-parallel sparse mesh keeps the type-combined lane: each
        # rank runs the single-device layout.
        caps = getattr(self.adapter, "caps", None)
        self._dp_combined = bool(kind == "sparse" and n_edge == 1
                                 and getattr(caps, "edges_all", 0) > 0)
        self._mesh_train, self._mesh_eval = make_parallel_steps(
            self.params, self.optimizer, self.config, self.task_ids, mesh,
            batch_kind=kind)
        reason = mesh_eager_reason(mesh.backend, mesh.device.type)
        if reason is not None:
            self.step_mode = {"mode": "eager", "reason": reason}
        if mesh.backend == "nccl":
            # nccl makes a group's communicator at its first collective,
            # on the host: one eager all-reduce a group here, so that no
            # step's warm-up or capture makes one.
            for axis in (mesh.world, mesh.data, mesh.edge):
                axis.all_reduce(torch.zeros(1, device=self.device))
        # The mesh steps' caches, made after the type-TP slicing: the
        # train step's state is the sliced parameters and moments. A
        # batch is this rank's rows and its graph count ([1], float32),
        # the key the whole stack's, alike on every rank.
        self.train_graphs = StepCache(
            lambda batch: self._mesh_step(batch, True), self.device,
            state=[*self.params.parameters(),
                   *self.optimizer.state_tensors()],
            generators=[self.generator], pool=self._graph_pool,
            name="mesh train step")
        self.eval_graphs = StepCache(
            lambda batch: self._mesh_step(batch, False), self.device,
            pool=self._graph_pool, name="mesh validation step")

    def _mesh_step(self, batch, is_training: bool):
        """One mesh step on (rows, graph count) on the device: (loss,
        MAE, global graph count)."""
        rows, graphs = batch
        if is_training:
            metrics = self._mesh_train(list(rows), self.generator,
                                       num_graphs=graphs)
        else:
            metrics = self._mesh_eval(list(rows), num_graphs=graphs)
        return metrics["loss"], metrics["accuracies"], metrics["num_graphs"]

    def _nodeshard_plan(self, batches, n_shards, margin=None,
                        nodes_local=None):
        """The node-shard capacities of the variant's layout over
        `batches`, at the packers' margin (`pack_margin`, default 1.05);
        `nodes_local` pins the per-shard node range to the active caps'
        (a replan over some batches is only comparable to them under the
        same owner arithmetic)."""
        if margin is None:
            margin = self.config.get("pack_margin") or DEFAULT_PACK_MARGIN
        return plan_caps(self._mesh_kind, batches, n_shards, margin=margin,
                         nodes_local=nodes_local)

    def _resolve_exchange(self) -> str:
        """`boundary_exchange` ("alltoall" by default); "auto" picks from
        the mesh's backend and device, as JAX picks from the platform:
        "ragged" where the backend has a ragged transport on that device
        (`RAGGED_TRANSPORTS`), "shift" elsewhere."""
        exchange = self.config.get("boundary_exchange", "alltoall")
        if exchange == "auto":
            return ("ragged" if (self.mesh.backend, self.mesh.device.type)
                    in RAGGED_TRANSPORTS else "shift")
        return exchange

    def _reserve_peer_buffers(self, stack) -> None:
        """Grow the edge axis' peer buffers (the ragged exchange over
        nccl) to this stack's receive table and send pack
        (`ragged_exchange.buffer_rows`), rows of the widest state
        the model exchanges in f32, before its step: a new key's warm-up
        and capture must not grow them (it is collective and reads the
        host). All ranks hold the same stack, so all grow at once."""
        spec = getattr(stack[0], "send_idx", None)
        if not isinstance(spec, RaggedSendSpec) or \
                self.mesh.backend != "nccl":
            return
        width = max(int(stack[0].node_features.shape[-1]),
                    int(self.config["hidden_size"]))
        self.mesh.edge.reserve_peer_buffers(
            ragged_exchange.buffer_rows(spec), 4 * width, self.device)

    @staticmethod
    def _merge_grown_caps(old, grown):
        """The elementwise max of two NodeShardCaps: capacities only grow,
        so a later regrow never shrinks a lane an earlier group needed."""
        return dataclasses.replace(
            grown,
            nodes_local=max(grown.nodes_local, old.nodes_local),
            edges_local=max(grown.edges_local, old.edges_local),
            edges_boundary=max(grown.edges_boundary, old.edges_boundary),
            boundary=max(grown.boundary, old.boundary),
            boundary_send_total=max(grown.boundary_send_total,
                                    old.boundary_send_total),
            boundary_recv_total=max(grown.boundary_recv_total,
                                    old.boundary_recv_total),
            boundary_shifts=tuple(
                max(g, o) for g, o in zip(grown.boundary_shifts,
                                          old.boundary_shifts)))

    def _mesh_stack(self, group):
        """The stack of one step's group (n_data batches or fewer), every
        rank alike: each rank shards and stacks the whole group, so a
        capacity regrow happens on every rank at once."""
        def stack(caps):
            return stack_for(self._mesh_kind, group,
                             self.mesh.shape[DATA_AXIS], caps,
                             self._resolve_exchange(), self._dp_combined)

        if self._nodeshard_caps is None:
            return stack(None)
        try:
            return stack(self._nodeshard_caps)
        except ValueError:
            # A reshuffled epoch packed this group past the planned lane
            # or exchange capacities: grow them to cover it (margin
            # included) and shard again. No nodes_local pin first: a
            # batch past the whole S x Nl layout needs a wider range.
            old = self._nodeshard_caps
            grown = self._nodeshard_plan(group, old.n_shards)
            if grown.nodes_local < old.nodes_local:
                grown = self._nodeshard_plan(group, old.n_shards,
                                             nodes_local=old.nodes_local)
            self._nodeshard_caps = self._merge_grown_caps(old, grown)
            if not self.quiet:
                print(f"[node-shard] capacity overflow; regrew {old} -> "
                      f"{self._nodeshard_caps}")
            return stack(self._nodeshard_caps)

    def _run_epoch_mesh(self, epoch_name: str, processed,
                        is_training: bool):
        """One epoch on the mesh: steps of n_data batches, this rank's row
        of each; returns what `run_epoch` returns, global."""
        if is_training and self._skip_steps:
            # Mesh epochs consume groups: "skip k single-device steps" has
            # no aligned meaning, and retraining consumed batches would
            # count their gradients twice.
            raise ValueError(
                "restored a mid-epoch iterator state into a mesh Runner: "
                "mesh epochs checkpoint at epoch granularity only. "
                "Resume this checkpoint single-device to finish the "
                "interrupted epoch, or resume from an epoch-boundary "
                "checkpoint on the mesh.")
        mesh = self.mesh
        n_data = mesh.shape[DATA_AXIS]
        chem_acc = CHEMICAL_ACCURACIES[self.task_ids]
        split = "train" if is_training else "validation"
        step_base = self.train_step_id if is_training else self.valid_step_id
        start_time = time.time()
        batch_iter = ThreadedIterator(
            self.adapter.batches(processed, is_training,
                                 self.np_rng if is_training else None),
            max_queue_size=3 * n_data)
        step_metrics = []
        processed_edges = 0.0
        total_loss, shown_graphs = 0.0, 0

        def run_group(group):
            nonlocal processed_edges, total_loss, shown_graphs
            processed_edges += sum(_batch_edge_count(b) for b in group)
            stack = self._mesh_stack(group)
            if self.step_mode["mode"] == "eager":
                batches = local_batches(stack, mesh, self._mesh_kind)
                if is_training:
                    metrics = self._mesh_train(batches, self.generator)
                else:
                    metrics = self._mesh_eval(batches)
            else:
                rows = local_rows(stack, mesh, self._mesh_kind)
                graphs = np.asarray(
                    [sum(int(b.num_graphs) for b in rows)], np.float32)
                cache = self.train_graphs if is_training else \
                    self.eval_graphs
                self._reserve_peer_buffers(stack)
                loss, accs, count = cache((rows, graphs),
                                          key=graph_key(tuple(stack)))
                metrics = {"loss": loss, "accuracies": accs,
                           "num_graphs": count}
            step_metrics.append(metrics)
            if not self.quiet:
                graphs = int(metrics["num_graphs"])
                total_loss += float(metrics["loss"]) * graphs
                shown_graphs += graphs
                print(f"Running {epoch_name}, step {len(step_metrics)} "
                      f"(has {graphs} graphs). Loss so far: "
                      f"{total_loss / max(shown_graphs, 1):.4f}", end="\r")

        group = []
        for batch in batch_iter:
            group.append(batch)
            if len(group) == n_data:
                run_group(group)
                group = []
        if group:
            run_group(group)   # the stack tops it up with fillers
        processed_graphs = 0
        if step_metrics:
            # One device-to-host copy for the epoch.
            losses = torch.stack([m["loss"] for m in step_metrics]
                                 ).cpu().numpy()
            accs_all = torch.stack([m["accuracies"] for m in step_metrics]
                                   ).cpu().numpy()
            counts = torch.stack([m["num_graphs"] for m in step_metrics]
                                 ).cpu().numpy().astype(np.float64)
            processed_graphs = int(counts.sum())
            for i, (loss, accs) in enumerate(zip(losses, accs_all)):
                self.summaries.add_batch(split, step_base + i, float(loss),
                                         accs, self.task_ids)
        if processed_graphs == 0:
            raise RuntimeError(f"{epoch_name}: no batches produced")
        mean_loss = float(np.sum(losses * counts)) / processed_graphs
        accuracies = np.sum(accs_all * counts[:, None],
                            axis=0) / processed_graphs
        elapsed = time.time() - start_time
        self.last_edge_msg_per_sec = (
            processed_edges * self.prop_steps / elapsed
            if processed_edges else None)
        return (mean_loss, accuracies, accuracies / chem_acc,
                processed_graphs / elapsed, len(step_metrics))

    # ------------------------------------------------------------- steps

    def _outputs(self, batch, is_training: bool,
                 params: Optional[ModelParams] = None) -> torch.Tensor:
        """Per-task predictions [K, G] of one batch on the device, by
        `params` (the Runner's by default)."""
        params = self.params if params is None else params
        if self.config["use_graph"]:
            final = params.graph(batch, is_training=is_training,
                                 generator=self.generator)
        else:
            # Ablation: zero the propagated states
            # (chem_tensorflow.py:144-147).
            final = torch.zeros_like(batch.node_features)
        keep = (self.config["out_layer_dropout_keep_prob"]
                if is_training else 1.0)
        return params.graph.readout(params.heads, self.task_ids, final,
                                    batch, keep_prob=keep,
                                    generator=self.generator)

    def _loss_fn(self, batch, is_training: bool):
        """(loss [], per-task MAE [K]) of one batch on the device."""
        return masked_regression_loss(
            self._outputs(batch, is_training), batch.targets,
            batch.target_mask, self.task_ids,
            self.config["task_sample_ratios"], self.loss_rescale)

    def loss_and_grads(self, batch):
        """(loss, MAE, {name: gradient}) of one training batch, the
        gradients of the optimizer's trainable parameters."""
        loss, accs = self._loss_fn(batch, True)
        names = list(self.optimizer.params)
        grads = torch.autograd.grad(
            loss, [self.optimizer.params[n] for n in names],
            allow_unused=True)
        return loss.detach(), accs.detach(), dict(zip(names, grads))

    def train_step(self, batch):
        """One update on a batch on the device; returns (loss, MAE)."""
        loss, accs, grads = self.loss_and_grads(batch)
        self.optimizer.step(grads)
        return loss, accs

    def eval_step(self, batch):
        with torch.no_grad():
            return self._loss_fn(batch, False)

    def _predict_step(self, batch) -> torch.Tensor:
        with torch.no_grad():
            return self._outputs(batch, False, self._free_params)

    def graph_counts(self) -> Dict[str, int]:
        """The CUDA graphs captured so far (0 on the CPU): train steps,
        validation steps, prediction forwards (a mesh Runner's on this
        rank; `step_mode` says whether its steps replay, and if not,
        why)."""
        return {"train": len(self.train_graphs.graphs),
                "validation": len(self.eval_graphs.graphs),
                "predict": len(self.predict_graphs.graphs)}

    # ------------------------------------------------------------- epochs

    def run_epoch(self, epoch_name: str, processed, is_training: bool):
        """Returns (loss, accuracies, error_ratios, instances/sec, steps)."""
        if self.mesh is not None:
            return self._run_epoch_mesh(epoch_name, processed, is_training)
        chem_acc = CHEMICAL_ACCURACIES[self.task_ids]
        # Each step a replay on the card (its batch copied from the host
        # into the graph's buffers; the loss and MAE cloned, as the next
        # replay overwrites them), eager on the CPU.
        step_fn = self.train_graphs if is_training else self.eval_graphs
        start_time = time.time()
        batch_iter = ThreadedIterator(
            self.adapter.batches(processed, is_training,
                                 self.np_rng if is_training else None),
            max_queue_size=5)
        split = "train" if is_training else "validation"
        step_base = self.train_step_id if is_training else self.valid_step_id
        # Per-step metrics stay on the device until the epoch ends (one
        # copy for the whole epoch); the verbose progress line reads the
        # loss every batch.
        step_metrics = []
        graph_counts = []
        processed_graphs = 0
        processed_edges = 0.0
        total_loss = 0.0
        # Mid-epoch resume: train() reset np_rng to the epoch's start, so
        # the batch stream is the interrupted epoch's; drop the batches
        # it consumed (dropping, not slicing the processed data, draws
        # the numpy stream as the uninterrupted epoch did).
        skip_steps = 0
        if is_training:
            skip_steps, self._skip_steps = self._skip_steps, 0
        for step, batch in enumerate(batch_iter):
            if step < skip_steps:
                continue
            num_graphs = int(batch.num_graphs)
            processed_graphs += num_graphs
            processed_edges += _batch_edge_count(batch)
            loss, accs = step_fn(batch)
            step_metrics.append((loss, accs))
            graph_counts.append(num_graphs)
            if not self.quiet:
                total_loss += float(loss) * num_graphs
                print(f"Running {epoch_name}, batch {step} (has {num_graphs} "
                      f"graphs). Loss so far: "
                      f"{total_loss / processed_graphs:.4f}", end="\r")
            steps = len(step_metrics)
            if (is_training and self.checkpoint_every_steps
                    and self._epoch_iter_ctx is not None
                    and steps % self.checkpoint_every_steps == 0):
                self._save(self.last_model_file, self.train_step_id + steps,
                           iterator_state={
                               **self._epoch_iter_ctx,
                               "steps_done": skip_steps + steps,
                               "torch_generator_state":
                                   self.generator.get_state().numpy(),
                               "torch_generator_device": self.device.type})
        if processed_graphs == 0:
            hint = ("the corpus split is empty — check the data files "
                    "and any --restrict_data truncation.")
            if getattr(self.adapter, "drop_remainder", False):
                hint = ("with the dense variant's reference-compatible "
                        "remainder dropping, every bucket needs at least "
                        "batch_size graphs (set config \"drop_remainder\": "
                        "false — or use the `blocked` variant — to "
                        "process all).")
            raise RuntimeError(
                f"{epoch_name}: no batches produced — {hint}")
        losses = torch.stack([m[0] for m in step_metrics]).cpu().numpy()
        accs_all = torch.stack([m[1] for m in step_metrics]).cpu().numpy()
        for i, (loss, accs) in enumerate(zip(losses, accs_all)):
            self.summaries.add_batch(split, step_base + i, float(loss), accs,
                                     self.task_ids)
        counts = np.asarray(graph_counts, dtype=np.float64)
        mean_loss = float(np.sum(losses * counts)) / processed_graphs
        accuracies = np.sum(accs_all * counts[:, None],
                            axis=0) / processed_graphs
        error_ratios = accuracies / chem_acc
        elapsed = time.time() - start_time
        instance_per_sec = processed_graphs / elapsed
        # Real edge-messages across all propagation steps per second.
        self.last_edge_msg_per_sec = (
            processed_edges * self.prop_steps / elapsed
            if processed_edges else None)
        return (mean_loss, accuracies, error_ratios, instance_per_sec,
                len(step_metrics))

    # ------------------------------------------------------------- train

    def _report(self, split, loss, accs, errs, speed, edges=None):
        if self.quiet:
            return
        accs_str = " ".join(f"{i}:{a:.5f}" for i, a in
                            zip(self.task_ids, accs))
        errs_str = " ".join(f"{i}:{e:.5f}" for i, e in
                            zip(self.task_ids, errs))
        edge_str = "" if edges is None else f" | edge-msg/s: {edges:.3g}"
        print(f"\r\x1b[K {split}: loss: {loss:.5f} | acc: {accs_str} | "
              f"error_ratio: {errs_str} | instances/sec: "
              f"{speed:.2f}{edge_str}")

    def _save(self, path: str, train_step: Optional[int] = None,
              iterator_state: Optional[Dict] = None) -> None:
        """The checkpoint, written by rank 0; under type-TP every rank
        calls this, to gather the whole weights and moments first."""
        with self._whole_weights():
            if self.is_chief:
                save_checkpoint(path, self.config, self.params,
                                self.train_step_id if train_step is None
                                else train_step, self.valid_step_id,
                                optimizer=self.optimizer,
                                iterator_state=iterator_state)

    def _whole_weights(self):
        """A context in which the parameters and Adam moments are whole:
        a no-op but under type-TP, whose slices it gathers."""
        if not self._type_tp:
            return contextlib.nullcontext()
        return tp.full_leaves(self.params, self.optimizer, self.mesh.edge)

    def _resume_epoch(self) -> int:
        """Set up the resume from a mid-epoch iterator state; returns the
        epoch to start at."""
        it = self._resume_iter
        start_epoch = int(it["epoch"])
        self.np_rng.set_state(it["np_rng_state"])
        self._skip_steps = int(it["steps_done"])
        state = it.get("torch_generator_state")
        if (state is not None
                and it.get("torch_generator_device") == self.device.type):
            self.generator.set_state(
                torch.from_numpy(np.asarray(state, np.uint8).copy()))
        else:
            print("The checkpoint holds no dropout generator state for "
                  f"{self.device.type}; the resumed run keeps the seeded "
                  "dropout stream.")
        # A rolling checkpoint can land on the epoch's last step: count
        # the epoch's batches with a clone of the epoch-start RNG and,
        # when all were consumed, continue at the next epoch with the
        # clone's post-shuffle state (what the uninterrupted run used).
        clone = np.random.RandomState()
        clone.set_state(it["np_rng_state"])
        total_steps = sum(1 for _ in self.adapter.batches(
            self.train_processed, True, clone))
        if self._skip_steps >= total_steps:
            self.np_rng = clone
            self._skip_steps = 0
            self._resume_iter = None
            if not self.quiet:
                print(f"Resume checkpoint completed its epoch; continuing "
                      f"at epoch {start_epoch + 1}")
            return start_epoch + 1
        if not self.quiet:
            print(f"Resuming mid-epoch: epoch {start_epoch}, skipping "
                  f"{self._skip_steps} consumed batches")
        return start_epoch

    def _profiled_train_epoch(self, name: str):
        """`run_epoch` of the training split under `torch.profiler` (CPU,
        and CUDA on the card), its Chrome trace written into
        `profile_dir`."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            result = self.run_epoch(name, self.train_processed, True)
        if not self.is_chief:
            return result
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.profile_dir, f"{self.run_id}_epoch1_trace.json"))
        return result

    def train(self):
        """The epoch loop; closes the TensorBoard writers when it
        returns."""
        try:
            return self._train()
        finally:
            self.summaries.close()

    def _train(self):
        log_to_save = []
        total_time_start = time.time()
        if self.restored:
            _, valid_accs, _, _, steps = self.run_epoch(
                "Resumed (validation)", self.valid_processed, False)
            best_val_acc = float(np.sum(valid_accs))
            self.valid_step_id += steps
            if not self.quiet:
                print(f"\r\x1b[KResumed operation, initial cum. val. acc: "
                      f"{best_val_acc:.5f}")
        else:
            best_val_acc = float("+inf")
        start_epoch = 1
        if self._resume_iter is not None:
            start_epoch = self._resume_epoch()
        # Patience counts epochs since the last improvement, from the
        # epoch the run (re)starts at.
        best_val_acc_epoch = start_epoch - 1
        for epoch in range(start_epoch, self.config["num_epochs"] + 1):
            if not self.quiet:
                print(f"== Epoch {epoch}")
            resumed = epoch == start_epoch and self._resume_iter is not None
            self._epoch_iter_ctx = {
                "epoch": epoch,
                "np_rng_state": (self._resume_iter["np_rng_state"] if resumed
                                 else self.np_rng.get_state())}
            name = f"epoch {epoch} (training)"
            if self.profile_dir is not None and epoch == 1:
                epoch_result = self._profiled_train_epoch(name)
            else:
                epoch_result = self.run_epoch(name, self.train_processed,
                                              True)
            train_loss, train_accs, train_errs, train_speed, train_steps = (
                epoch_result)
            self.train_step_id += train_steps
            self._report("Train", train_loss, train_accs, train_errs,
                         train_speed, self.last_edge_msg_per_sec)
            valid_loss, valid_accs, valid_errs, valid_speed, valid_steps = (
                self.run_epoch(f"epoch {epoch} (validation)",
                               self.valid_processed, False))
            self.valid_step_id += valid_steps
            self._report("Valid", valid_loss, valid_accs, valid_errs,
                         valid_speed)

            log_to_save.append({
                "epoch": epoch,
                "time": time.time() - total_time_start,
                "train_results": (train_loss, train_accs.tolist(),
                                  train_errs.tolist(), train_speed),
                "valid_results": (valid_loss, valid_accs.tolist(),
                                  valid_errs.tolist(), valid_speed),
            })
            if self.is_chief:
                with open(self.log_file, "w") as f:
                    json.dump(log_to_save, f, indent=4)
            self.summaries.flush()  # TB scalars reach the disk each epoch
            if self.save_every_epoch:
                self._save(self.last_model_file)

            val_acc = float(np.sum(valid_accs))
            if val_acc < best_val_acc:
                self._save(self.best_model_file)
                if not self.quiet:
                    print(f"  (Best epoch so far, cum. val. acc decreased to "
                          f"{val_acc:.5f} from {best_val_acc:.5f}. Saving to "
                          f"'{self.best_model_file}')")
                best_val_acc = val_acc
                best_val_acc_epoch = epoch
            elif epoch - best_val_acc_epoch >= self.config["patience"]:
                if not self.quiet:
                    print(f"Stopping training after {self.config['patience']} "
                          f"epochs without improvement on validation accuracy.")
                break
        return log_to_save

    # ---------------------------------------------------- on the device

    def device_epochs(self):
        """(epochs_fn, groups, steps) for whole epochs on the device: the
        training split packed once (the numpy stream advances as one
        epoch's pack does), the batches grouped by the shapes of their
        leaves in JAX's order (`shape_groups`) and uploaded once, and the
        Runner's epochs function over the train step's graphs, which
        `run_epoch` shares. `steps` is the batch count."""
        batches = list(self.adapter.batches(self.train_processed, True,
                                            self.np_rng))
        groups = [[b.to(self.device) for b in group]
                  for group in shape_groups(batches)]
        return self._epochs_fn, groups, len(batches)

    def train_on_device(self, num_epochs: int) -> float:
        """The counterpart of the JAX Runner's `train_on_device`
        (`ggnn_tpu/training/runner.py:891`): `num_epochs` epochs over one
        fixed pack of the training split, every step a replay of a CUDA
        graph on the card (an eager step on the CPU), and one host read
        at the end. No per-epoch logging, patience, summary or
        checkpoint. Returns the final step's loss; adds num_epochs x the
        batches to `train_step_id`. Dropout draws are fresh every step
        and epoch (the generator is registered with each graph).
        `replay_launches` then holds each step's kernel launches a
        replay, from its graph's capture. A mesh Runner raises, as
        JAX's does: mesh training uses `train()`."""
        if self.mesh is not None:
            raise ValueError("train_on_device is single-device; mesh "
                             "training uses train()")
        epochs_fn, groups, steps = self.device_epochs()
        loss = float(epochs_fn(groups, num_epochs))
        if self.device.type == "cuda" and num_epochs > 0:
            self.replay_launches = epochs_fn.step_launches(groups)
        self.train_step_id += num_epochs * steps
        return loss

    # ------------------------------------------------------------- eval

    def predict(self, raw_graphs) -> List[np.ndarray]:
        """Model outputs for raw graphs on the Runner's device, every keep
        probability at 1.0 (the reference's `evaluate_one_batch`): a
        [K, n] array a packed batch of n graphs, or for the dense family
        one [K, len(raw_graphs)] array in request order."""
        # The dense variant drops bucket remainders in training epochs (a
        # reference quirk); a prediction covers every graph asked for.
        saved_drop = getattr(self.adapter, "drop_remainder", None)
        if saved_drop is not None:
            self.adapter.drop_remainder = False
        self._refresh_free_params()
        try:
            processed = self.adapter.preprocess(raw_graphs, False)
            order = self._dense_request_order(processed)
            outputs = []
            with torch.no_grad():
                for batch in self.adapter.batches(processed, False):
                    computed = self.predict_graphs(batch)
                    outputs.append(
                        computed.cpu().numpy()[:, :int(batch.num_graphs)])
        finally:
            if saved_drop is not None:
                self.adapter.drop_remainder = saved_drop
        if order is not None:
            # Dense bucketing reorders the graphs; row i of the result is
            # raw_graphs[i]'s prediction, as in serving.Predictor.
            packed = np.concatenate(outputs, axis=1)
            result = np.empty_like(packed)
            result[:, np.asarray(order)] = packed
            return [result]
        return outputs

    def _refresh_free_params(self) -> None:
        """On an edge-axis mesh, the collective-free copy that `predict`
        runs (`_free_params`: a model built without the edge axis, so a
        prediction runs no collective), built at the first call, as JAX
        builds its once per Runner (`ggnn_tpu/training/runner.py:
        943-966`), and refreshed in place from the whole weights at
        every call, so that the prediction graphs read the live
        weights. Elsewhere predict runs the Runner's own parameters."""
        if getattr(self.model, "edge_axis", None) is None:
            return
        if self._free_params is None:
            self._free_params = ModelParams(
                self.adapter.build_model(torch.Generator().manual_seed(0)),
                init_output_heads(torch.Generator().manual_seed(0),
                                  self.config["hidden_size"],
                                  self.task_ids)).to(self.device)
        free = dict(self._free_params.named_parameters())
        with self._whole_weights(), torch.no_grad():
            for name, p in self.params.named_parameters():
                free[name].copy_(p)

    def _dense_request_order(self, processed):
        """Request indices of the packed dense-family graphs in pack
        order, or None where packing keeps the request order (the
        edge-list variants pack sequentially)."""
        if getattr(self.adapter, "drop_remainder", None) is None:
            return None
        if isinstance(processed, native_pack.DenseProcessed):
            return [int(i) for ids in processed.bucket_order for i in ids]
        return [int(g["graph_id"]) for bucket in processed.values()
                for g in bucket]

    def example_evaluation(self, valid_file: Optional[str] = None,
                           n_example_molecules: int = 10,
                           example_molecules: Optional[List] = None):
        """The reference's example_evaluation (sparse.py:364-376): the
        targets, then the predictions, of the first validation
        molecules."""
        if example_molecules is None:
            if valid_file is None:
                valid_file = os.path.join(self.data_dir,
                                          self.config["valid_file"])
            with open(valid_file, "r") as f:
                example_molecules = json.load(f)[:n_example_molecules]
        for mol in example_molecules:
            print(mol["targets"])
        for out in self.predict(example_molecules):
            print(out)

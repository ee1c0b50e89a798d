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
  * `--freeze-graph-model` (graph subtree excluded from updates).

It runs on the GPU unless the caller passes `device="cpu"`, and without
CUDA it raises. The numpy stream is the JAX Runner's:
`np.random.RandomState(random_seed)` shuffles the preprocessed training
split once, then each epoch's pack, so with the same seed both Runners
see the same batches in the same order. Dropout masks come from a
`torch.Generator` on the run's device and differ from the JAX masks by
design; initial weights come from a CPU `torch.Generator`, so a run
starts from the same weights on either device.

Not ported yet: the mesh paths (ROADMAP A11), `train_on_device` (a CUDA
graph counterpart, ROADMAP A18), mid-epoch iterator resume, TensorBoard
summaries (accepted as `tensorboard=`, nothing is written), `--profile`,
`predict` and `example_evaluation` (A9).
"""

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ggnn_tpu_torch.data.loader import infer_metadata, load_graphs_json
from ggnn_tpu_torch.models.base import (ModelParams, init_output_heads,
                                        masked_regression_loss)
from ggnn_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from ggnn_tpu_torch.training.optimizer import TFAdam
from ggnn_tpu_torch.training.variants import make_adapter
from ggnn_tpu_torch.utils.constants import CHEMICAL_ACCURACIES
from ggnn_tpu_torch.utils.device import resolve_device
from ggnn_tpu_torch.utils.prefetch import ThreadedIterator


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
                 save_every_epoch: bool = False,
                 device=None):
        del tensorboard  # summaries are not ported yet (ROADMAP A9)
        self.device = resolve_device(device)
        self.variant = variant
        self.config = config
        self.quiet = quiet
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
        with open(os.path.join(log_dir, f"{self.run_id}_params.json"),
                  "w") as f:
            json.dump(config, f)
        if not quiet:
            print(f"Run {self.run_id} starting with following parameters:\n"
                  f"{json.dumps(config)}")

        seed = config["random_seed"]
        self.np_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)

        # Data loading + metadata inference (chem_tensorflow.py:104-123).
        if train_data is None:
            train_data = load_graphs_json(
                os.path.join(data_dir, config["train_file"]), restrict_data)
        if valid_data is None:
            valid_data = load_graphs_json(
                os.path.join(data_dir, config["valid_file"]), restrict_data)
        self.meta = infer_metadata([train_data, valid_data],
                                   config["tie_fwd_bkwd"])
        self.adapter = make_adapter(variant, config, self.meta)
        self.train_processed = self.adapter.preprocess(
            train_data, True, self.np_rng)
        self.valid_processed = self.adapter.preprocess(valid_data, False)
        self.adapter.plan(self.train_processed, self.valid_processed)

        # Model + parameters, drawn on the CPU, then moved.
        init_gen = torch.Generator().manual_seed(seed)
        self.model = self.adapter.build_model(init_gen)
        self.params = ModelParams(
            self.model, init_output_heads(init_gen, config["hidden_size"],
                                          self.task_ids)).to(self.device)
        if freeze_graph_model:
            self.params.graph.requires_grad_(False)
        self.optimizer = TFAdam(self.params, config["learning_rate"],
                                config["clamp_gradient_norm"],
                                freeze_graph_model)

        self.save_every_epoch = save_every_epoch
        self.train_step_id = 0
        self.valid_step_id = 0
        if restore is not None:
            _, self.train_step_id, self.valid_step_id = restore_checkpoint(
                restore, config, self.params, optimizer=self.optimizer)
        self.restored = restore is not None

        # Propagation steps per forward: the edge-messages/s multiplier.
        self.prop_steps = int(sum(config["layer_timesteps"]))
        self.last_edge_msg_per_sec = None

    # ------------------------------------------------------------- steps

    def _loss_fn(self, batch, is_training: bool):
        """(loss [], per-task MAE [K]) of one batch on the device."""
        if self.config["use_graph"]:
            final = self.model(batch, is_training=is_training,
                               generator=self.generator)
        else:
            # Ablation: zero the propagated states
            # (chem_tensorflow.py:144-147).
            final = torch.zeros_like(batch.node_features)
        keep = (self.config["out_layer_dropout_keep_prob"]
                if is_training else 1.0)
        computed = self.model.readout(self.params.heads, self.task_ids,
                                      final, batch, keep_prob=keep,
                                      generator=self.generator)
        return masked_regression_loss(
            computed, batch.targets, batch.target_mask, self.task_ids,
            self.config["task_sample_ratios"])

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

    # ------------------------------------------------------------- epochs

    def run_epoch(self, epoch_name: str, processed, is_training: bool):
        """Returns (loss, accuracies, error_ratios, instances/sec, steps)."""
        chem_acc = CHEMICAL_ACCURACIES[self.task_ids]
        step_fn = self.train_step if is_training else self.eval_step
        start_time = time.time()
        batch_iter = ThreadedIterator(
            self.adapter.batches(processed, is_training,
                                 self.np_rng if is_training else None),
            max_queue_size=5)
        # Per-step metrics stay on the device until the epoch ends (one
        # copy for the whole epoch); the verbose progress line reads the
        # loss every batch.
        step_metrics = []
        graph_counts = []
        processed_graphs = 0
        processed_edges = 0.0
        total_loss = 0.0
        for step, batch in enumerate(batch_iter):
            num_graphs = int(batch.num_graphs)
            processed_graphs += num_graphs
            processed_edges += float(np.asarray(batch.edge_mask).sum())
            loss, accs = step_fn(batch.to(self.device))
            step_metrics.append((loss, accs))
            graph_counts.append(num_graphs)
            if not self.quiet:
                total_loss += float(loss) * num_graphs
                print(f"Running {epoch_name}, batch {step} (has {num_graphs} "
                      f"graphs). Loss so far: "
                      f"{total_loss / processed_graphs:.4f}", end="\r")
        if processed_graphs == 0:
            raise RuntimeError(
                f"{epoch_name}: no batches produced — the corpus split is "
                "empty; check the data files and any --restrict_data "
                "truncation.")
        losses = torch.stack([m[0] for m in step_metrics]).cpu().numpy()
        accs_all = torch.stack([m[1] for m in step_metrics]).cpu().numpy()
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

    def _save(self, path: str) -> None:
        save_checkpoint(path, self.config, self.params, self.train_step_id,
                        self.valid_step_id, optimizer=self.optimizer)

    def train(self):
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
        best_val_acc_epoch = 0
        for epoch in range(1, self.config["num_epochs"] + 1):
            if not self.quiet:
                print(f"== Epoch {epoch}")
            train_loss, train_accs, train_errs, train_speed, train_steps = (
                self.run_epoch(f"epoch {epoch} (training)",
                               self.train_processed, True))
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
            with open(self.log_file, "w") as f:
                json.dump(log_to_save, f, indent=4)
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

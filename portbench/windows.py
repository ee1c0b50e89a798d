"""What the window drivers share. A traffic mix's `entry` names its
driver, `portbench/drivers/<entry>.py`, whose `Driver(run)` builds the
port's entry from the run's molecules and weights (set-up), drives it
for the window (`window(seconds)`), frees it (`release()`), and then
holds what the timed path produced to the plain reference (`check()`).
The mix's other keys are the driver's parameters.

The plain reference is the module the configuration names under
`reference` (portbench/reference/); it packs its own batches from the
molecules, and counts the work of the batches the window ran.
"""

import contextlib
import gc
import importlib.util
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, flops, molecules, reference
from portbench.reference import common

HERE = os.path.dirname(os.path.abspath(__file__))


def span(name: str):
    """A host span the traced run records around a call into the port."""
    return torch.profiler.record_function(f"portbench.{name}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load(folder: str, name: str):
    """The module `portbench/<folder>/<name>.py`, loaded by its path."""
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.isfile(path):
        raise ValueError(f"no {folder} file {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Run:
    """One run of a cell: its configuration and traffic, the seed, the
    device, a directory for the port's logs, and the reference model
    the configuration names."""

    def __init__(self, config: Dict, traffic: Dict, seed: int,
                 device: torch.device, log_dir: str):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.log_dir = log_dir
        # The seeds of the numpy streams (RandomState takes 32 bits).
        self.random_seed = self.seed % 2**32
        self.reference = reference.model_for(config)
        self.model = config["model"]
        self.hidden = config["model"]["hidden_size"]
        self.edge_types = config["edge_types"]
        self.stages: List = []

    @contextlib.contextmanager
    def stage(self, name: str):
        """Records the seconds a stage of set-up took (synchronised)."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.stages.append((name, time.perf_counter() - t0))

    def corpus(self) -> molecules.Corpus:
        sizes = self.config["corpus"]
        return molecules.molecules(sizes["train"] + sizes["valid"], self.seed)

    def weights(self) -> Dict[str, torch.Tensor]:
        shapes = self.reference.parameter_shapes(self.model, self.hidden,
                                                 self.edge_types)
        return common.init_weights(shapes, self.seed, self.device)

    def stats(self, corpus: molecules.Corpus) -> Dict[str, np.ndarray]:
        return flops.molecule_stats(corpus.num_atoms, corpus.edges,
                                    corpus.bonds, self.edge_types)

    def products(self, precision: Optional[str] = None) -> common.Products:
        """The reference's products: in the configuration's precision, or
        in `precision`."""
        return common.Products(precision or common.precision_of(self.config))


class Window:
    """What a window did: its seconds and the work in it."""

    def __init__(self):
        self.seconds = 0.0
        self.graphs = 0
        self.attempted = 0
        self.failed = 0
        self.latencies_s: List[float] = []
        self.flops = 0
        self.agg_bytes = 0


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Training:
    """What the training drivers share: the corpus, the Runner, the
    first `check_steps` steps the reference follows, and the work of one
    epoch."""

    def __init__(self, run: Run):
        from portbench import program
        self.program = program
        self.run = run
        with run.stage("molecules"):
            corpus = run.corpus()
            n_train = run.config["corpus"]["train"]
            self.train = corpus.take(np.arange(n_train))
            valid = corpus.take(np.arange(n_train, corpus.num_graphs))
            train_json, valid_json = self.train.as_json(), valid.as_json()
        with run.stage("weights"):
            self.weights = run.weights()
            self.initial = {k: v.clone() for k, v in self.weights.items()}
        with run.stage("runner"):
            self.runner = program.runner(run.config, run.random_seed,
                                         train_json, valid_json,
                                         self.weights, run.log_dir,
                                         run.device)
        self.steps = run.traffic["check_steps"]
        self.losses: List[float] = []
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        self.epoch = run.reference.epoch(self.train.num_atoms, run.model,
                                         run.random_seed)
        self.epoch_work = run.reference.work(
            run.model, run.hidden, run.edge_types, run.stats(self.train),
            self.epoch, True)

    def record(self, step: int) -> None:
        """After step `step` (from 1): the first step's clipped gradients
        from Adam's first moment, the weights after the last."""
        if step == 1:
            self.first_grads = {
                k: m / (1 - common.ADAM_B1)
                for k, m in self.program.adam_first_moments(
                    self.runner).items()}
        if step == self.steps:
            self.after = self.program.parameters(self.runner.params)

    def add_work(self, out: Window, epochs: int) -> None:
        out.flops = epochs * self.epoch_work["flops"]
        out.agg_bytes = epochs * self.epoch_work["agg_bytes"]

    def release(self) -> None:
        del self.runner
        free(self.run.device)

    def reference(self, precision: Optional[str] = None):
        """(losses, first clipped gradients, weights after) of the
        reference's first steps from the same weights on the same
        molecules, packed and ordered by the reference itself."""
        run, ref = self.run, self.run.reference
        batches = [ref.make_batch(self.train.take(ids), v, run.hidden,
                                  run.device)
                   for ids, v in self.epoch[:self.steps]]
        return common.train_steps(run.products(precision), ref.forward,
                                  self.initial, run.model, batches,
                                  run.random_seed)

    def numbers(self, got, want) -> Dict[str, float]:
        """The gaps of `got` from `want`, each (losses, first gradients,
        weights after)."""
        return check.training_numbers(
            got[0], want[0], got[1], want[1],
            {k: got[2][k] - self.initial[k] for k in got[2]},
            {k: want[2][k] - self.initial[k] for k in want[2]})

    def outputs(self):
        """What the timed path produced: (losses, first clipped
        gradients, weights after)."""
        return (self.losses, self.first_grads, self.after)

    def control(self, precision: str):
        """The reference in `precision`, put in the port's place."""
        return self.reference(precision)

    def check(self) -> Dict[str, float]:
        return self.numbers(self.outputs(), self.reference())


def log_dir() -> str:
    """Where the port writes its run logs: under the run's TMPDIR."""
    base = os.environ.get("TMPDIR") or os.path.join(os.getcwd(), "build")
    return os.path.join(base, "portbench_logs")


def quantile(values: List[float], q: float) -> Optional[float]:
    """The q-th quantile of all values (linear between order statistics)."""
    if not values:
        return None
    return float(np.quantile(np.asarray(values), q))

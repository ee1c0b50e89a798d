"""`Runner.run_epoch` over the training split, the epoch `Runner.train`
runs (shuffle, native packer in the prefetch thread, copy, replayed
step), epochs until the window's seconds have passed.

Set-up runs one whole epoch through it, which captures the step; its
first `check_steps` steps are recorded as they happen, and the window
goes on from there with the same Runner.

Mix parameters: `check_steps`, the steps the reference follows.
"""

import time
from typing import List

import numpy as np
import torch

from portbench.windows import Run, Training, Window, span


class _FirstSteps:
    """Stands in for the Runner's train-step cache during the set-up
    epoch: passes every step through, and records the first ones."""

    def __init__(self, training: Training, steps):
        self.training = training
        self.steps = steps
        self.done = 0
        self.loss_tensors: List[torch.Tensor] = []

    def __call__(self, batch, *args, **kwargs):
        out = self.steps(batch, *args, **kwargs)
        if self.done < self.training.steps:
            self.done += 1
            self.loss_tensors.append(out[0])
            self.training.record(self.done)
        return out


class Driver(Training):
    def __init__(self, run: Run):
        super().__init__(run)
        steps = self.runner.train_graphs
        first = _FirstSteps(self, steps)
        self.runner.train_graphs = first
        try:
            with run.stage("first epoch"):
                self.runner.run_epoch("set-up epoch",
                                      self.runner.train_processed, True)
        finally:
            self.runner.train_graphs = steps
        self.losses = [float(t) for t in first.loss_tensors]

    def window(self, seconds: float) -> Window:
        out, calls, epochs = Window(), 0, 0
        t0 = time.perf_counter()
        while True:
            with span("epoch"):
                loss, _, _, _, steps = self.runner.run_epoch(
                    "window epoch", self.runner.train_processed, True)
            epochs += 1
            calls += steps
            out.seconds = time.perf_counter() - t0
            if out.seconds >= seconds:
                break
        out.graphs = epochs * self.train.num_graphs
        out.attempted = calls
        out.failed = 0 if np.isfinite(loss) else calls
        self.add_work(out, epochs)
        return out

"""`Runner.train_on_device`'s epochs over the training split, packed once
and resident on the card: its epochs function over the groups
`Runner.device_epochs` packs, an epoch a call, until the window's seconds
have passed.

Set-up captures every batch shape's step (state restored) and then runs
the first `check_steps` batches of the epoch, one call each, through the
same function; the window goes on from there with the same Runner.

Mix parameters: `check_steps`, the steps the reference follows.
"""

import time

import numpy as np

from portbench.windows import Run, Training, Window, span, sync


class Driver(Training):
    def __init__(self, run: Run):
        super().__init__(run)
        with run.stage("pack and upload"):
            epochs_fn, groups, _ = self.runner.device_epochs()
        self.epochs_fn, self.groups = epochs_fn, groups
        batches = [b for g in groups for b in g]
        with run.stage("capture"):
            self.program.capture_all(self.runner, batches)
        with run.stage("first steps"):
            for step, batch in enumerate(batches[:self.steps], start=1):
                self.losses.append(float(epochs_fn([[batch]], 1)))
                self.record(step)
        self.epoch_graphs = sum(int(b.num_graphs) for b in batches)
        self.epoch_calls = len(batches)

    def window(self, seconds: float) -> Window:
        device, out = self.run.device, Window()
        epochs, t0 = 0, time.perf_counter()
        while True:
            with span("epoch"):
                loss = self.epochs_fn(self.groups, 1)
                sync(device)
            epochs += 1
            out.seconds = time.perf_counter() - t0
            if out.seconds >= seconds:
                break
        out.graphs = epochs * self.epoch_graphs
        out.attempted = epochs * self.epoch_calls
        out.failed = 0 if np.isfinite(float(loss)) else out.attempted
        self.add_work(out, epochs)
        return out

    def release(self) -> None:
        del self.epochs_fn, self.groups
        super().release()

"""TensorBoard scalar summaries, the port of
`ggnn_tpu/training/summaries.py`.

The reference writes per-batch `loss` and `accuracy<task_id>` scalars
into `<log_dir>/tb/<run_id>/{train,validation}`
(chem_tensorflow.py:53-54,101-102,195-200,236-238), with global step
counters that persist across checkpoint resume. This writes that layout
through tensorboardX; without tensorboardX the sink does nothing, as the
JAX package's does, so training has no hard dependency on it.

The writers (each a tensorboardX file and a writer thread) open at the
first scalar, so a Runner that never runs an epoch holds none, and
`close()` ends them for good: the Runner closes its sink when `train()`
returns.
"""

import os
from typing import Optional, Sequence


class SummarySink:
    """Per-split scalar writer with the reference's tag names."""

    def __init__(self, log_dir: str, run_id: str, enabled: bool = True):
        self._writers = {}
        self._base = os.path.join(log_dir, "tb", run_id)
        self._writer_cls = None
        if enabled:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self._writer_cls = SummaryWriter

    @property
    def enabled(self) -> bool:
        """Whether scalars are written (tensorboardX imported, the sink
        was enabled and is not closed)."""
        return self._writer_cls is not None

    def _writer(self, split: str):
        """The writer of "train" or "validation", opened on first use."""
        if split not in self._writers:
            self._writers[split] = self._writer_cls(
                os.path.join(self._base, split))
        return self._writers[split]

    def add_batch(self, split: str, step: int, loss: float,
                  accuracies: Sequence[float],
                  task_ids: Optional[Sequence[int]] = None) -> None:
        if not self.enabled:
            return
        w = self._writer(split)
        w.add_scalar("loss", loss, step)
        ids = task_ids if task_ids is not None else range(len(accuracies))
        for task_id, acc in zip(ids, accuracies):
            w.add_scalar(f"accuracy{task_id}", float(acc), step)

    def flush(self) -> None:
        """tensorboardX flushes its file every 120 s and has no exit
        hook; the Runner flushes once an epoch. A flush writes what the
        writer's thread has taken from its queue; `close()` writes
        everything."""
        for w in self._writers.values():
            w.flush()

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        self._writers = {}
        self._writer_cls = None

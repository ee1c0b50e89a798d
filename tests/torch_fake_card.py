"""A stand-in for the card on the CPU, for tests of the replay path of
`ggnn_tpu_torch.utils.timing.StepCache`: each capture makes a fake
graph, whose replay runs the step eagerly on a fresh copy of the batch's
arrays, its count leaves None as a captured step sees them, and writes
into the same output buffers every time, as a CUDA graph's static
outputs are written. A caller that kept a replay's outputs without a
copy would see the next replay's values, and a step that read a count
would fail. tests/test_torch_replay.py uses it as a fixture, the mesh
ranks (tests/torch_mesh_replay_ranks.py) as a context; it imports no
JAX."""

import contextlib
import time

import torch

from ggnn_tpu_torch.utils import timing


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


class FakeGraph:
    """A captured graph's stand-in: each replay runs the step eagerly and
    writes into the same output buffers, then lingers, so that a replay
    racing another shows. `batches` holds what each replay was given."""

    def __init__(self, cache):
        self.cache = cache
        self.outputs = None
        self.batches = []
        self.launches = {}

    def replay(self, batch):
        self.batches.append(batch)
        out = self.cache.step_fn(timing._static_copy(batch, "cpu"))
        with torch.no_grad():
            if self.outputs is None:
                self.outputs = timing._clone(out)
            else:
                _copy_into(self.outputs, out)
        time.sleep(1e-4)
        return self.outputs


def patches(captured: list):
    """(object, attribute, value) triples that make every cache take its
    replay path, a fake graph a capture; each capture appends (cache
    name, key) to `captured`."""
    def capture(self, new):
        for key in new:
            captured.append((self.name, key))
            self.graphs[key] = FakeGraph(self)

    return [(timing.StepCache, "capture", capture),
            (timing, "_device_of",
             lambda batch, device=None: torch.device("cuda"))]


@contextlib.contextmanager
def fake_card():
    """`patches` for the body of the `with`; yields the captures."""
    captured = []
    changes = patches(captured)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in changes]
    for obj, name, value in changes:
        setattr(obj, name, value)
    try:
        yield captured
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)

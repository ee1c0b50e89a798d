"""Timing on the card, the counterpart of `ggnn_tpu/utils/timing.py`.

`time_ms` times one call by CUDA events around each call, with the
stream held busy while the calls are queued, in groups that fit the
launch queue, so that the events bracket the device work and not the
host's launch; `gpu_name_and_power` names the card a time was taken on.
Both need a CUDA device.

`make_epochs_fn` runs whole training epochs over batches already on the
device, each train step on the card a replay of a CUDA graph and on the
CPU the same step run eagerly, in the same order; `time_epochs` times
it by differencing two run lengths, as the JAX harness does.
`shape_groups` groups batches by the shapes of their leaves, as
`ggnn_tpu/training/runner.py:train_on_device` does, and `graph_key`
says which batches one graph can replay.
"""

import dataclasses
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggnn_tpu_torch.ops.kernels import launch_counts

_SLEEP_CYCLES_PER_MS = None


def _sleep_cycles_per_ms() -> float:
    """GPU clock cycles of `torch.cuda._sleep` per millisecond."""
    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        cycles = 10_000_000
        torch.cuda._sleep(cycles)          # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS = cycles / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS


# A group counts only when the host queued it within this share of its
# sleep: the margin covers the sleep's start and its clock.
_QUEUED_SHARE = 0.75
# A group's sleep, in multiples of its host time: queueing calls behind a
# sleep takes the host longer than its time a call in a synchronised
# loop, and a group must not fail on that alone, so the margin is wide.
_SLEEP_PER_HOST_MS = 4.0
# Tries of a group of one call before time_ms gives up on it.
_SINGLE_CALL_TRIES = 3


def _timed_group(fn, calls: int, sleep_ms: float):
    """The device ms of each of `calls` calls, each between two CUDA
    events, queued while a sleep kernel of `sleep_ms` held the stream; None
    when queueing them outlasted the sleep. The host outlasts it only by
    waiting, which it does when the launch queue is full (it drains only
    after the sleep), or when the sleep was short: either way the card
    waited for the host, and the events would time the host's pace."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * sleep_ms))
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        fn()
        end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if queued_ms >= _QUEUED_SHARE * sleep_ms:
        return None
    return [s.elapsed_time(e) for s, e in events]


def time_ms(fn, iters: int = 50, warmup: int = 5):
    """(device ms, host ms) of one call.

    Device ms is the median over `iters` calls of CUDA events recorded
    around each call. The calls are queued in groups, each behind its own
    sleep kernel of four times the group's host time, so that the events
    bracket the calls' device work alone, not the host's time to launch
    them. A call of many kernels fills the launch queue (about a thousand
    entries) after a few calls: a group whose queueing outlasted its
    sleep is timed again at half its size, and a single call that cannot
    be queued within its sleep in a few tries raises. Host ms is the mean
    wall time per call of a synchronised loop, launch overhead included.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    times, group, single_fails = [], iters, 0
    while len(times) < iters:
        calls = min(group, iters - len(times))
        got = _timed_group(fn, calls,
                           max(_SLEEP_PER_HOST_MS * host_ms * calls, 2.0))
        if got is not None:
            times += got
        elif calls > 1:
            group = calls // 2
        else:
            single_fails += 1
            if single_fails == _SINGLE_CALL_TRIES:
                raise RuntimeError(
                    "time_ms: one call could not be queued within its "
                    "sleep; it launches more kernels than the launch queue "
                    "holds")
    return statistics.median(times), host_ms


def gpu_name_and_power() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- epochs

# The batch's count leaves (`graph.py`): host ints that the Runner reads
# for its metrics and that no train step reads. A graph key leaves them
# out, and a captured step sees them as None, so a step that read one
# would fail at its warm-up instead of replaying a stale value.
_UNREAD = ("num_graphs", "num_nodes")


def leaf_shapes(batch) -> Tuple[tuple, ...]:
    """The shapes of a batch's leaves in `jax.tree_util.tree_leaves`
    order (dataclass fields in order, tuples flattened, None fields
    skipped): the JAX Runner's group key. A numpy, torch or scalar leaf
    has its shape, a Python int ()."""
    if batch is None:
        return ()
    if dataclasses.is_dataclass(batch):
        return sum((leaf_shapes(getattr(batch, f.name))
                    for f in dataclasses.fields(batch)), ())
    if isinstance(batch, tuple):
        return sum((leaf_shapes(v) for v in batch), ())
    return (tuple(getattr(batch, "shape", ())),)


def shape_groups(batches: Sequence) -> List[list]:
    """The batches grouped by `leaf_shapes`, groups in first-seen order
    and each group's batches in their order: JAX's `train_on_device`
    groups (`ggnn_tpu/training/runner.py:907-911`), which set the order
    of the steps of an epoch."""
    groups: Dict[tuple, list] = {}
    for batch in batches:
        groups.setdefault(leaf_shapes(batch), []).append(batch)
    return list(groups.values())


def graph_key(batch):
    """What a captured step bakes in of a batch: each tensor's shape and
    dtype, and every host value but the counts (`_UNREAD`), such as an
    async segment's `recv_base` offsets. Batches with equal keys replay
    one graph; a JAX group (`shape_groups`) may hold several keys."""
    if isinstance(batch, torch.Tensor):
        return (tuple(batch.shape), batch.dtype)
    if dataclasses.is_dataclass(batch):
        return (type(batch).__name__,) + tuple(
            graph_key(getattr(batch, f.name))
            for f in dataclasses.fields(batch) if f.name not in _UNREAD)
    if isinstance(batch, tuple):
        return tuple(graph_key(v) for v in batch)
    return batch


def _tensors(batch) -> List[torch.Tensor]:
    """A batch's tensors in `graph_key` order."""
    if isinstance(batch, torch.Tensor):
        return [batch]
    if dataclasses.is_dataclass(batch):
        return [t for f in dataclasses.fields(batch) if f.name not in _UNREAD
                for t in _tensors(getattr(batch, f.name))]
    if isinstance(batch, tuple):
        return [t for v in batch for t in _tensors(v)]
    return []


def _static_copy(batch):
    """A batch whose tensors are fresh copies (a graph's input buffers),
    its count leaves None."""
    if isinstance(batch, torch.Tensor):
        return batch.clone()
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: None if f.name in _UNREAD
            else _static_copy(getattr(batch, f.name))
            for f in dataclasses.fields(batch)})
    if isinstance(batch, tuple):
        return tuple(_static_copy(v) for v in batch)
    return batch


class _LastOp(TorchDispatchMode):
    """Records the last operator dispatched, to name the one at which a
    warm-up or a capture failed."""

    op = "no operator (before the step's first)"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = str(func)
        return func(*args, **(kwargs or {}))


class StepGraph:
    """One captured train step: the graph, the input buffers it reads
    (`static`, a batch), its loss tensor, the kernel launches it holds
    ({"module.counter": launches a replay}, from the counters across its
    capture) and the B1/B2 scratch it captured, kept alive with it."""

    def __init__(self, graph, static, loss, launches, scratch):
        self.graph = graph
        self.static = static
        self.loss = loss
        self.launches = launches
        self._scratch = scratch
        self._dst = _by_dtype(_tensors(static))

    def replay(self, batch) -> torch.Tensor:
        """Copy `batch`'s tensors into the input buffers (one
        `_foreach_copy_` a dtype), replay, and return the loss buffer."""
        for dtype, src in _by_dtype(_tensors(batch)).items():
            torch._foreach_copy_(self._dst[dtype], src)
        self.graph.replay()
        return self.loss


def _by_dtype(tensors) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


class EpochsFn:
    """`epochs_fn(groups, n_epochs)`: see `make_epochs_fn`."""

    def __init__(self, step_fn: Callable, state: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator]):
        self.step_fn = step_fn
        self.state = list(state)
        self.generators = list(generators)
        self.graphs: Dict = {}
        self._stream = None
        self._pool = None

    def __call__(self, groups: Sequence[Sequence], n_epochs: int):
        steps = [batch for group in groups for batch in group]
        if not steps:
            raise ValueError("no batch groups to run")
        device = _tensors(steps[0])[0].device
        if device.type != "cuda":
            loss = torch.zeros((), device=device)
            for _ in range(n_epochs):
                for batch in steps:
                    loss = self.step_fn(batch)
            return loss
        keys = [graph_key(batch) for batch in steps]
        new = {}
        for key, batch in zip(keys, steps):
            if key not in self.graphs:
                new.setdefault(key, batch)
        if new:
            self._capture(new, device)
        loss = None
        for _ in range(n_epochs):
            for key, batch in zip(keys, steps):
                loss = self.graphs[key].replay(batch)
        if loss is None:
            return torch.zeros((), device=device)
        return loss.clone()

    def step_launches(self, groups: Sequence[Sequence]) -> List[Dict]:
        """{"module.counter": launches} a replay of each step of an epoch
        over `groups`, in step order (the groups must have run once)."""
        return [self.graphs[graph_key(batch)].launches
                for group in groups for batch in group]

    # ---------------------------------------------------------- capture

    def _capture(self, new: Dict, device: torch.device) -> None:
        """Warm up, then capture, a graph of the step for each new key on
        the side stream, the state and the generators restored after
        each phase and after a failure."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        saved = [t.detach().clone() for t in self.state]
        saved_generators = [g.get_state() for g in self.generators]
        statics = {key: _static_copy(batch) for key, batch in new.items()}
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(device))
        try:
            with torch.cuda.stream(stream):
                for static in statics.values():
                    self._warm(static)
                self._restore(saved, saved_generators)
                for key, static in statics.items():
                    self.graphs[key] = self._capture_one(static, device)
                self._restore(saved, saved_generators)
        except BaseException:
            # No update of a failed warm-up or capture stays.
            self._restore(saved, saved_generators)
            raise
        finally:
            torch.cuda.current_stream(device).wait_stream(stream)

    def _capture_one(self, static, device: torch.device) -> StepGraph:
        from ggnn_tpu_torch.ops.kernels import ell_spmm
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = launch_counts()
        last = _LastOp()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                with last:
                    loss = self.step_fn(static)
        except RuntimeError as err:
            raise RuntimeError(f"the capture of a train step failed at "
                               f"{last.op}: {err}") from err
        after = launch_counts()
        return StepGraph(
            graph, static, loss,
            {k: after[k] - before[k] for k in after if after[k] != before[k]},
            ell_spmm.scratch_of(device, self._stream.cuda_stream))

    def _warm(self, static) -> None:
        """One eager step on the capture stream before the capture: it
        loads the kernels and sizes the B1/B2 scratch and the cuBLAS
        workspace of that stream. Every synchronising call is refused
        (`torch.cuda.set_sync_debug_mode("error")`), so a step that a
        capture would refuse fails here, naming the operator."""
        mode = torch.cuda.get_sync_debug_mode()
        last = _LastOp()
        try:
            torch.cuda.set_sync_debug_mode("error")
            with last:
                self.step_fn(static)
        except RuntimeError as err:
            raise RuntimeError(f"the warm-up of a train step before its "
                               f"capture failed at {last.op}: {err}"
                               ) from err
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    @torch.no_grad()
    def _restore(self, saved, saved_generators) -> None:
        for tensor, value in zip(self.state, saved):
            tensor.copy_(value)
        for generator, value in zip(self.generators, saved_generators):
            generator.set_state(value)


def make_epochs_fn(step_fn: Callable, state: Sequence[torch.Tensor] = (),
                   generators: Sequence[torch.Generator] = ()) -> EpochsFn:
    """`epochs_fn(groups, n_epochs)`, the counterpart of
    `ggnn_tpu/utils/timing.py:make_epochs_fn`.

    `step_fn(batch) -> loss` makes one training update in place.
    `groups` are lists of batches already on the device (JAX's stacked
    groups, `shape_groups`); each epoch runs the groups one after
    another, each group's batches in their order, and `epochs_fn`
    returns the last step's loss as a device tensor (0 for no epoch).
    There are no key groups: the step draws its dropout masks from
    `generators`, which give fresh draws every step and every epoch.

    On the card each distinct `graph_key` is captured once into a CUDA
    graph and replayed: one graph per key over its own input buffers,
    into which each replay copies its batch's tensors device to device.
    The first call with a new key runs one eager step of it on a side
    stream, refusing every synchronising call, then captures it there; `state` (the parameters, the optimizer's count and
    moments) and the generators' states are saved before and restored
    after the warm-up and the capture, so `n_epochs` epochs make exactly
    n_epochs x the steps' updates. The graphs replay strictly one after
    another, so they share one memory pool. A step that a capture
    refuses raises, naming the operator; nothing runs eagerly in its
    place. On the CPU the same steps run eagerly in the same order."""
    return EpochsFn(step_fn, state, generators)


def time_epochs(epochs_fn: EpochsFn, groups: Sequence[Sequence],
                n1: int = 1, n2: int = 3) -> Tuple[float, float]:
    """(seconds an epoch, final loss), the counterpart of
    `ggnn_tpu/utils/timing.py:time_epochs`: one run of 1 epoch (captures
    and warms), then runs of `n1` and `n2` epochs, each ended by
    synchronising the device; their difference cancels the fixed cost of
    a run. Unlike JAX's functional state, every run trains the live
    parameters: 1 + n1 + n2 epochs of updates in all."""
    def run(n):
        loss = epochs_fn(groups, n)
        if loss.device.type == "cuda":
            torch.cuda.synchronize(loss.device)
        return loss

    run(1)
    t0 = time.perf_counter()
    run(n1)
    t1 = time.perf_counter()
    loss = run(n2)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (n2 - n1), float(loss)

"""Timing on the card, the counterpart of `ggnn_tpu/utils/timing.py`.

`time_ms` times one call by CUDA events around each call, with the
stream held busy while the calls are queued, in groups that fit the
launch queue, so that the events bracket the device work and not the
host's launch; `gpu_name_and_power` names the card a time was taken on.
Both need a CUDA device.

`StepCache` is where the port replays what the JAX package jits: a step
(a train or eval step, a forward) captured once per `graph_key` into a
CUDA graph on the card and replayed, run eagerly on the CPU.
`make_epochs_fn` runs whole training epochs over batches already on the
device through one; `time_epochs` times it by differencing two run
lengths, as the JAX harness does. `shape_groups` groups batches by the
shapes of their leaves, as `ggnn_tpu/training/runner.py:train_on_device`
does, and `graph_key` says which batches one graph can replay.

The spans (`utils/spans.py`, off by default): `ggnn.epochs` an epochs
call, `ggnn.epochs.keys` its key walk before the first replay,
`ggnn.replay` a replay (`ggnn.replay.fill` its input copy), and
`ggnn.capture` a capture (`ggnn.capture.warm` and `ggnn.capture.graph`
each key's warm-up and graph).
"""

import dataclasses
import gc
import statistics
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggnn_tpu_torch.ops.kernels import launch_counts
from ggnn_tpu_torch.utils.spans import span

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


# ----------------------------------------------------- replayed steps

# The batch's count leaves (`graph.py`): host ints that the Runner reads
# for its metrics and that no step reads. A graph key leaves them out,
# and a captured step sees them as None, so a step that read one would
# fail at its warm-up instead of replaying a stale value.
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


def _is_array(value) -> bool:
    return isinstance(value, (torch.Tensor, np.ndarray))


_TORCH_DTYPES: Dict[np.dtype, torch.dtype] = {}


def _torch_dtype(value) -> torch.dtype:
    """An array's torch dtype; a numpy array's is the one
    `torch.from_numpy` gives it."""
    if isinstance(value, torch.Tensor):
        return value.dtype
    dtype = _TORCH_DTYPES.get(value.dtype)
    if dtype is None:
        dtype = torch.from_numpy(np.empty(0, value.dtype)).dtype
        _TORCH_DTYPES[value.dtype] = dtype
    return dtype


def graph_key(batch):
    """What a captured step bakes in of a batch: its structure, each
    array's shape and dtype (a numpy array's as its tensor's, so a host
    batch and its device copy share a key) and every other host value
    but the counts (`_UNREAD`). Batches with equal keys replay one graph.
    A packed batch holds no other host value (the async `recv_base`
    offsets and a node shard's ragged routing rows are arrays), so the
    batches of one JAX group (`shape_groups`) share a key, and so do
    node-sharded stacks of one shape whatever their per-pair sizes."""
    if _is_array(batch):
        return (tuple(batch.shape), _torch_dtype(batch))
    if dataclasses.is_dataclass(batch):
        return (type(batch).__name__,) + tuple(
            graph_key(getattr(batch, f.name))
            for f in dataclasses.fields(batch) if f.name not in _UNREAD)
    if isinstance(batch, tuple):
        return tuple(graph_key(v) for v in batch)
    return batch


def _leaves(batch) -> list:
    """A batch's arrays (tensors or numpy) in `graph_key` order."""
    if _is_array(batch):
        return [batch]
    if dataclasses.is_dataclass(batch):
        return [t for f in dataclasses.fields(batch) if f.name not in _UNREAD
                for t in _leaves(getattr(batch, f.name))]
    if isinstance(batch, tuple):
        return [t for v in batch for t in _leaves(v)]
    return []


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def _to(batch, device):
    """The batch on `device`, as an eager step takes it."""
    if _is_array(batch):
        return _as_tensor(batch).to(device)
    if isinstance(batch, tuple):
        return tuple(_to(v, device) for v in batch)
    if hasattr(batch, "to"):
        return batch.to(device)
    return batch


def _static_copy(batch, device):
    """A batch of fresh tensors on `device`, copies of the batch's arrays
    (a graph's input buffers), its count leaves None."""
    if _is_array(batch):
        return _as_tensor(batch).to(device, copy=True)
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: None if f.name in _UNREAD
            else _static_copy(getattr(batch, f.name), device)
            for f in dataclasses.fields(batch)})
    if isinstance(batch, tuple):
        return tuple(_static_copy(v, device) for v in batch)
    return batch


def _fill(buffers: List[torch.Tensor], batch) -> None:
    """Copy a batch's arrays into a graph's input buffers: those on the
    buffers' device by one `_foreach_copy_` a dtype, host arrays straight
    from host memory. From pageable memory a copy returns once the driver
    has staged its source, so the host array may be dropped at once."""
    on_device: Dict[torch.dtype, Tuple[list, list]] = {}
    for dst, src in zip(buffers, _leaves(batch)):
        if isinstance(src, torch.Tensor) and src.device == dst.device:
            dsts, srcs = on_device.setdefault(dst.dtype, ([], []))
            dsts.append(dst)
            srcs.append(src)
        else:
            dst.copy_(_as_tensor(src), non_blocking=True)
    for dsts, srcs in on_device.values():
        torch._foreach_copy_(dsts, srcs)


def _clone(outputs):
    if isinstance(outputs, torch.Tensor):
        return outputs.clone()
    return tuple(_clone(v) for v in outputs)


def _first(outputs) -> torch.Tensor:
    return outputs if isinstance(outputs, torch.Tensor) else outputs[0]


def _device_of(batch, device=None) -> torch.device:
    """`device`, or that of the batch's first tensor (the CPU for a host
    batch)."""
    if device is not None:
        return device
    leaves = _leaves(batch)
    if leaves and isinstance(leaves[0], torch.Tensor):
        return leaves[0].device
    return torch.device("cpu")


class _LastOp(TorchDispatchMode):
    """Records the last operator dispatched, to name the one at which a
    warm-up or a capture failed."""

    op = "no operator (before the step's first)"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = str(func)
        return func(*args, **(kwargs or {}))


class StepGraph:
    """One captured step: the graph, the input buffers it reads
    (`static`, a batch), its outputs (buffers that each replay
    overwrites), the kernel launches it holds ({"module.counter":
    launches a replay}, from the counters across its capture) and the
    B1/B2 scratch it captured, kept alive with it."""

    def __init__(self, graph, static, outputs, launches, scratch):
        self.graph = graph
        self.static = static
        self.outputs = outputs
        self.launches = launches
        self._scratch = scratch
        self._buffers = _leaves(static)

    def replay(self, batch):
        """Copy `batch`'s arrays into the input buffers, replay, and
        return the output buffers."""
        with span("ggnn.replay"):
            with span("ggnn.replay.fill"):
                _fill(self._buffers, batch)
            self.graph.replay()
        return self.outputs


class GraphPool:
    """What the graphs of several `StepCache`s share: the side stream on
    which they are warmed up and captured, one memory pool, and the lock
    under which each capture and each replay (with the read of its
    outputs) runs. The graphs of a pool replay strictly one after
    another."""

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = None
        self.handle = None

    def ready(self, device: torch.device) -> None:
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
            self.handle = torch.cuda.graph_pool_handle()


class StepCache:
    """`cache(batch)`: one step, the counterpart of a jitted JAX step.

    `step_fn(batch)` returns a tensor or a tuple of tensors; a batch is a
    packed batch of numpy arrays (or already on the device), a tensor or
    a tuple of them. On the card each distinct `graph_key` is captured
    once into a CUDA graph, and each call copies the batch's arrays into
    that graph's input buffers, replays it and returns clones of its
    outputs (or `read(outputs)`, under the pool's lock, which threads
    calling one cache need: the next replay overwrites the outputs).

    A new key's first call runs one eager step of it on the pool's side
    stream, refusing every synchronising call, then captures it there;
    `state` (tensors the step updates in place: parameters, optimizer
    moments) and the `generators`' states are saved before and restored
    after the warm-up and the capture, so a call makes one step's
    updates, and the generators are registered with each graph, so each
    replay draws fresh. A step that a capture refuses raises, naming the
    operator; nothing runs eagerly in its place. On the CPU each call
    runs the step eagerly on the batch moved to `device`."""

    def __init__(self, step_fn: Callable, device=None,
                 state: Sequence[torch.Tensor] = (),
                 generators: Sequence[torch.Generator] = (),
                 pool: Optional[GraphPool] = None, name: str = "step"):
        self.step_fn = step_fn
        self.device = None if device is None else torch.device(device)
        self.state = list(state)
        self.generators = list(generators)
        self.pool = GraphPool() if pool is None else pool
        self.name = name
        self.graphs: Dict = {}

    def __call__(self, batch, read: Optional[Callable] = None, key=None):
        device = _device_of(batch, self.device)
        if device.type != "cuda":
            outputs = self.step_fn(_to(batch, device))
            return outputs if read is None else read(outputs)
        with self.pool.lock:
            outputs = self.replay(batch, key)
            return _clone(outputs) if read is None else read(outputs)

    def replay(self, batch, key=None):
        """The output buffers of one replay for `batch` on the card, its
        key captured first if new; the caller holds the pool's lock
        where threads share the cache. `key` (by default the batch's
        `graph_key`) names the graph: a caller whose batches are one
        rank's rows of a stack passes the stack's, which every rank
        computes alike, so that all ranks capture at the same step."""
        if key is None:
            key = graph_key(batch)
        if key not in self.graphs:
            self.capture({key: batch})
        return self.graphs[key].replay(batch)

    def capture(self, new: Dict) -> None:
        """Warm up, then capture, a graph of the step for each key of
        `new` ({key: batch}) on the side stream, the state and the
        generators restored after each phase and after a failure."""
        with span("ggnn.capture"):
            device = _device_of(next(iter(new.values())), self.device)
            self.pool.ready(device)
            saved = [t.detach().clone() for t in self.state]
            saved_generators = [g.get_state() for g in self.generators]
            statics = {key: _static_copy(batch, device)
                       for key, batch in new.items()}
            stream = self.pool.stream
            stream.wait_stream(torch.cuda.current_stream(device))
            try:
                with torch.cuda.stream(stream):
                    for static in statics.values():
                        with span("ggnn.capture.warm"):
                            self._warm(static)
                    self._restore(saved, saved_generators)
                    for key, static in statics.items():
                        with span("ggnn.capture.graph"):
                            self.graphs[key] = self._capture_one(static,
                                                                 device)
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
        # No garbage collection inside the capture: a collection there
        # can free an unreachable earlier graph, and destroying a graph
        # (`cudaGraphExecDestroy`) is refused while this thread captures,
        # which ends the capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            # Thread-local: another thread's synchronising call (a host
            # read, a packer thread's copy) does not end this capture.
            with torch.cuda.graph(graph, pool=self.pool.handle,
                                  stream=self.pool.stream,
                                  capture_error_mode="thread_local"):
                with last:
                    outputs = self.step_fn(static)
        except RuntimeError as err:
            raise RuntimeError(f"the capture of a {self.name} failed at "
                               f"{last.op}: {err}") from err
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        return StepGraph(
            graph, static, outputs,
            {k: after[k] - before[k] for k in after if after[k] != before[k]},
            ell_spmm.scratch_of(device, self.pool.stream.cuda_stream))

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
            raise RuntimeError(f"the warm-up of a {self.name} before its "
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


class EpochsFn:
    """`epochs_fn(groups, n_epochs)`: see `make_epochs_fn`; its steps are
    a `StepCache`'s (whose first output is the loss)."""

    def __init__(self, steps: StepCache):
        self.steps = steps

    @property
    def graphs(self) -> Dict:
        return self.steps.graphs

    def __call__(self, groups: Sequence[Sequence], n_epochs: int):
        with span("ggnn.epochs"):
            steps = [batch for group in groups for batch in group]
            if not steps:
                raise ValueError("no batch groups to run")
            device = _device_of(steps[0], self.steps.device)
            if device.type != "cuda":
                loss = torch.zeros((), device=device)
                for _ in range(n_epochs):
                    for batch in steps:
                        loss = _first(self.steps(batch))
                return loss
            with span("ggnn.epochs.keys"):
                keys = [graph_key(batch) for batch in steps]
                new = {}
                for key, batch in zip(keys, steps):
                    if key not in self.graphs:
                        new.setdefault(key, batch)
            with self.steps.pool.lock:
                if new:
                    self.steps.capture(new)
                loss = None
                for _ in range(n_epochs):
                    for key, batch in zip(keys, steps):
                        loss = _first(self.graphs[key].replay(batch))
                if loss is None:
                    return torch.zeros((), device=device)
                return loss.clone()

    def step_launches(self, groups: Sequence[Sequence]) -> List[Dict]:
        """{"module.counter": launches} a replay of each step of an epoch
        over `groups`, in step order (the groups must have run once)."""
        return [self.graphs[graph_key(batch)].launches
                for group in groups for batch in group]


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

    The steps are a `StepCache`'s: on the card one CUDA graph a
    `graph_key`, captured after one eager warm-up step with `state` (the
    parameters, the optimizer's count and moments) and the generators
    restored, so n_epochs epochs make exactly n_epochs x the steps'
    updates; each replay copies its batch device to device into its
    graph's input buffers. A step that a capture refuses raises, naming
    the operator. On the CPU the same steps run eagerly in the same
    order."""
    return EpochsFn(StepCache(step_fn, state=state, generators=generators,
                              name="train step"))


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

"""Spans: the port's host work timed where it happens.

`with span("ggnn.replay"): ...` marks an interval of the host's work by
name. Spans are off by default; then `span` checks one module flag and
returns one shared context that does nothing, so an instrumented path
pays a call and a test, and records nothing.

`on(True)` turns them on for the whole process. Each span is then kept
in memory as a `Span`: its name, its start and end as `time.time_ns()`,
its parent (the span open around it on the same thread, by id), its
thread, and small attributes, such as `step`, the index of a batch in
its epoch, which the pack of batch i in the prefetch thread and step i
share. `drain()` hands over what was kept and starts afresh. `pulls`
times each pull from an iterable as a span, the loops of a consumer and
of a producer alike.

`time.time_ns()` is the clock of `torch.profiler`'s events, so spans
line up with a device trace. While a profiler runs, each span also opens
a record function of its name, which puts the span among the trace's
host events (the `--profile` Chrome trace, a benchmark's device trace).
It is the profiler's fast record function, a host event with no shadow
on the device's timeline: `torch.profiler.record_function` costs ten
times as much under a profiler, which slowed a host-paced replay loop,
and costs microseconds even when no profiler runs, so none is opened
then. At most `CAP` spans are kept between drains; the rest are counted
as `spans_dropped`, and a reader of a count that is not 0 has lost
spans.

A span takes about 3 us of host time when on and 0.3 us when off (the
median on an H100 machine's host). Where the host paces the card, as a
dense replay loop does under a profiler, that time shows as device idle.
The recorder is one per process, as the profiler it lines up with is.
"""

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Tuple

import torch.autograd.profiler as _profiler

CAP = 1_000_000


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int     # the id of the span open around it on its thread, or 0
    thread: int     # threading.get_ident() of the thread that ran it
    attrs: Dict


_on = False
_OFF = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
# Each closed span as a plain tuple in `Span`'s order, made a `Span` when
# drained: the tuple is the cheaper to build on the path being timed.
_records: List[tuple] = []
_dropped = 0


def _stack() -> list:
    """The ids of the spans open on this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """A span being timed; kept when it closes."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "mirror")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.mirror = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        if _profiler._is_profiler_enabled:
            # A private class of torch's: imported only where a profiler
            # runs with the spans on, so no other path needs it.
            from torch._C._profiler import _RecordFunctionFast
            self.mirror = _RecordFunctionFast(self.name)
            self.mirror.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        end_ns = time.time_ns()
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        _stack().pop()
        record = (self.id, self.name, self.start_ns, end_ns, self.parent,
                  threading.get_ident(), self.attrs)
        with _lock:
            if len(_records) < CAP:
                _records.append(record)
            else:
                _dropped += 1
        return False


def span(name: str, **attrs):
    """A context that times its body as the span `name` when spans are
    on, and does nothing when they are off."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


_END = object()


def pulls(iterable, name: str):
    """(index, element) of each element of `iterable`, each pull from it
    timed as the span `name`, `step` the index; the pull that finds the
    end is a span too."""
    source = iter(iterable)
    for step in itertools.count():
        with span(name, step=step):
            element = next(source, _END)
        if element is _END:
            return
        yield step, element


def on(enabled: bool) -> bool:
    """Turns spans on or off; returns whether they were on."""
    global _on
    was, _on = _on, bool(enabled)
    return was


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """(the spans closed since the last drain, in the order they closed;
    {"spans_dropped": the spans beyond `CAP` that were not kept})."""
    global _records, _dropped
    with _lock:
        records, dropped = _records, _dropped
        _records, _dropped = [], 0
    return [Span._make(r) for r in records], {"spans_dropped": dropped}

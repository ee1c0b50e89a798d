"""Reading the device trace of a traced window.

`Tracer` runs `torch.profiler` (CPU and CUDA activities, every thread's
host events) around the window, which it marks with the span `WINDOW`.
From the raw events (the profiler's kineto results, without building
its per-operator tables) `summary` takes:

  * the window's seconds, the length of its span;
  * busy seconds: the union of the intervals in which a kernel, a copy or
    a memset ran on the device, inside the window; not a sum, so work
    that overlaps counts once (the device-side shadows of host spans are
    no work and are left out);
  * each device operation's total seconds by name;
  * the idle gaps, each named by what the host was doing at its middle
    (the innermost host event there: a PyTorch operator, or a span the
    benchmark records around its calls into the port), summed by name;
    gaps under 10 us, between the kernels of one launch or graph, summed
    apart.
"""

import contextlib
import heapq
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
TOP = 10
NAME_CHARS = 120
SHORT_GAP_NS = 10_000


class TraceSummary:
    def __init__(self, busy_s: float, window_s: float,
                 device_ops: List[Tuple[str, float]],
                 idle_gaps: List[Tuple[str, float]],
                 kernels: Dict[str, float]):
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.kernels = kernels          # seconds by full name

    def kernel_seconds(self, fragment: str) -> float:
        """Seconds of the device operations whose name holds `fragment`."""
        return sum(s for name, s in self.kernels.items() if fragment in name)


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap of at least
    `SHORT_GAP_NS` named by the innermost host event at its middle (a
    sweep over the events by start, a heap of the open ones by end); the
    shorter gaps, between the kernels of one launch or graph, summed
    under one name."""
    idle: Dict[str, float] = {}
    short = f"between kernels (gaps under {SHORT_GAP_NS // 1000} us)"
    long_gaps = []
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_NS:
            idle[short] = idle.get(short, 0.0) + (g1 - g0) * 1e-9
        else:
            long_gaps.append(((g0 + g1) // 2, g1 - g0))
    host = sorted(h for h in host if h[2] != WINDOW)
    open_events: list = []
    at = 0
    for mid, length in sorted(long_gaps):
        while at < len(host) and host[at][0] <= mid:
            start, end, name = host[at]
            heapq.heappush(open_events, (end, end - start, name))
            at += 1
        while open_events and open_events[0][0] <= mid:
            heapq.heappop(open_events)
        label = (min(open_events, key=lambda o: o[1])[2] if open_events
                 else "host outside any operator")
        idle[label] = idle.get(label, 0.0) + length * 1e-9
    return idle


def _annotation(event) -> bool:
    is_annotation = getattr(event, "is_user_annotation", None)
    return bool(is_annotation and is_annotation()) or \
        event.name().startswith("portbench.")


def summarize(events) -> Optional[TraceSummary]:
    """The summary of a window's raw events, or None where the trace has
    no window span. `events` yields objects with name(), device_type(),
    start_ns() and duration_ns(), as the profiler's kineto events do."""
    device, host, window = [], [], None
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # A host span's shadow on the device's timeline is no work.
            if not _annotation(e):
                device.append((start, start + dur, e.name()))
        else:
            if e.name() == WINDOW:
                window = (start, start + dur)
            host.append((start, start + dur, e.name()))
    if window is None:
        return None
    w0, w1 = window
    kernels: Dict[str, float] = {}
    intervals = []
    for start, end, name in device:
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        intervals.append((start, end))
        kernels[name] = kernels.get(name, 0.0) + (end - start) * 1e-9
    merged = _merge(intervals)
    busy_s = sum(e - s for s, e in merged) * 1e-9
    gaps, cursor = [], w0
    for start, end in merged + [(w1, w1)]:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)
    idle = _name_gaps(gaps, host)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(busy_s, (w1 - w0) * 1e-9,
                        [[_short(n), s] for n, s in top_ops],
                        [[_short(n), s] for n, s in top_gaps], kernels)


def _all_threads():
    """A profiler configuration that records every thread's host events
    (the clients and the prefetch thread too), where this PyTorch has
    the option; None, the default, elsewhere."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


class Tracer:
    """`with tracer.window(): ...` profiles the window when enabled."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.profile = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            with torch.profiler.record_function(WINDOW):
                yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts,
                                    experimental_config=_all_threads()
                                    ) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
        self.profile = prof

    def summary(self) -> Optional[TraceSummary]:
        if self.profile is None:
            return None
        return summarize(self.profile.profiler.kineto_results.events())

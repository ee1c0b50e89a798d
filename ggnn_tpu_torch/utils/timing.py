"""Timing on the card, the counterpart of `ggnn_tpu/utils/timing.py`.

`time_ms` times one call by CUDA events around each call, with the
stream held busy while the calls are queued, in groups that fit the
launch queue, so that the events bracket the device work and not the
host's launch; `gpu_name_and_power` names the card a time was taken on.
Both need a CUDA device.
"""

import statistics
import subprocess
import time

import torch

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

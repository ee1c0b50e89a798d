"""Timing on the card, the counterpart of `ggnn_tpu/utils/timing.py`.

`time_ms` times one call by CUDA events around each call, with the
stream held busy while the calls are queued, so that the events bracket
the device work and not the host's launch; `gpu_name_and_power` names
the card a time was taken on. Both need a CUDA device.
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


def time_ms(fn, iters: int = 50, warmup: int = 5):
    """(device ms, host ms) of one call.

    Device ms is the median over `iters` calls of CUDA events recorded
    around each call, with the stream held busy by a sleep kernel while
    the host enqueues them all: the events then bracket the call's device
    work alone, not the host's time to launch it. Host ms is the mean
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
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    # Sleep for twice the host's enqueue time, so the queue never drains.
    torch.cuda._sleep(int(_sleep_cycles_per_ms()
                          * max(2.0 * host_ms * iters, 1.0)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    device_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    return device_ms, host_ms


def gpu_name_and_power() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]

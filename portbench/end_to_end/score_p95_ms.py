"""The 95th percentile of the latencies of every request answered in the
scoring window, in milliseconds (host clock)."""

from portbench.windows import quantile


def read(window, setup_s):
    p95 = quantile(window.latencies_s, 0.95)
    return None if p95 is None else p95 * 1e3

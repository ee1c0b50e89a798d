"""Device idle share in a window of scoring, as portbench/readers.py
computes it. Moves `score_graphs_per_s`."""

from portbench.readers import device_idle as read  # noqa: F401

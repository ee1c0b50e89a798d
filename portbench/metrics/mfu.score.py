"""Model FLOP utilisation in a window of scoring, as
portbench/readers.py computes it. Moves `score_graphs_per_s`."""

from portbench.readers import mfu as read  # noqa: F401

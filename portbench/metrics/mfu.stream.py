"""Model FLOP utilisation in a window of streamed training, as
portbench/readers.py computes it. Moves `train_graphs_per_s.stream`."""

from portbench.readers import mfu as read  # noqa: F401

"""Roofline share of the aggregation kernels B1/B2 in a window of
streamed training, as portbench/readers.py computes it. Moves
`train_graphs_per_s.stream`."""

from portbench.readers import agg_roofline as read  # noqa: F401

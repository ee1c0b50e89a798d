"""Roofline share of the aggregation kernels B1/B2 in a window of
scoring, as portbench/readers.py computes it. Moves
`score_graphs_per_s`."""

from portbench.readers import agg_roofline as read  # noqa: F401

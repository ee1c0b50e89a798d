"""Device idle share in a window of the sparse GGNN's resident training,
as portbench/readers.py computes it. Moves
`train_graphs_per_s.sparse_resident`."""

from portbench.readers import device_idle as read  # noqa: F401

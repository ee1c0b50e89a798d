"""Microbenchmarks of the port's kernels on the card, the counterparts of
`benchmarks/probes/`."""

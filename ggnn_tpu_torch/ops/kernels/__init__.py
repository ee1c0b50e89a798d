"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and a launch counter (one module per source under csrc/)."""

# (module, counter) of every kernel's launch counter: B1, B2, the
# weighted instance and its transpose (csrc/ell_spmm.cu), B3
# (csrc/gather_floor.cu) and edge_dot (csrc/edge_dot.cu), then the bf16
# instances' own counters, then the GRU kernels' (csrc/gru.cu): K1 and K2,
# K3 and K4.
COUNTERS = (("ell_spmm", "launches"), ("ell_spmm", "scatter_launches"),
            ("gather_floor", "launches"), ("ell_spmm", "weighted_launches"),
            ("ell_spmm", "weighted_scatter_launches"),
            ("edge_dot", "launches"),
            ("ell_spmm", "launches_bf16"),
            ("ell_spmm", "scatter_launches_bf16"),
            ("gather_floor", "launches_bf16"),
            ("ell_spmm", "weighted_launches_bf16"),
            ("ell_spmm", "weighted_scatter_launches_bf16"),
            ("edge_dot", "launches_bf16"),
            ("gru", "launches"), ("gru", "backward_launches"))


def launch_counts() -> dict:
    """{"module.counter": launches so far} of every kernel counter."""
    from ggnn_tpu_torch.ops.kernels import (edge_dot, ell_spmm,
                                            gather_floor, gru)
    modules = {"ell_spmm": ell_spmm, "gather_floor": gather_floor,
               "edge_dot": edge_dot, "gru": gru}
    return {f"{m}.{c}": getattr(modules[m], c) for m, c in COUNTERS}

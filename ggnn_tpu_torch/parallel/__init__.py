"""Multi-GPU training over a (data, edge) mesh of `torch.distributed`
ranks: the port of `ggnn_tpu/parallel/` (ROADMAP A11).

  data — data parallelism: each step's n_data independently packed
         batches, one (or b_local) a data rank; the losses' sums and the
         gradients are summed over the ranks.
  edge — graph parallelism: a packed batch's nodes split into
         contiguous ranges, one a rank, with a boundary exchange each
         propagation step (node_shard.py; `sparse`, `rgcn`, `gcn`), or
         the [T, H, H] weights' type axis split (tp.py; `sparse`,
         `rgcn`).

Each mesh position is a process (`initialize_distributed`, then
`make_mesh`); every rank runs the same program on its own row and
shard. The re-exports are JAX's, less `overlap_compiler_options`,
`stacked_batch_specs` and `stack_from_process_local`, which have no
counterpart here (mesh.py, stacking.py say why). `make_parallel_steps`
loads on first access: the models import this package's collectives.
"""

from ggnn_tpu_torch.parallel.mesh import (DATA_AXIS, EDGE_AXIS,
                                          initialize_distributed,
                                          make_mesh)
from ggnn_tpu_torch.parallel.stacking import (empty_batch_like,
                                              repad_edges, stack_batches)


def __getattr__(name):
    if name == "make_parallel_steps":
        from ggnn_tpu_torch.parallel.step import make_parallel_steps
        return make_parallel_steps
    raise AttributeError(
        f"module 'ggnn_tpu_torch.parallel' has no attribute '{name}'")

"""Compute ops with TF1.3 numerics; the re-exports of
`ggnn_tpu/ops/__init__.py` under the port's names. The JAX package's
init/apply function pairs are modules here:

  * `gru_init` / `gru_apply` -> `GRUCell` (`.step`, or the module call
    with its state dropout);
  * `cudnn_gru_init` / `cudnn_gru_apply` -> `CudnnCompatibleGRUCell`;
  * `rnn_init` / `rnn_apply` -> `RNNCell`;
  * `make_cell` -> `make_cell`, which returns the cell's constructor;
  * `mlp_init` / `mlp_apply` keep their names (`mlp_init` returns a
    `ModuleList` of `MLPLayer`);
  * `dropout` is the module `ops.dropout` here, its function
    `ops.dropout.dropout`: a package attribute of the function's name
    would hide the module from `from ggnn_tpu_torch.ops import dropout`
    and `import ggnn_tpu_torch.ops.dropout as ...`.

The hand-written kernels are under `ops/kernels/`; importing this
package builds none of them.
"""

from ggnn_tpu_torch.ops.cells import (CudnnCompatibleGRUCell, GRUCell,
                                      RNNCell, make_cell)
from ggnn_tpu_torch.ops import dropout
from ggnn_tpu_torch.ops.mlp import mlp_apply, mlp_init
from ggnn_tpu_torch.ops.segment import (segment_max, segment_softmax,
                                        segment_sum)

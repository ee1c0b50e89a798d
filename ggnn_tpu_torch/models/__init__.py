"""The models; the re-exports of `ggnn_tpu/models/__init__.py`. Each
model is a `torch.nn.Module` holding its parameters, where the JAX
package's is a pair of `init_params` and `forward` functions."""

from ggnn_tpu_torch.models.base import (gated_regression_nodes,
                                        init_output_heads,
                                        masked_regression_loss)
from ggnn_tpu_torch.models.async_ggnn import AsyncGGNN
from ggnn_tpu_torch.models.dense_ggnn import DenseGGNN
from ggnn_tpu_torch.models.gcn import GCN
from ggnn_tpu_torch.models.sparse_ggnn import SparseGGNN

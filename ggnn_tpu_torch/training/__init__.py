"""Configs, optimizer, checkpoints and the epoch loop; the re-exports of
`ggnn_tpu/training/__init__.py` under the port's names:

  * `tf_adam` / `make_optimizer` -> `TFAdam`, an object that holds the
    Adam state and updates the parameters in place;
  * `clip_by_norm_per_leaf` -> `clip_by_norm` of one tensor, which
    `TFAdam.step` applies to each gradient.

The Runner is `ggnn_tpu_torch.training.runner.Runner` (or
`ggnn_tpu_torch.Runner`), as in the JAX package.
"""

from ggnn_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
from ggnn_tpu_torch.training.config import (ASYNC_DEFAULTS, BASE_DEFAULTS,
                                            DENSE_DEFAULTS, GCN_DEFAULTS,
                                            RGCN_CONFIG, SPARSE_DEFAULTS,
                                            default_params_for,
                                            resolve_config)
from ggnn_tpu_torch.training.optimizer import TFAdam, clip_by_norm

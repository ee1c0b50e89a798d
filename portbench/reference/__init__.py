"""The plain reference the benchmark holds the port to.

Plain PyTorch in the configuration's precision (float32 with TF32 off),
written from the equations of the published GGNN code
(chem_tensorflow.py, chem_tensorflow_sparse.py, chem_tensorflow_dense.py):
no kernel, no cache, no CUDA graph, and nothing of the port or of the
JAX package. `data` makes its batches from the benchmark's molecules,
`common` the parts the models share, and each model is a module of its
own, which a configuration names under `reference`: `sparse_ggnn`,
`dense_ggnn`. A model refuses a configuration that states a key it does
not implement, or a value it does not implement.
"""

import importlib
import re
from typing import Dict

_NAME = re.compile(r"^[a-z][a-z0-9_]*$")


def model_for(config: Dict):
    """The reference model module a configuration names, after checking
    that it implements every key and value of the configuration's
    `model` and its precision."""
    from portbench.reference import common
    name = config["reference"]
    if not _NAME.match(name) or name in ("common", "data"):
        raise ValueError(f"no reference model {name!r}")
    module = importlib.import_module(f"portbench.reference.{name}")
    common.check_model(name, module.KEYS, config["model"])
    common.precision_of(config)
    return module

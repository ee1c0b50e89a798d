"""ggnn_tpu_torch — the PyTorch/CUDA port of ggnn_tpu for NVIDIA Hopper.

The JAX package `ggnn_tpu` stays the reference; this package mirrors its
module names and parameter layouts and imports nothing from it. Entry
points run on the GPU unless the caller asks for the CPU
(`device="cpu"`); the hand-written CUDA kernels live under `csrc/` and
build on first use (`ops/kernels/_build.py`).

The top-level names are those of `ggnn_tpu/__init__.py`. `Runner`,
`Predictor`, `resolve_config`, `synthetic_molecules` and `make_mesh`
(multi-GPU training, parallel/) load on first access, so
`import ggnn_tpu_torch` stays light.
"""

__version__ = "0.1.0"

from ggnn_tpu_torch.graph import DenseGraphBatch, GraphBatch
from ggnn_tpu_torch.utils.constants import CHEMICAL_ACCURACIES, SMALL_NUMBER


def __getattr__(name):
    if name == "Runner":
        from ggnn_tpu_torch.training.runner import Runner
        return Runner
    if name == "Predictor":
        from ggnn_tpu_torch.serving import Predictor
        return Predictor
    if name == "resolve_config":
        from ggnn_tpu_torch.training.config import resolve_config
        return resolve_config
    if name == "synthetic_molecules":
        from ggnn_tpu_torch.data.synthetic import synthetic_molecules
        return synthetic_molecules
    if name == "make_mesh":
        from ggnn_tpu_torch.parallel.mesh import make_mesh
        return make_mesh
    raise AttributeError(f"module 'ggnn_tpu_torch' has no attribute '{name}'")

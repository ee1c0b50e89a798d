"""Optimizer: TF1-semantics Adam with per-leaf gradient-norm clipping.

The port of `ggnn_tpu/training/optimizer.py`. The reference clips each
gradient tensor *individually* with `tf.clip_by_norm` at
`clamp_gradient_norm`, not by the global norm (chem_tensorflow.py:
185-190), so `torch.nn.utils.clip_grad_norm_` does not apply. It then
applies `tf.train.AdamOptimizer`, whose update folds the bias
corrections into the step size and keeps eps outside them:

    lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
    p   -= lr_t * m / (sqrt(v) + eps)        (m, v uncorrected, eps=1e-8)

which `torch.optim.Adam` (eps inside the correction) does not compute,
so the update is written out here.

The step count lives in a float64 tensor on the parameters' device, and
`lr_t` is computed there from it in float64, so a step captured into a
CUDA graph counts and scales each replay as an eager step does;
`count` reads and sets it as an int (the checkpoint's JAX layout).

`--freeze-graph-model` removes the graph-model subtree from the
trainable set (chem_tensorflow.py:174-182): its parameters get no update
and no Adam state, as `optax.multi_transform` with `set_to_zero` gives
in the JAX package.
"""

from typing import Callable, Dict, List, Optional

import torch
from torch import nn

# tf.train.AdamOptimizer's defaults, which the reference keeps.
B1, B2, EPS = 0.9, 0.999, 1e-8


def clip_by_norm(g: torch.Tensor, clip_norm: float,
                 norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tf.clip_by_norm of one tensor: g * clip / max(||g||, clip). `norm`
    replaces ||g|| (a type-sharded leaf's global norm)."""
    if norm is None:
        norm = g.square().sum().sqrt()
    return g * (clip_norm / torch.clamp(norm, min=clip_norm))


class TFAdam:
    """Per-leaf clip, then TF1 Adam, over the trainable parameters of a
    module (`ModelParams`), keyed by parameter name.

    `step(grads)` takes {name: gradient} for the trainable parameters (a
    missing or None gradient counts as zero, as in the JAX package,
    whose gradient tree always holds every leaf) and updates the
    parameters in place.

    Under type-TP (parallel/tp.py) some leaves are slices of a variable
    split over the mesh's edge axis: `tp_axis` (that `Axis`) and
    `tp_is_sharded(name)` select them, and the clip of each takes the
    GLOBAL norm, its squared norm summed over the axis, as the reference
    clips the whole variable (JAX's `tp_axis`, `ggnn_tpu/training/
    optimizer.py:24-45`)."""

    def __init__(self, params: nn.Module, learning_rate: float,
                 clamp_gradient_norm: float,
                 freeze_graph_model: bool = False,
                 tp_axis=None, tp_is_sharded: Optional[Callable] = None):
        self.learning_rate = learning_rate
        self.clamp_gradient_norm = clamp_gradient_norm
        self.freeze_graph_model = freeze_graph_model
        self.tp_axis = tp_axis
        self.tp_is_sharded = tp_is_sharded
        self.params: Dict[str, nn.Parameter] = {
            name: p for name, p in params.named_parameters()
            if not (freeze_graph_model and name.startswith("graph."))}
        device = next(params.parameters()).device
        # float64 holds every count a run reaches exactly, and gives
        # lr_t the double arithmetic of the host's `math` version.
        self._count = torch.zeros((), dtype=torch.float64, device=device)
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

    @property
    def count(self) -> int:
        """Updates applied so far (a host read of the device count)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor `step` updates besides the parameters: the count
        and the moments."""
        return [self._count, *self.mu.values(), *self.nu.values()]

    @torch.no_grad()
    def step(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        t = self._count.add_(1)
        # lr * sqrt(1 - b2^t) / (1 - b1^t) in float64 on the device; the
        # product below rounds it to float32 as a Python float would be.
        lr_t = self.learning_rate * torch.sqrt(1 - B2 ** t) / (1 - B1 ** t)
        grads = {name: (torch.zeros_like(p) if grads.get(name) is None
                        else grads[name])
                 for name, p in self.params.items()}
        norms = self._sharded_norms(grads)
        for name, p in self.params.items():
            g = clip_by_norm(grads[name], self.clamp_gradient_norm,
                             norms.get(name))
            m, v = self.mu[name], self.nu[name]
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).add_(g.square(), alpha=1 - B2)
            p.sub_(lr_t * m / (v.sqrt() + EPS))

    def _sharded_norms(self, grads) -> Dict[str, torch.Tensor]:
        """{name: global norm} of the type-sharded leaves: their squared
        norms summed over `tp_axis` in one reduction."""
        if self.tp_axis is None or self.tp_is_sharded is None:
            return {}
        names = [n for n in grads if self.tp_is_sharded(n)]
        if not names:
            return {}
        squares = torch.stack([grads[n].square().sum() for n in names])
        return dict(zip(names, self.tp_axis.all_reduce(squares).sqrt()))

"""MLP with the reference's semantics (utils.py:39-71).

  * dropout is applied to the weight MATRICES, not the activations
    (training only; one mask per layer from the generator);
  * ReLU between layers, but the FINAL layer output is the
    pre-activation (`last_hidden` is returned before the trailing ReLU);
  * uniform Glorot weights, zero biases.

Default regression heads are single linear layers (`hid_sizes=[]`,
chem_tensorflow.py:153-157). Parameters are named `W` and `b`, the
names of `ggnn_tpu/ops/mlp.py`, so weights bridge by name.
"""

from typing import Sequence

import torch
from torch import nn

from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.utils.init import glorot_init, zeros_init


class MLPLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, generator: torch.Generator):
        super().__init__()
        self.W = nn.Parameter(glorot_init(generator, (d_in, d_out)))
        self.b = nn.Parameter(zeros_init(generator, (d_out,)))


def mlp_init(generator: torch.Generator, in_size: int, out_size: int,
             hid_sizes: Sequence[int] = ()) -> nn.ModuleList:
    dims = [in_size] + list(hid_sizes) + [out_size]
    return nn.ModuleList(MLPLayer(d_in, d_out, generator)
                         for d_in, d_out in zip(dims[:-1], dims[1:]))


def mlp_apply(layers: nn.ModuleList, inputs: torch.Tensor, *,
              keep_prob: float = 1.0,
              generator: torch.Generator = None) -> torch.Tensor:
    acts = inputs
    hid = acts
    for layer in layers:
        w = dropout(layer.W, keep_prob, generator)
        hid = torch.matmul(acts, w) + layer.b
        acts = torch.relu(hid)
    return hid

"""Recurrent node-update cells with TF 1.3 gate math.

The propagation step feeds aggregated messages into an RNN cell whose
previous state is the node state (chem_tensorflow_sparse.py:102-115,
215-216). Kernels keep TF1's [x; h] row layout, the layout of
`ggnn_tpu/ops/cells.py`, so weights bridge by name with no transposes:

GRUCell (TF 1.3 tf.nn.rnn_cell.GRUCell):
    [r, u] = sigmoid([x, h] @ W_g + b_g)         b_g initialised to 1.0
    c      = act([x, r * h] @ W_c + b_c)         b_c initialised to 0.0
    h'     = u * h + (1 - u) * c

CudnnCompatibleGRUCell: same gates, the reset gate applied after the
recurrent product, with separate input/state candidate kernels:
    c  = act(x @ W_ci + b_ci + r * (h @ W_ch + b_ch))

BasicRNNCell:
    h' = act([x, h] @ W + b)                     b initialised to 0.0

The [x; h] @ W products run as split-K partial products (no concat),
which rounds differently from one product at ~1e-7. In training the new
state goes through TF1 dropout with `state_keep_prob`
(`DropoutWrapper(state_keep_prob)`, ggnn_tpu/ops/cells.py:161-167).
"""

from typing import Callable

import torch
from torch import nn

from ggnn_tpu_torch.ops.dropout import dropout
from ggnn_tpu_torch.utils.init import glorot_init, ones_init, zeros_init


class _Cell(nn.Module):
    def __init__(self, activation: Callable, state_keep_prob: float):
        super().__init__()
        self.activation = activation
        self.state_keep_prob = state_keep_prob

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                is_training: bool = False,
                generator: torch.Generator = None) -> torch.Tensor:
        new_h = self.step(x, h)
        if is_training:
            new_h = dropout(new_h, self.state_keep_prob, generator)
        return new_h


class GRUCell(_Cell):
    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, activation: Callable = torch.tanh,
                 state_keep_prob: float = 1.0):
        super().__init__(activation, state_keep_prob)
        d, hd = input_size + hidden_size, hidden_size
        self.gates_kernel = nn.Parameter(glorot_init(generator, (d, 2 * hd)))
        self.gates_bias = nn.Parameter(ones_init(generator, (2 * hd,)))
        self.candidate_kernel = nn.Parameter(glorot_init(generator, (d, hd)))
        self.candidate_bias = nn.Parameter(zeros_init(generator, (hd,)))

    def step(self, x, h):
        d_in = x.shape[-1]
        hdim = h.shape[-1]
        w_g, w_c = self.gates_kernel, self.candidate_kernel
        # The two x-side products as ONE [*, 3H] product.
        xs = torch.matmul(x, torch.cat([w_g[:d_in], w_c[:d_in]], dim=1))
        gates = torch.sigmoid(xs[..., :2 * hdim]
                              + torch.matmul(h, w_g[d_in:]) + self.gates_bias)
        r, u = gates.chunk(2, dim=-1)
        c = self.activation(xs[..., 2 * hdim:]
                            + torch.matmul(r * h, w_c[d_in:])
                            + self.candidate_bias)
        return u * h + (1.0 - u) * c


class CudnnCompatibleGRUCell(_Cell):
    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, activation: Callable = torch.tanh,
                 state_keep_prob: float = 1.0):
        super().__init__(activation, state_keep_prob)
        d_in, hd = input_size, hidden_size
        self.gates_kernel = nn.Parameter(
            glorot_init(generator, (d_in + hd, 2 * hd)))
        self.gates_bias = nn.Parameter(ones_init(generator, (2 * hd,)))
        self.candidate_input_kernel = nn.Parameter(
            glorot_init(generator, (d_in, hd)))
        self.candidate_input_bias = nn.Parameter(zeros_init(generator, (hd,)))
        self.candidate_hidden_kernel = nn.Parameter(
            glorot_init(generator, (hd, hd)))
        self.candidate_hidden_bias = nn.Parameter(
            zeros_init(generator, (hd,)))

    def step(self, x, h):
        d_in = x.shape[-1]
        w_g = self.gates_kernel
        gates = torch.sigmoid(torch.matmul(x, w_g[:d_in])
                              + torch.matmul(h, w_g[d_in:]) + self.gates_bias)
        r, u = gates.chunk(2, dim=-1)
        c_x = torch.matmul(x, self.candidate_input_kernel) \
            + self.candidate_input_bias
        c_h = torch.matmul(h, self.candidate_hidden_kernel) \
            + self.candidate_hidden_bias
        c = self.activation(c_x + r * c_h)
        return u * h + (1.0 - u) * c


class RNNCell(_Cell):
    def __init__(self, input_size: int, hidden_size: int,
                 generator: torch.Generator, activation: Callable = torch.tanh,
                 state_keep_prob: float = 1.0):
        super().__init__(activation, state_keep_prob)
        self.kernel = nn.Parameter(glorot_init(
            generator, (input_size + hidden_size, hidden_size)))
        self.bias = nn.Parameter(zeros_init(generator, (hidden_size,)))

    def step(self, x, h):
        d_in = x.shape[-1]
        return self.activation(torch.matmul(x, self.kernel[:d_in])
                               + torch.matmul(h, self.kernel[d_in:])
                               + self.bias)


_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}

_CELLS = {
    "gru": GRUCell,
    "cudnncompatiblegrucell": CudnnCompatibleGRUCell,
    "rnn": RNNCell,
}


def make_cell(cell_type: str, activation_name: str,
              state_keep_prob: float = 1.0):
    """Return `build(input_size, hidden_size, generator) -> cell module`
    for a named cell/activation combo, with the validation of
    chem_tensorflow_sparse.py:102-115 (CudnnCompatibleGRUCell requires
    tanh)."""
    cell_key = cell_type.lower()
    act_key = activation_name.lower()
    if act_key not in _ACTIVATIONS:
        raise ValueError(
            f"Unknown activation function type '{activation_name}'.")
    if cell_key not in _CELLS:
        raise ValueError(f"Unknown RNN cell type '{cell_type}'.")
    if cell_key == "cudnncompatiblegrucell" and act_key != "tanh":
        raise ValueError("CudnnCompatibleGRUCell requires tanh activation.")
    cls = _CELLS[cell_key]
    activation = _ACTIVATIONS[act_key]

    def build(input_size: int, hidden_size: int,
              generator: torch.Generator) -> _Cell:
        return cls(input_size, hidden_size, generator, activation,
                   state_keep_prob)

    return build

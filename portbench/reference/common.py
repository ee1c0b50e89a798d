"""What the reference's models share, in plain PyTorch: products in the
configuration's precision, the published initialisation, TF1 dropout,
the cells, the readout, the loss and the TF1 Adam steps.

Both published GGNNs read out per molecule sum(sigmoid([h, x] @ Wg +
bg) * (h @ Wt + bt)) and lose 0.5 (prediction - target)^2 summed over
the batch and divided by its size + SMALL_NUMBER (chem_tensorflow.py).
Training clips each gradient to norm `clamp_gradient_norm` and applies
TF1's Adam (lr_t = lr sqrt(1 - b2^t) / (1 - b1^t), eps outside the
correction).

The GRU is TF 1.3's: [r, u] = sigmoid([x, h] @ Wg + bg), c = act([x,
r h] @ Wc + bc), h' = u h + (1 - u) c; the plain RNN cell is h' = act([x,
h] @ W + b). Parameter names are the checkpoint layout of the published
models' variables, the names the benchmark gives the weights it makes.

A configuration states its precision (`precision`, `tf32`); the
reference computes in it, and its control computes in the precision
below (`CONTROL`): TF32 products for float32 with TF32 off. On the card
the control turns TF32 on; on the CPU it rounds the products' inputs to
TF32's 10 mantissa bits itself.
"""

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch

SMALL_NUMBER = 1e-7
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# The precision a configuration states -> the reference's products in it.
PRECISIONS = {("float32", False): "float32"}
# The precision a configuration states -> the control's, the one below.
CONTROL = {("float32", False): "tf32"}


def _stated(config: Dict) -> Tuple[str, bool]:
    return (config["precision"], bool(config["tf32"]))


def precision_of(config: Dict) -> str:
    """The reference's precision for a configuration; raises where the
    reference has none for what the configuration states."""
    stated = _stated(config)
    if stated not in PRECISIONS:
        raise ValueError(f"the reference computes no precision {stated}")
    return PRECISIONS[stated]


def control_of(config: Dict) -> str:
    """The control's precision: the one below the configuration's."""
    precision_of(config)
    return CONTROL[_stated(config)]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Products:
    """Matrix products in a precision: "float32" or "tf32"."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32" and a.device.type != "cuda":
            return torch.matmul(_round_tf32(a), _round_tf32(b))
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def context(self):
        """TF32 off for float32, on for the control, restored after."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


# ------------------------------------------------- configuration keys

def one_of(*values) -> Callable:
    """A key whose value must be one of `values` (strings compared
    without case)."""
    def ok(v):
        key = v.lower() if isinstance(v, str) else v
        return any(key == (w.lower() if isinstance(w, str) else w)
                   for w in values)
    ok.wants = values
    return ok


def number(low: float, high: float) -> Callable:
    """A number in [low, high]."""
    def ok(v):
        return (isinstance(v, (int, float)) and not isinstance(v, bool)
                and low <= v <= high)
    ok.wants = f"a number in [{low}, {high}]"
    return ok


def check_model(name: str, keys: Dict[str, Callable], model: Dict) -> None:
    """Raise unless `model` states exactly the keys the reference model
    `name` implements, each with a value it implements."""
    missing = sorted(set(keys) - set(model))
    unknown = sorted(set(model) - set(keys))
    wrong = sorted(k for k in set(keys) & set(model) if not keys[k](model[k]))
    if missing or unknown or wrong:
        unsupported = [(k, model[k], getattr(keys[k], "wants", None))
                       for k in wrong]
        raise ValueError(
            f"the reference {name!r} does not implement this configuration: "
            f"missing {missing}, unknown {unknown}, unsupported {unsupported}")


# --------------------------------------------------------- parameters

def cell_shapes(shapes: Dict, prefix: str, cell: str, d_in: int,
                hidden: int) -> None:
    if cell.lower() == "gru":
        shapes[f"{prefix}.gates_kernel"] = (d_in + hidden, 2 * hidden)
        shapes[f"{prefix}.gates_bias"] = (2 * hidden,)
        shapes[f"{prefix}.candidate_kernel"] = (d_in + hidden, hidden)
        shapes[f"{prefix}.candidate_bias"] = (hidden,)
    else:
        shapes[f"{prefix}.kernel"] = (d_in + hidden, hidden)
        shapes[f"{prefix}.bias"] = (hidden,)


def head_shapes(shapes: Dict, hidden: int) -> None:
    """One regression task's gated readout."""
    shapes["heads.task0.gate.0.W"] = (2 * hidden, 1)
    shapes["heads.task0.gate.0.b"] = (1,)
    shapes["heads.task0.transform.0.W"] = (hidden, 1)
    shapes["heads.task0.transform.0.b"] = (1,)


def init_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The published initialisation from `seed`, drawn on `device` in one
    call: Glorot-uniform kernels over their last two dimensions (an edge
    weight stack as one [T*H, H] matrix), GRU gate biases 1, other biases
    0."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    draw = torch.rand(total, generator=gen, dtype=torch.float32,
                      device=device)
    weights, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = draw[at:at + n].reshape(shape)
        at += n
        if name.endswith("gates_bias"):
            weights[name] = torch.ones(shape, device=device)
        elif len(shape) == 1 or name.endswith("edge_biases"):
            weights[name] = torch.zeros(shape, device=device)
        else:
            fan = (shape[0] * shape[1], shape[2]) if len(shape) == 3 \
                else shape
            limit = math.sqrt(6.0 / (fan[0] + fan[1]))
            weights[name] = u * (2.0 * limit) - limit
    return weights


# ---------------------------------------------------------- the parts

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def dropout(w: torch.Tensor, keep: float, gen) -> torch.Tensor:
    """TF1 dropout: keep each entry with probability `keep`, scaled by
    1 / keep. The mask is drawn as a uniform [0, 1) float32 tensor of
    w's shape from `gen`, on w's device, kept where below `keep`."""
    if keep >= 1.0:
        return w
    u = torch.rand(w.shape, generator=gen, dtype=torch.float32,
                   device=w.device)
    return torch.where(u < keep, w / keep, torch.zeros_like(w))


def cell(p: Products, w: Dict, prefix: str, kind: str, activation: str,
         x, h):
    act = ACTIVATIONS[activation.lower()]
    if kind.lower() == "rnn":
        return act(p.mm(torch.cat([x, h], -1), w[f"{prefix}.kernel"])
                   + w[f"{prefix}.bias"])
    hd = h.shape[-1]
    gates = torch.sigmoid(p.mm(torch.cat([x, h], -1),
                               w[f"{prefix}.gates_kernel"])
                          + w[f"{prefix}.gates_bias"])
    r, u = gates[:, :hd], gates[:, hd:]
    c = act(p.mm(torch.cat([x, r * h], -1), w[f"{prefix}.candidate_kernel"])
            + w[f"{prefix}.candidate_bias"])
    return u * h + (1.0 - u) * c


def gated_nodes(p: Products, w: Dict, last_h, init_h):
    gate = torch.sigmoid(p.mm(torch.cat([last_h, init_h], -1),
                              w["heads.task0.gate.0.W"])
                         + w["heads.task0.gate.0.b"])
    return gate * (p.mm(last_h, w["heads.task0.transform.0.W"])
                   + w["heads.task0.transform.0.b"])


def loss_of(pred: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    diff = pred - targets
    return (0.5 * diff.square()).sum() / (diff.numel() + SMALL_NUMBER)


# ------------------------------------------------------------ training

def clip_by_norm(g: torch.Tensor, clip: float) -> torch.Tensor:
    norm = g.square().sum().sqrt()
    return g * (clip / torch.clamp(norm, min=clip))


def train_steps(p: Products, forward: Callable,
                weights: Dict[str, torch.Tensor], model: Dict,
                batches: Sequence, random_seed: int
                ) -> Tuple[List[float], Dict, Dict]:
    """Train from `weights` (left unchanged) on `batches`, one step each,
    with `forward(p, w, model, batch, train, gen)`: (each step's loss,
    the first step's clipped gradients, the weights after the last
    step). Dropout masks come from a generator on the weights' device
    seeded with `random_seed`, drawn in the order the published model
    draws them."""
    device = next(iter(weights.values())).device
    gen = torch.Generator(device=device).manual_seed(int(random_seed))
    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in weights.items()}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    lr, clamp = model["learning_rate"], model["clamp_gradient_norm"]
    losses, first = [], None
    with p.context():
        for step, batch in enumerate(batches, start=1):
            loss = loss_of(forward(p, w, model, batch, True, gen),
                           batch.targets)
            grads = torch.autograd.grad(loss, list(w.values()),
                                        allow_unused=True)
            losses.append(float(loss.detach()))
            lr_t = lr * math.sqrt(1 - ADAM_B2 ** step) / (1 - ADAM_B1 ** step)
            clipped = {}
            with torch.no_grad():
                for (name, value), g in zip(w.items(), grads):
                    g = torch.zeros_like(value) if g is None else g
                    g = clip_by_norm(g, clamp)
                    clipped[name] = g
                    mu[name].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                    nu[name].mul_(ADAM_B2).add_(g.square(), alpha=1 - ADAM_B2)
                    value.sub_(lr_t * mu[name] / (nu[name].sqrt() + ADAM_EPS))
            if first is None:
                first = clipped
    return losses, first, {k: v.detach() for k, v in w.items()}


def predict(p: Products, forward: Callable, weights: Dict, model: Dict,
            batch) -> torch.Tensor:
    with p.context(), torch.no_grad():
        return forward(p, weights, model, batch)

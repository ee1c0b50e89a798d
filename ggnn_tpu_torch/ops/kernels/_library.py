"""The `ggnn_tpu_torch` operator namespace: each kernel's entry point as a
`torch.library` op, so that `torch.export` records the kernel call in a
program (ggnn_tpu_torch/export.py) instead of tracing through it.

Every op has three registrations, made when its module is imported (no
kernel is built then):

  * CPU: the kernel's plain PyTorch version;
  * CUDA: the launch of the hand-written kernel, which raises when the
    launch fails;
  * fake (meta): the output's shape and type, for tracing.

A device without a registration (neither CPU nor CUDA) is refused by the
dispatcher. The registrations go through `torch.library.Library.impl`,
which the dispatcher calls straight into the Python function, rather
than through `torch.library.custom_op`, whose wrapper costs more host
time a call on a path that is already bound by the host.
"""

from typing import Callable

import torch

NAMESPACE = "ggnn_tpu_torch"
_LIBRARY = torch.library.Library(NAMESPACE, "FRAGMENT")

# The row dtypes every kernel has an instance of, and the suffix of the
# instance's C entry point (`gather_segment_sum_bf16`, ...).
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def lane_elems(vectorized_path, dtype: torch.dtype) -> int:
    """The values of a row a kernel's lane loads at once, as the register
    queries take it: `vectorized_path` True is the widest load of the
    dtype (f32 4, a float4; bf16 8, 16 bytes), False one, an int that
    count (bf16: 1, 4 or 8)."""
    if isinstance(vectorized_path, bool):
        return (8 if dtype == torch.bfloat16 else 4) if vectorized_path else 1
    return int(vectorized_path)


def register(schema: str, cpu: Callable, cuda: Callable,
             fake: Callable):
    """Define the op `schema` ("name(args) -> Tensor") with its CPU, CUDA
    and fake implementations; returns its default overload."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default

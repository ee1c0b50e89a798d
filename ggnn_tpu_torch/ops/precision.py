"""Matrix products with f32 output from inputs of the compute dtype: the
counterpart of `jnp.einsum(..., preferred_element_type=jnp.float32)` and
`jnp.matmul(..., preferred_element_type=jnp.float32)`, which every
product of the JAX package's message path uses.

`matmul_f32(a, b)` takes a and b of one dtype. In f32 it is
`torch.matmul`. In bf16 (`compute_dtype: bfloat16`) the output is f32,
not rounded to bf16 as `torch.matmul` of two bf16 tensors would round
it:

  * on CUDA, cuBLAS's bf16 product with f32 accumulation and f32 output
    (`torch.mm` / `torch.bmm` with `out_dtype=torch.float32`), on the
    tensor cores;
  * on the CPU, the inputs widened to f32 and an f32 product. A product
    of two bf16 values is exact in f32, so this is the same function,
    its sums in another order.

The product is the op `torch.ops.ggnn_tpu_torch.product_f32`
(`ops/kernels/_library.py`: CPU, CUDA and fake registrations), so that
a program exported on the CPU runs cuBLAS's bf16 product once loaded on
the card, as the live model does.

The gradient (`MatmulF32`) returns each input's gradient in that input's
dtype, from the same bf16-in, f32-out products: the f32 cotangent is
rounded to bf16 first. JAX multiplies the f32 cotangent by the bf16
operand in f32 (its dot_general transpose) and rounds the result; the
two differ by that one rounding, inside the bf16 tolerances of
`tests/test_torch_bf16.py`.
"""

import torch

from ggnn_tpu_torch.ops.kernels import _library


def _mm(x: torch.Tensor):
    return torch.mm if x.dim() == 2 else torch.bmm


def _product_cpu(x, y):
    return _mm(x)(x.float(), y.float())


def _product_cuda(x, y):
    return _mm(x)(x, y, out_dtype=torch.float32)


def _product_fake(x, y):
    return x.new_empty(*x.shape[:-1], y.shape[-1], dtype=torch.float32)


# x @ y in f32 for x, y [M, K] x [K, N] or [B, M, K] x [B, K, N] of one
# low-precision dtype.
_product = _library.register(
    "product_f32(Tensor x, Tensor y) -> Tensor", _product_cpu,
    _product_cuda, _product_fake)


class MatmulF32(torch.autograd.Function):
    """The differentiable bf16-in, f32-out product of `matmul_f32`:
    `apply(a, b)` with a, b 2-D (`mm`) or 3-D (`bmm`) of one dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(g, b.transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _product(a.transpose(-1, -2), g).to(b.dtype)
        return da, db


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 output. a [..., M, K] with b [K, N] (a's leading
    dimensions flattened into M), or a [B, M, K] with b [B, K, N]; a and
    b of one dtype, f32 or bf16."""
    if a.dtype != b.dtype or a.dtype not in _library.DTYPES:
        raise TypeError(f"matmul_f32 takes inputs of one dtype, float32 or "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if b.dim() == 2:
        lead = a.shape[:-1]
        out = MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.view(*lead, b.shape[-1])
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"matmul_f32 takes [..., M, K] x [K, N] or "
                         f"[B, M, K] x [B, K, N]; got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    return MatmulF32.apply(a, b)

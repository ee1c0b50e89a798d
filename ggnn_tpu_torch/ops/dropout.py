"""Dropout with TF1 `tf.nn.dropout` semantics.

TF1 keeps each element with probability `keep_prob` and scales the kept
elements by `1/keep_prob`. The reference applies it to weight matrices
(utils.py:68, chem_tensorflow_sparse.py:91) and to RNN output states
(`DropoutWrapper(state_keep_prob=...)`); the port of
`ggnn_tpu/ops/dropout.py`. Masks come from an explicit
`torch.Generator` on the tensor's device, so they are not the
`jax.random` masks of the JAX package.
"""

import torch


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator) -> torch.Tensor:
    if keep_prob >= 1.0:
        return x
    if keep_prob <= 0.0:
        # tf.nn.dropout raises for keep_prob outside (0, 1]; silently
        # zeroing everything would let a config typo (0.0 for 1.0)
        # train a dead network to completion.
        raise ValueError(f"keep_prob must be in (0, 1], got {keep_prob}")
    if generator is None:
        raise ValueError("dropout requires a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                      device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))

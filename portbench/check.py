"""The numbers that decide `correct`, each a gap between the port and
the plain reference, and their limits.

  * loss_gap: the largest relative gap of a training step's loss, over
    the steps the reference follows;
  * grad_gap: the worst leaf's gap between the norms of the first
    step's clipped gradient as the optimizer got it (the port's worked
    out from Adam's first moment after one step), against the larger of
    the leaf's reference norm and the median leaf's;
  * change_gap: the same for the norm of each leaf's change over the
    steps, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone);
  * answer_gap: the largest gap of an answer, against the larger of its
    reference value and the median's magnitude.

A number passes when it is at most its limit; a number that is not
finite fails.
"""

import math
import statistics
from typing import Dict, List, Optional, Set

import torch

ROUND_OFF_SHARE = 1e-3


def worst(values) -> float:
    """The largest value; infinite where any is not finite (a NaN does
    not order, so max() alone could pass over it)."""
    values = [float(v) for v in values]
    if not values or not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def norm_gap(program: Dict[str, float], reference: Dict[str, float],
             skip: Optional[Set[str]] = None) -> float:
    """max over leaves |program - reference| / max(reference, median)."""
    names = [k for k in reference if not skip or k not in skip]
    median = statistics.median(reference[k] for k in names)
    return worst(abs(program[k] - reference[k])
                 / max(reference[k], median, 1e-30) for k in names)


def round_off_leaves(ref_grads: Dict[str, float]) -> Set[str]:
    """Leaves whose reference gradient norm is under a thousandth of the
    median leaf's."""
    median = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v < ROUND_OFF_SHARE * median}


def training_numbers(prog_losses: List[float], ref_losses: List[float],
                     prog_grads: Dict[str, torch.Tensor],
                     ref_grads: Dict[str, torch.Tensor],
                     prog_change: Dict[str, torch.Tensor],
                     ref_change: Dict[str, torch.Tensor]) -> Dict[str, float]:
    loss_gap = worst(abs(p - r) / max(abs(r), 1e-30)
                     for p, r in zip(prog_losses, ref_losses))
    if len(prog_losses) != len(ref_losses):
        loss_gap = math.inf
    rg = _norms(ref_grads)
    return {
        "loss_gap": loss_gap,
        "grad_gap": norm_gap(_norms(prog_grads), rg),
        "change_gap": norm_gap(_norms(prog_change), _norms(ref_change),
                               skip=round_off_leaves(rg)),
    }


def answer_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    if program.shape != reference.shape:
        return math.inf
    program, reference = program.double(), reference.double()
    scale = torch.clamp(reference.abs(),
                        min=float(reference.abs().median()))
    return worst([((program - reference).abs() / scale).max()])


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)

"""Auxiliary losses and regularizers, in PyTorch.

Port of ripor_tpu/train/regularizers.py (the reference's losses/ package,
kept for the sparse loss_types in its whitelist, arguments.py:82-100):
RegWeightScheduler (losses/regulariaztion.py:27-49), FLOPS/L0/L1/
SparsityRatio (:4-67), RankNet pairwise (losses/pairwise.py:3-45).
"""
from __future__ import annotations

from typing import Optional

import torch


class RegWeightScheduler:
    """Quadratic ramp of a regularizer weight over T steps, then constant
    (reference :27-49: lambda * (step/T)^2 for step <= T)."""

    def __init__(self, lambda_: float, T: int):
        self.lambda_ = lambda_
        self.T = T

    def __call__(self, step) -> float:
        ratio = min(step / self.T, 1.0)
        return self.lambda_ * ratio ** 2

    # torch-style stateful API kept for familiarity
    def step(self, step):
        return self(step)


def flops_reg(reps: torch.Tensor) -> torch.Tensor:
    """FLOPS regularizer: sum_j (mean_i |a_ij|)^2 (reference :4-11)."""
    return (reps.abs().mean(dim=0) ** 2).sum()


def l1_reg(reps: torch.Tensor) -> torch.Tensor:
    """Mean L1 norm (reference :24-31)."""
    return reps.abs().sum(dim=-1).mean()


def l0_stat(reps: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Mean number of (near-)nonzero activations — a *statistic*, not a
    differentiable loss (reference L0 :34-45)."""
    return (reps.abs() > eps).float().sum(dim=-1).mean()


def sparsity_ratio(reps: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Fraction of zero activations (reference :48-67)."""
    return 1.0 - l0_stat(reps, eps) / reps.shape[-1]


def ranknet_loss(pos_scores: torch.Tensor, neg_scores: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RankNet pairwise loss: -log sigma(s+ - s-) (reference pairwise.py:3-45,
    used by the t5seq_aq_encoder_ranknet loss_type)."""
    margin = (pos_scores - neg_scores).float()
    loss = torch.log1p(torch.exp(-margin))
    if weights is not None:
        loss = loss * weights
    return loss.mean()

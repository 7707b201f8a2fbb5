"""Categorical entropy model over VQ token indices (port of
dc_vic_tpu/codec/categorical.py; an alternative the shipped configs do not
use)."""
from __future__ import annotations

import dataclasses

import torch

from .ops import lower_bound


@dataclasses.dataclass(frozen=True)
class VqCategoricalEntropyModel:
    likelihood_bound: float = 1e-9

    def __call__(self, indices: torch.Tensor, pred_logits: torch.Tensor):
        """indices [B, H, W] int tokens; pred_logits [B, n_embed, H, W].
        Returns (indices, per-token likelihood [B, 1, H, W])."""
        p = torch.softmax(pred_logits, dim=1)
        lik = torch.gather(p, 1, indices.long()[:, None])
        if self.likelihood_bound > 0:
            lik = lower_bound(lik, self.likelihood_bound)
        return indices, lik

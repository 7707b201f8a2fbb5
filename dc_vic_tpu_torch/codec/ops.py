"""Small differentiable codec primitives (port of dc_vic_tpu/codec/ops.py):
the straight-through round, the lower bound with its one-sided gradient, and
the source of the training forward's random draws."""
from __future__ import annotations

from typing import Iterable, Optional

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Straight-through round: round(x) forward, identity gradient."""
    return x + (torch.round(x) - x).detach()


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound) with a one-sided gradient: the gradient passes where
    x >= bound or where it would push x upward (compressai's LowerBound), so
    scales below the bound keep learning."""
    return _LowerBound.apply(x, bound)


class Noise:
    """The random draws of the training forward: uniform noise U(-0.5, 0.5)
    for the likelihoods and Gumbel noise for the estimator's sampling. From
    a ``torch.Generator`` on the tensors' device, or, to replay another
    run's draws, from ``draws``: tensors consumed in call order (each must
    have the shape asked for)."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 draws: Optional[Iterable[torch.Tensor]] = None):
        if (generator is None) == (draws is None):
            raise ValueError("Noise takes a generator or a list of draws")
        self.generator = generator
        self._draws = None if draws is None else iter(draws)

    def _replay(self, shape, like: torch.Tensor) -> torch.Tensor:
        try:
            t = next(self._draws)
        except StopIteration:
            raise ValueError("Noise: more draws asked for than were given") from None
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Noise: replayed draw {tuple(t.shape)}, asked for {tuple(shape)}")
        return t.to(device=like.device, dtype=like.dtype)

    def uniform(self, shape, like: torch.Tensor) -> torch.Tensor:
        """U(-0.5, 0.5) of ``shape`` on ``like``'s device and dtype."""
        if self._draws is not None:
            return self._replay(shape, like)
        return torch.rand(shape, generator=self.generator, device=like.device,
                          dtype=like.dtype) - 0.5

    def gumbel(self, shape, like: torch.Tensor) -> torch.Tensor:
        """Standard Gumbel draws of ``shape``: -log(E), E ~ Exp(1)."""
        if self._draws is not None:
            return self._replay(shape, like)
        e = torch.empty(shape, device=like.device, dtype=like.dtype)
        return -torch.log(e.exponential_(generator=self.generator))

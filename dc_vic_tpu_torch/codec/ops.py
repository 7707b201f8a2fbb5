"""Small differentiable codec primitives (port of dc_vic_tpu/codec/ops.py):
the straight-through round, the lower bound with its one-sided gradient, and
the source of the training forward's random draws."""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

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
    have the shape asked for).

    ``shard=(rank, world)``: a data-parallel rank's source. Each draw is
    made (or replayed) at the global batch's shape, ``world`` times the
    local size along ``batch_axis``, and the rank's contiguous slice is
    returned, so the ranks together see the single-process draws."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 draws: Optional[Iterable[torch.Tensor]] = None,
                 shard: Optional[Tuple[int, int]] = None):
        if (generator is None) == (draws is None):
            raise ValueError("Noise takes a generator or a list of draws")
        self.generator = generator
        self._draws = None if draws is None else iter(draws)
        self.rank, self.world = shard or (0, 1)

    def _replay(self, shape, like: torch.Tensor) -> torch.Tensor:
        try:
            t = next(self._draws)
        except StopIteration:
            raise ValueError("Noise: more draws asked for than were given") from None
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Noise: replayed draw {tuple(t.shape)}, asked for {tuple(shape)}")
        return t.to(device=like.device, dtype=like.dtype)

    def _draw(self, shape, like, batch_axis: int, fresh) -> torch.Tensor:
        """``fresh(global shape)`` or the next replayed draw, and this
        rank's slice of it."""
        shape = list(shape)
        local = shape[batch_axis]
        shape[batch_axis] = local * self.world
        t = self._replay(shape, like) if self._draws is not None else fresh(shape)
        return t if self.world == 1 else t.narrow(batch_axis, self.rank * local, local)

    def uniform(self, shape, like: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
        """U(-0.5, 0.5) of ``shape`` on ``like``'s device and dtype; the
        batch runs along ``batch_axis``."""
        return self._draw(shape, like, batch_axis, lambda s: torch.rand(
            s, generator=self.generator, device=like.device, dtype=like.dtype) - 0.5)

    def gumbel(self, shape, like: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
        """Standard Gumbel draws of ``shape``: -log(E), E ~ Exp(1)."""
        def fresh(s):
            e = torch.empty(s, device=like.device, dtype=like.dtype)
            return -torch.log(e.exponential_(generator=self.generator))
        return self._draw(shape, like, batch_axis, fresh)

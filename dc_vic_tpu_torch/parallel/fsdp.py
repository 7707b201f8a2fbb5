"""Fully sharded data parallelism, FSDP (port of ``fsdp_sharding_tree``,
``shard_state`` and the ``state_shardings`` branch of ``data_parallel_step``
in dc_vic_tpu/parallel/mesh.py).

The JAX package hands GSPMD one sharding per leaf of the train state and lets
XLA gather each parameter where it is used and reduce-scatter its gradient.
The port writes the same collectives out once a step, on each rank of a
data-parallel run (one process a rank, ``parallel/mesh.py``):

* **Shard** (``shard_state``, after rank 0's weights are broadcast and any
  checkpoint is loaded): every parameter of the model and of the
  discriminator, trained or frozen, that ``fsdp_plan`` shards is kept as
  this rank's contiguous slice on its shard dimension (a copy); the others
  stay whole on every rank. Buffers stay whole too: the JAX train state
  has none. The optimizers train the rank's slices, and their moments are
  slices (``Optimizer.shard``).
* **Gather** (``gather``) at the start of a step, and before a validation or
  a save, on every rank: each sharded parameter is all-gathered into its
  module's ``nn.Parameter``, so the forward and backward are the
  data-parallel ones.
* **Reduce-scatter** (``mean_grads``): each sharded tensor's gradient is
  summed over the ranks onto the rank's slice and divided by the world;
  the whole tensors' gradients keep ``DataParallel.mean_grads``'s flat
  all-reduce. Every sharded tensor has a collective of its own, in name
  order.
* **Release** (``release``) after the optimizers' step: the gathered
  storage and the gradients are dropped. Between steps a rank holds its
  slices of the sharded parameters and of their moments, and the rest
  whole ("params and both optimizer moments live SHARDED ... 1/n per
  chip").

The collectives run on flat buffers, rank index first (``[world * n]``):
the one form of ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
that gloo takes as well as nccl.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .mesh import DataParallel, fsdp_plan


class ShardedParams:
    """One module's parameters under FSDP: the plan (``fsdp_plan`` over its
    named parameters), this rank's slices and the collectives that join
    and split them."""

    def __init__(self, module: nn.Module, dp: DataParallel, min_size: int):
        self.dp = dp
        self.params: Dict[str, nn.Parameter] = dict(module.named_parameters())
        self.plan = fsdp_plan(self.params, dp.world, min_size)
        self.shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        self.shards = {n: self.local(n, p.detach()) for n, p in self.params.items()
                       if self.plan[n] is not None}

    def sharded(self, name: str) -> bool:
        return self.plan[name] is not None

    def param(self, name: str) -> torch.Tensor:
        """What an optimizer trains for ``name``: the rank's slice, or the
        module's parameter itself where it stays whole."""
        return self.shards[name] if self.sharded(name) else self.params[name]

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``whole`` on the shard dimension (a
        contiguous copy); ``whole`` itself where ``name`` is not sharded."""
        d = self.plan[name]
        if d is None:
            return whole
        k = whole.shape[d] // self.dp.world
        return whole.narrow(d, self.dp.rank * k, k).clone(memory_format=torch.contiguous_format)

    def full(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (a collective that every
        rank calls); ``shard`` itself where ``name`` is not sharded."""
        d = self.plan[name]
        if d is None:
            return shard
        out = shard.new_empty(self.dp.world * shard.numel())
        dist.all_gather_into_tensor(out, shard.contiguous().view(-1))
        return out.view(self.dp.world, *shard.shape).movedim(0, d).reshape(self.shapes[name])

    def scatter_mean(self, name: str, grad: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of ``grad`` (a whole sharded tensor's
        gradient), this rank's slice of it."""
        d, w = self.plan[name], self.dp.world
        chunks = grad.unflatten(d, (w, grad.shape[d] // w)).movedim(d, 0).contiguous()
        out = grad.new_empty(chunks.shape[1:])
        dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1))
        return out.div_(w)

    def sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place."""
        dist.all_reduce(x)
        return x

    @torch.no_grad()
    def gather(self) -> None:
        for n, s in self.shards.items():
            self.params[n].data = self.full(n, s)

    def release(self) -> None:
        for n, p in self.params.items():
            if n in self.shards:
                p.data = p.data.new_empty(0)
            p.grad = None


class FullyShardedState:
    """The FSDP state of one rank's trainer: a ``ShardedParams`` per module,
    and the optimizers switched to the slices."""

    def __init__(self, dp: DataParallel, modules: Sequence[Optional[nn.Module]],
                 optimizers: Sequence, min_size: int):
        self.dp = dp
        self.layouts = [ShardedParams(m, dp, min_size) for m in modules if m is not None]
        for opt in optimizers:
            if opt is not None:
                first = opt.params[0]
                opt.shard(next(lay for lay in self.layouts
                               if any(p is first for p in lay.params.values())))

    def gather(self) -> None:
        """Every sharded parameter whole in its module (every rank calls it)."""
        for lay in self.layouts:
            lay.gather()

    def release(self) -> None:
        """Drop the gathered storage and the gradients."""
        for lay in self.layouts:
            lay.release()

    @torch.no_grad()
    def mean_grads(self, opt) -> List[torch.Tensor]:
        """The gradients ``opt`` steps on, in its order: the mean over the
        ranks, reduce-scattered to the rank's slice where the tensor is
        sharded, all-reduced whole (one flat bucket) where it is not; zeros
        where a tensor has no gradient."""
        lay = opt.layout
        full = [lay.params[n] for n in opt.names]
        out: List[Optional[torch.Tensor]] = [None] * len(full)
        whole = []
        for i, (n, p) in enumerate(zip(opt.names, full)):
            if lay.sharded(n):
                out[i] = lay.scatter_mean(n, p.grad if p.grad is not None else torch.zeros_like(p))
            else:
                whole.append(i)
        if whole:
            for i, g in zip(whole, self.dp.mean_grads([full[i] for i in whole])):
                out[i] = g
        return out


def shard_state(dp: DataParallel, modules: Sequence[Optional[nn.Module]],
                optimizers: Sequence, min_size: int = 1 << 14) -> FullyShardedState:
    """The port of ``shard_state``: this rank's slices of ``modules``'
    parameters by ``fsdp_plan`` over ``dp.world`` ranks, and ``optimizers``
    (each over parameters of one of the modules) training them. Every rank
    calls it with the same weights (after ``DataParallel.replicate``)."""
    return FullyShardedState(dp, modules, optimizers, min_size)

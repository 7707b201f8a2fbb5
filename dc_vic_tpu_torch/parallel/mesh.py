"""Devices and data parallelism (port of dc_vic_tpu/parallel/mesh.py).

The JAX package shards the batch axis over a 1-D device mesh and lets GSPMD
insert the collectives. The port writes them out, for its two users:

* **Training: one process per rank** (``torch.distributed``, ``init_distributed``),
  each on its own device (``cuda:{rank}``, or the CPU). Rank 0's weights are
  broadcast after the seeded initialisation (``DataParallel.replicate``), so
  every rank starts from identical bits. Each rank takes its contiguous
  slice of every global batch (``shard_batch``: what ``P("data")`` does to
  dim 0). Betas and noise are drawn for the global batch from the same
  generator on every rank and sliced. Before each optimizer step the
  gradients of its tensors are averaged over the ranks in one flat bucket
  (``DataParallel.mean_grads``). The step's logged scalars are averaged in
  one collective too (``DataParallel.all_reduce_mean``), and the skip of a
  non-finite step is decided on that average. So every rank steps or skips
  together, and its parameters stay bit-equal to the others'. The step is
  then the single-process step on the global batch up to the order of the
  sums.
  Under FSDP (``fsdp: true``, ``parallel/fsdp.py``) each rank keeps only
  its slices of the tensors ``fsdp_plan`` shards, gathers them for the step
  and reduce-scatters their gradients.
* **Serving: one process, a list of devices** (``make_mesh``). The codec
  keeps one replica of the model per entry (``replicas``) and runs each
  contiguous shard of a batch on its replica (``codec/mesh.py``);
  ``data_parallel_eval`` does the same for any function of a module. An
  entry may repeat a device.

The backend is always the caller's choice (``"nccl"`` when each rank has a
card of its own, ``"gloo"`` for CPU ranks or ranks that share a card). A
failed collective raises; nothing falls back to another backend.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

BACKENDS = ("nccl", "gloo")


def best_mesh_size(batch_size: int, n_devices: Optional[int] = None) -> int:
    """Largest device count that evenly divides the global batch (default:
    the visible cards)."""
    n = n_devices or torch.cuda.device_count()
    while n > 1 and batch_size % n != 0:
        n -= 1
    return max(1, n)


def make_mesh(n_devices: Union[None, int, Sequence] = None,
              device: str = "cuda") -> List[torch.device]:
    """The devices a single-process codec spreads a batch over, one shard
    each: the first ``n_devices`` cards (default: every card), ``n_devices``
    CPU entries with ``device="cpu"``, or the devices named in a sequence
    (a device may appear more than once, e.g. ``["cpu", "cpu"]``)."""
    if n_devices is not None and not isinstance(n_devices, int):
        mesh = [torch.device(d) for d in n_devices]
    elif device == "cpu":
        mesh = [torch.device("cpu")] * (n_devices or 1)
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n < 1 or n > count:
            raise RuntimeError(f"a mesh of {n} cards asked for, {count} visible")
        mesh = [torch.device("cuda", i) for i in range(n)]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def canonical_device(dev) -> torch.device:
    """A mesh entry with its card index (``"cuda"`` is the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def replicas(module: nn.Module, mesh: Sequence[torch.device]) -> List[nn.Module]:
    """One model per mesh entry: ``module`` itself for a first entry on its
    own device, a deep copy moved to the entry's device otherwise."""
    own = next(module.parameters()).device
    return [module if i == 0 and dev == own else copy.deepcopy(module).to(dev)
            for i, dev in enumerate(mesh)]


def _concat(parts: list, dev: torch.device):
    """Per-entry outputs joined on dim 0 on ``dev``: tensors, or dicts,
    lists and tuples of them."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if first.dim() == 0:
            raise ValueError("data_parallel_eval joins outputs on the batch dim; "
                             "a 0-dim output has none")
        return torch.cat([p.to(dev) for p in parts])
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], dev) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat(list(q), dev) for q in zip(*parts))
    raise TypeError(f"data_parallel_eval cannot join outputs of type {type(first).__name__}")


def data_parallel_eval(fn: Callable, mesh: Sequence) -> Callable:
    """``fn(module, batch, *args)`` over the devices of ``mesh`` in one
    process (the port of the JAX ``data_parallel_eval``): the wrapper takes
    the same arguments, runs ``fn`` on one replica of ``module`` per entry
    (``replicas``, made at each call, so the weights are the module's at
    that call) with the entry's contiguous shard of ``batch`` and the other
    arguments whole on the entry's device, and returns the batch-major
    outputs concatenated on the first entry's device. A batch that does not
    divide by the mesh raises, as ``P("data")`` does."""
    devices = [canonical_device(d) for d in mesh]
    if not devices:
        raise ValueError("a mesh needs at least one device")

    def wrapper(module: nn.Module, batch: torch.Tensor, *args):
        n = len(devices)
        if batch.shape[0] % n:
            raise ValueError(f"a batch of {batch.shape[0]} does not divide over {n} devices")
        size = batch.shape[0] // n
        outs = [fn(m, batch[i * size:(i + 1) * size].to(dev),
                   *(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args))
                for i, (m, dev) in enumerate(zip(replicas(module, devices), devices))]
        return _concat(outs, devices[0])
    return wrapper


def fsdp_plan(named_tensors, world: int, min_size: int = 1 << 14) -> Dict[str, Optional[int]]:
    """The port of ``fsdp_sharding_tree``: for each (name, tensor), the
    dimension it is sharded on over ``world`` ranks, or None where it stays
    replicated. A tensor of at least ``min_size`` elements is sharded on its
    largest dimension that divides by ``world`` (the first of equal ones);
    a smaller one, or one with no such dimension, is replicated. The rule
    reads the port's layout (OIHW convolutions), so on a tie the dimension
    may be another than flax's (HWIO); which tensors are sharded is the
    same."""
    items = named_tensors.items() if isinstance(named_tensors, dict) else named_tensors
    plan = {}
    for name, t in items:
        shape = tuple(t.shape)
        best_dim, best = None, 0
        if shape and math.prod(shape) >= min_size:
            for d, s in enumerate(shape):
                if s % world == 0 and s > best:
                    best_dim, best = d, s
        plan[name] = best_dim
    return plan


def shard_rows(n: int, rank: int, world: int, groups: int = 1) -> List[int]:
    """The rows of an n-row global batch that rank ``rank`` of ``world``
    holds: the batch's first ``groups * (n // groups)`` rows cut into
    ``groups`` equal contiguous groups, and this rank's contiguous slice of
    each. ``groups=1`` is ``P("data")`` on dim 0; ``groups=2`` keeps the
    halves of an ``mc_sampling`` batch apart."""
    size = n // groups
    if size % world:
        raise ValueError(f"a group of {size} rows does not divide over {world} ranks")
    part = size // world
    return [g * size + rank * part + i for g in range(groups) for i in range(part)]


def shard_batch(x, rank: int, world: int, groups: int = 1):
    """This rank's rows (``shard_rows``) of a global batch: a tensor or an
    array, indexed on dim 0."""
    rows = shard_rows(x.shape[0], rank, world, groups)
    if groups == 1:
        return x[rows[0]:rows[-1] + 1] if rows else x[:0]
    return x[torch.tensor(rows)] if isinstance(x, torch.Tensor) else x[rows]


def init_distributed(rank: int, world_size: int, backend: str,
                     init_method: str) -> "DataParallel":
    """Join the process group (``init_method``: ``file://...`` or
    ``tcp://localhost:<port>``) with the caller's backend and return this
    rank's ``DataParallel``. A card rank sets its device first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dist.init_process_group(backend=backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return DataParallel(rank=rank, world=world_size)


def teardown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This rank's place in the data-parallel group and its collectives."""
    rank: int
    world: int

    @property
    def shard(self):
        """(rank, world), as ``Noise`` and ``BetaPolicy.sample`` take it."""
        return self.rank, self.world

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        dist.barrier()

    @torch.no_grad()
    def replicate(self, module: Optional[nn.Module]) -> None:
        """Broadcast rank 0's parameters and buffers, in name order."""
        if module is None:
            return
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)

    def all_reduce_mean(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The mean over ranks of each scalar, in one collective."""
        names = list(values)
        flat = torch.stack([values[k].detach().float().reshape(()) for k in names])
        dist.all_reduce(flat)
        flat /= self.world
        return dict(zip(names, flat.unbind()))

    @torch.no_grad()
    def mean_grads(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over ranks of each tensor's gradient (zeros where it has
        none), summed in one flat bucket. The mean is written back into the
        ``.grad`` that exist, and returned for every tensor, in order."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= self.world
        out = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        for p, g in zip(params, out):
            if p.grad is not None:
                p.grad.copy_(g)
        return out

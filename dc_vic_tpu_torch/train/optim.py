"""Optimizers, learning-rate schedules and parameter partitioning (port of
dc_vic_tpu/train/optim.py).

The optimizers keep optax's semantics, which the JAX package trains with,
rather than ``torch.optim``'s defaults:

* the chain is clip_by_global_norm -> Adam (or AdamW, SGD) -> the schedule's
  step size -> paramwise multipliers, and the update is added to the
  parameter;
* clipping scales by max_norm / norm only where norm >= max_norm (no 1e-6
  in the divisor, as ``clip_grad_norm_`` has);
* the schedule reads its own step counter (``sched_count``), which
  ``reset_schedule_counts`` zeroes while Adam's own counter and moments stay;
* an optimizer holds only the parameters its mask trains, so a frozen leaf
  is never written; ``step(ok=...)`` keeps parameters, moments and counters
  exactly as they were where ``ok`` is false, without a host sync;
* under FSDP (``shard``) it trains a rank's slices of the sharded tensors,
  with moments to match, and clips by the norm of the whole tensors.

Partitioning implements the reference's freezing rules on the port's
parameter names: the aux optimizer sees only the entropy bottleneck's
quantiles; the frozen VQGAN prior (``vq_model.*``, its decoder included)
never trains; the GAN stages train only ``decoder``, ``vq_estimator`` and
``fusion_module``.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from ..utils.registry import SCHEDULER_REGISTRY

# --------------------------------------------------------------------------
# Schedules: count (an int tensor on the device) -> learning rate (f32 tensor)
# --------------------------------------------------------------------------


@SCHEDULER_REGISTRY.register("MultiStepLR")
def multi_step_lr(base_lr: float, milestones, gamma: float = 0.1, **kw):
    """base_lr times gamma for every milestone the count has reached."""
    def sched(count):
        v = torch.full((), base_lr, dtype=torch.float32, device=count.device)
        for m in sorted(int(m) for m in milestones):
            v = torch.where(count < m, v, v * gamma)
        return v
    return sched


@SCHEDULER_REGISTRY.register("LinearWarmupScheduler")
def linear_warmup(base_lr: float, warmup_iters: int, warmup_factor: float = 0.1, **kw):
    """base_lr * (warmup_factor + (1 - warmup_factor) * min(count / warmup_iters, 1))."""
    def sched(count):
        frac = torch.clamp(count.float() / max(1, warmup_iters), 0.0, 1.0)
        return base_lr * (warmup_factor + (1.0 - warmup_factor) * frac)
    return sched


@SCHEDULER_REGISTRY.register("LinearWarmupMultiStepLR")
def linear_warmup_multistep(base_lr: float, warmup_iters: int, milestones,
                            gamma: float = 0.1, warmup_factor: float = 0.1, **kw):
    ms = multi_step_lr(base_lr, milestones, gamma)
    wu = linear_warmup(1.0, warmup_iters, warmup_factor)
    return lambda count: ms(count) * wu(count)


def build_schedule(base_lr: float, sched_cfg: Optional[Dict]) -> Callable:
    if not sched_cfg:
        return lambda count: torch.full((), base_lr, dtype=torch.float32, device=count.device)
    cfg = dict(sched_cfg)
    return SCHEDULER_REGISTRY.get(cfg.pop("type"))(base_lr, **cfg)


# --------------------------------------------------------------------------
# Optimizer
# --------------------------------------------------------------------------

def paramwise_scale(name: str, rules: Optional[Dict[str, float]]) -> float:
    """The product of the multipliers whose key is a substring of the
    parameter's name (the reference's ``paramwise_opt``; names here are the
    port's dotted ones)."""
    scale = 1.0
    for key, mult in (rules or {}).items():
        if key in name:
            scale *= mult
    return scale


class Optimizer:
    """One optax-style optimizer over the named parameters it trains."""

    def __init__(self, params: Dict[str, nn.Parameter], kind: str, schedule: Callable,
                 clip_max_norm: Optional[float] = None,
                 paramwise: Optional[Dict[str, float]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 1e-4,
                 momentum: float = 0.0):
        if not params:
            raise ValueError("an optimizer needs at least one parameter")
        self.names = list(params)
        self.params = [params[n] for n in self.names]
        self.kind = kind
        self.schedule = schedule
        self.clip_max_norm = clip_max_norm
        self.mults = [paramwise_scale(n, paramwise) for n in self.names]
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay, self.momentum = weight_decay, momentum
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)        # Adam's
        self.sched_count = torch.zeros((), dtype=torch.int32, device=dev)  # the schedule's
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.contiguous_format)
                         for p in self.params]
        self.mu = zeros() if kind in ("Adam", "AdamW") or momentum else None
        self.nu = zeros() if kind in ("Adam", "AdamW") else None
        self.layout = None        # a parallel.fsdp.ShardedParams under FSDP
        self._sharded = None

    @torch.no_grad()
    def shard(self, layout) -> None:
        """Train this rank's slices from here on (FSDP, ``parallel/fsdp.py``):
        ``params``, ``mu`` and ``nu`` hold, for each tensor ``layout``
        shards, the rank's slice, and the whole tensor for the others. The
        clip norm is the whole tensors' (the slices' squares summed over the
        ranks, the whole tensors' counted once); ``state_dict`` gathers the
        moments whole (every rank calls it) and ``load_state_dict`` slices
        them."""
        self.layout = layout
        self.params = [layout.param(n) for n in self.names]
        for key in ("mu", "nu"):
            if getattr(self, key) is not None:
                setattr(self, key, [layout.local(n, t) for n, t in zip(self.names,
                                                                         getattr(self, key))])
        self._sharded = [layout.sharded(n) for n in self.names]

    def _global_norm(self, gs) -> torch.Tensor:
        """The norm over every tensor of ``gs``, as optax's
        ``clip_by_global_norm`` takes it."""
        if self.layout is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))

        def squares(ts):
            return torch.stack(torch._foreach_norm(ts)).square().sum()
        sharded = [g for g, s in zip(gs, self._sharded) if s]
        whole = [g for g, s in zip(gs, self._sharded) if not s]
        total = torch.zeros((), dtype=gs[0].dtype, device=gs[0].device)
        if sharded:
            total = self.layout.sum_over_ranks(squares(sharded))
        if whole:
            total = total + squares(whole)
        return torch.sqrt(total)

    def lr(self) -> torch.Tensor:
        """The learning rate the next step takes."""
        return self.schedule(self.sched_count)

    @torch.no_grad()
    def step(self, grads: Optional[Iterable[torch.Tensor]] = None,
             ok: Optional[torch.Tensor] = None) -> None:
        """Apply one update from ``grads`` (in ``names`` order; default: the
        parameters' ``.grad``, a missing one read as zeros). Where ``ok``
        (a bool tensor) is false, nothing changes."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        gs = [g.to(p.dtype) for g, p in zip(grads, self.params)]
        if self.clip_max_norm:
            norm = self._global_norm(gs)
            clipped = torch._foreach_mul(torch._foreach_div(gs, norm), self.clip_max_norm)
            trigger = norm < self.clip_max_norm
            gs = [torch.where(trigger, g, c) for g, c in zip(gs, clipped)]

        new_count = self.count + 1
        new_mu = new_nu = None
        if self.kind in ("Adam", "AdamW"):
            new_mu = torch._foreach_add(torch._foreach_mul(gs, 1 - self.b1),
                                        torch._foreach_mul(self.mu, self.b1))
            new_nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - self.b2),
                torch._foreach_mul(self.nu, self.b2))
            c = new_count.float()
            bc1 = 1 - torch.pow(torch.tensor(self.b1, device=c.device), c)
            bc2 = 1 - torch.pow(torch.tensor(self.b2, device=c.device), c)
            denom = torch._foreach_sqrt(torch._foreach_add(torch._foreach_div(new_nu, bc2),
                                                           self.eps_root))
            upd = torch._foreach_div(torch._foreach_div(new_mu, bc1),
                                     torch._foreach_add(denom, self.eps))
            if self.kind == "AdamW":
                upd = torch._foreach_add(upd, torch._foreach_mul(self.params,
                                                                 self.weight_decay))
        elif self.kind == "SGD":
            upd = gs
            if self.momentum:
                new_mu = torch._foreach_add(gs, torch._foreach_mul(self.mu, self.momentum))
                upd = new_mu
        else:
            raise KeyError(f"unknown optimizer {self.kind}")
        upd = torch._foreach_mul(upd, -self.lr())
        if any(m != 1.0 for m in self.mults):
            upd = torch._foreach_mul(upd, self.mults)
        new_p = torch._foreach_add(self.params, upd)

        def put(olds, news):
            for old, new in zip(olds, news):
                old.copy_(new if ok is None else torch.where(ok, new, old))
        put(self.params, new_p)
        if new_mu is not None:
            put(self.mu, new_mu)
        if new_nu is not None:
            put(self.nu, new_nu)
        put([self.count, self.sched_count], [new_count, self.sched_count + 1])

    def state_dict(self) -> Dict:
        """The counters and the moments by name, whole."""
        out = {"count": self.count.clone(), "sched_count": self.sched_count.clone()}
        for key in ("mu", "nu"):
            if getattr(self, key) is not None:
                out[key] = {n: self._whole(n, t) for n, t in zip(self.names, getattr(self, key))}
        return out

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A copy of the whole tensor of which ``t`` is this rank's part."""
        if self.layout is not None and self.layout.sharded(name):
            return self.layout.full(name, t)
        return t.clone()

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Load a state saved by ``state_dict``. It may cover more parameters
        than this optimizer trains (an RD stage's state booting a GAN stage);
        every parameter trained here must be in it."""
        self.count.copy_(state["count"])
        self.sched_count.copy_(state["sched_count"])
        for key in ("mu", "nu"):
            own = getattr(self, key)
            if own is None:
                continue
            saved = state[key]
            missing = [n for n in self.names if n not in saved]
            if missing:
                raise KeyError(f"optimizer state {key}: {len(missing)} trained parameters "
                               f"missing, e.g. {missing[0]}")
            for n, t in zip(self.names, own):
                t.copy_(saved[n] if self.layout is None else self.layout.local(n, saved[n]))


def build_optimizer(params: Dict[str, nn.Parameter], opt_cfg: Dict,
                    sched_cfg: Optional[Dict] = None,
                    clip_max_norm: Optional[float] = None) -> Optimizer:
    """The optimizer of a config subtree (``type``: Adam, AdamW or SGD;
    ``lr``; ``paramwise_opt``; Adam's b1, b2, eps, eps_root) over
    ``params``."""
    cfg = dict(opt_cfg)
    kind = cfg.pop("type", "Adam")
    lr = cfg.pop("lr", 1e-4)
    paramwise = cfg.pop("paramwise_opt", None)
    if kind not in ("Adam", "AdamW", "SGD"):
        raise KeyError(f"unknown optimizer {kind}")
    return Optimizer(params, kind, build_schedule(lr, sched_cfg), clip_max_norm,
                     paramwise, **cfg)


def reset_schedule_counts(state: Dict) -> Dict:
    """An optimizer state with the schedule's counter at 0 and Adam's moments
    and own counter kept (the reference's ``load_scheduler: False``)."""
    out = dict(state)
    out["sched_count"] = torch.zeros_like(state["sched_count"])
    return out


# --------------------------------------------------------------------------
# Partitioning, on the port's parameter names
# --------------------------------------------------------------------------

def is_aux_path(name: str) -> bool:
    return name.split(".")[-1] == "quantiles"


def is_frozen_prior_path(name: str) -> bool:
    """The frozen VQGAN prior: the whole ``vq_model`` (its decoder is the
    fused decoder's frozen part; the trainable taps are ``fusion_module``)."""
    return name.split(".")[0] == "vq_model"


GAN_TRAINABLE_ROOTS = ("decoder", "vq_estimator", "fusion_module")


def is_gan_trainable_path(name: str) -> bool:
    """The GAN stages train the decoder, the VQ estimator and the fusion
    blocks only."""
    return name.split(".")[0] in GAN_TRAINABLE_ROOTS


def main_mask(names: Iterable[str], gan_stage: bool = False) -> Dict[str, bool]:
    """Which parameters the main (g) optimizer trains."""
    def pred(n):
        if is_aux_path(n) or is_frozen_prior_path(n):
            return False
        return is_gan_trainable_path(n) if gan_stage else True
    return {n: pred(n) for n in names}


def aux_mask(names: Iterable[str]) -> Dict[str, bool]:
    return {n: is_aux_path(n) for n in names}


def masked_params(module: nn.Module, mask: Dict[str, bool]) -> Dict[str, nn.Parameter]:
    """The parameters of ``module`` that ``mask`` trains, by name."""
    return {n: p for n, p in module.named_parameters() if mask[n]}

"""The training steps of the curriculum (port of dc_vic_tpu/train/steps.py):

  stage 1_1          rate-distortion + VQ-code losses, no betas   -> rd_step
  stage 1_2          the same with per-sample dual-beta weights   -> rd_step
  stage 1_3, stage 3 GAN fine-tune of the decoder, the VQ estimator and the
                     fusion blocks, the entropy path frozen       -> gan_step
  OASIS stage        the same against a per-pixel token-class
                     discriminator                                -> gan_step(oasis=True)

Each step does the main (g) update, the aux (quantile) update where the
stage has one, and the reference's skip of a step whose loss is not finite
or too large (|loss| >= 1e4): the skip is a ``torch.where`` on the device
inside the optimizers, so a step never waits for the host. The step counter
advances either way. Under a ``torch.profiler`` session a step marks its
generator's forward, its backward and the update as the program spans
``train.forward``, ``train.backward`` and ``train.update``; the GAN step
marks its discriminator's half (the forwards on the reals and the fakes,
their loss and its backward) as ``train.d_step``.

The loss assemblies (``rd_losses``, ``gan_g_losses``, ``gan_d_loss``) take
explicit betas and a ``Noise``, so a caller can replay another run's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..codec.ops import Noise
from ..parallel.fsdp import FullyShardedState
from ..parallel.mesh import DataParallel
from ..utils.profiling import span
from .optim import Optimizer


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates: the model, its optimizers, the
    discriminator's (GAN stages), the step count, the generator of the
    betas and the noise (on the model's device) and, under FSDP, the rank's
    sharded state (``parallel/fsdp.py``), gathered at the step's start and
    released at its end."""
    model: nn.Module
    g_opt: Optimizer
    generator: torch.Generator
    aux_opt: Optional[Optimizer] = None
    disc: Optional[nn.Module] = None
    d_opt: Optional[Optimizer] = None
    step: int = 0
    fsdp: Optional[FullyShardedState] = None


@dataclasses.dataclass(frozen=True)
class BetaPolicy:
    """How betas are sampled and how they weight the losses."""
    use_beta: bool = True
    use_selected_pairs: bool = False
    selected_beta_rate: Tuple[float, ...] = ()
    selected_beta_vq: Tuple[float, ...] = ()
    max_beta_rate: float = 3.0
    max_beta_vq: float = 3.5
    num_levels: int = 100
    sample_batch_beta: bool = False
    weight_type: str = "exp"     # 'exp' -> e^beta, 'linear' -> beta + offset
    weight_offset: float = 1.0

    def sample(self, generator: torch.Generator, batch_size: int,
               shard: Optional[Tuple[int, int]] = None):
        """(beta_rate, beta_vq), each [batch_size] or [1] f32 on the
        generator's device: one of the selected pairs, or each beta on a
        grid of num_levels + 1 levels up to its maximum. ``shard=(rank,
        world)``: per-sample betas are drawn for the global batch of
        ``world * batch_size`` and the rank's slice is returned."""
        if not self.use_beta:
            return None, None
        rank, world = shard or (0, 1)
        if not self.sample_batch_beta:
            return self._draw(generator, 1)
        b1, b2 = self._draw(generator, batch_size * world)
        return (b1[rank * batch_size:(rank + 1) * batch_size],
                b2[rank * batch_size:(rank + 1) * batch_size])

    def _draw(self, generator: torch.Generator, n: int):
        dev = generator.device
        if self.use_selected_pairs:
            i = torch.randint(0, len(self.selected_beta_rate), (n,), generator=generator,
                              device=dev)
            table_r = torch.tensor(self.selected_beta_rate, dtype=torch.float32, device=dev)
            table_v = torch.tensor(self.selected_beta_vq, dtype=torch.float32, device=dev)
            return table_r[i], table_v[i]
        i1 = torch.randint(0, self.num_levels + 1, (n,), generator=generator, device=dev)
        i2 = torch.randint(0, self.num_levels + 1, (n,), generator=generator, device=dev)
        return (self.max_beta_rate * i1.float() / self.num_levels,
                self.max_beta_vq * i2.float() / self.num_levels)

    def weight(self, beta):
        if self.weight_type == "exp":
            return torch.exp(beta)
        return beta + self.weight_offset


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x) & (torch.abs(x) < 10000.0)


def _apply_sample_weight(loss_val: torch.Tensor, weight) -> torch.Tensor:
    """Per-sample weighting: the mean over each sample's other dims, times
    its (broadcastable) weight, then the mean; a scalar loss takes the mean
    weight."""
    if loss_val.dim() == 0:
        return torch.mean(weight) * loss_val
    per_sample = loss_val.reshape(loss_val.shape[0], -1).mean(dim=1)
    return torch.mean(per_sample * weight)


def _g_losses(losses: Dict, out: Dict, batch, beta_rate, beta_vq, policy: BetaPolicy,
              include_rate: bool = True, lpips_fn=None) -> Tuple[torch.Tensor, Dict]:
    """The generator-side loss terms and their sum. With dual-beta
    conditioning the rate term is weighted by w(beta_rate) and the VQ-code
    terms by w(beta_vq), per sample when the betas are."""
    terms: Dict[str, torch.Tensor] = {}
    if include_rate and "rate_loss" in losses:
        if policy.use_beta:
            terms["rate"] = _apply_sample_weight(
                losses["rate_loss"].loss_weight * out["bpp_per_sample"],
                policy.weight(beta_rate))
        else:
            terms["rate"] = losses["rate_loss"](out["bpp"])
    if "distortion_loss" in losses:
        terms["distortion"] = losses["distortion_loss"](batch, out["fake_images"])
    if "perceptual_loss" in losses:
        terms["perceptual"] = losses["perceptual_loss"](batch, out["fake_images"],
                                                        lpips_fn=lpips_fn)
    code_w = policy.weight(beta_vq) if policy.use_beta else None
    if "code_distortion_loss" in losses:
        per_elem = losses["code_distortion_loss"].loss_weight * (
            out["gt_vq_latent"] - out["out_vq_latent"]) ** 2
        terms["code_distortion"] = (_apply_sample_weight(per_elem, code_w)
                                    if code_w is not None else torch.mean(per_elem))
    if "code_ce_loss" in losses:
        ce = losses["code_ce_loss"]
        logp = F.log_softmax(out["out_vq_logits"], dim=1)
        logpt = torch.gather(logp, 1, out["gt_vq_indices"].long()[:, None])[:, 0]
        nll = -logpt
        gamma = getattr(ce, "gamma", None)
        if gamma is not None:
            nll = ((1.0 - torch.exp(logpt)) ** gamma) * nll
        per_elem = ce.loss_weight * nll
        terms["code_ce"] = (_apply_sample_weight(per_elem, code_w)
                            if code_w is not None else torch.mean(per_elem))
    return sum(terms.values()), terms


def rd_losses(model, losses: Dict, batch, beta_rate, beta_vq, policy: BetaPolicy,
              noise: Noise, lpips_fn=None):
    """The RD step's forward: (total, terms, model outputs)."""
    out = model(batch, beta_rate, beta_vq, is_train=True, noise=noise)
    total, terms = _g_losses(losses, out, batch, beta_rate, beta_vq, policy,
                             include_rate=True, lpips_fn=lpips_fn)
    return total, terms, out


def _disc(disc, img, beta_rate, beta_vq, y_hat=None):
    return disc(img, beta_rate, beta_vq, y_hat)


def _adv(gan_loss, d_out, target, is_real: bool, is_disc: bool) -> torch.Tensor:
    """The adversarial term: the OASIS loss keyed on a token map where
    ``target`` is one, else the loss of the logits alone."""
    if target is not None:
        return gan_loss(d_out, target, is_disc=is_disc, is_real=is_real)
    return gan_loss(d_out, is_real=is_real, is_disc=is_disc)


def gan_g_losses(model, disc, losses: Dict, batch, beta_rate, beta_vq,
                 policy: BetaPolicy, noise: Noise, lpips_fn=None, oasis: bool = False):
    """The GAN step's generator forward (entropy path frozen) and its loss
    with the adversarial term: (total, terms, model outputs). ``oasis``
    keys that term on the batch's token map (``OasisGANLoss``)."""
    out = model(batch, beta_rate, beta_vq, is_train=True, noise=noise,
                fix_entropy_models=True)
    total, terms = _g_losses(losses, out, batch, beta_rate, beta_vq, policy,
                             include_rate=False, lpips_fn=lpips_fn)
    d_out = _disc(disc, out["fake_images"], beta_rate, beta_vq, out["quantized_code"]["y"])
    terms["adv"] = _adv(losses["gan_loss"], d_out, out["gt_vq_indices"] if oasis else None,
                        is_real=True, is_disc=False)
    return total + terms["adv"], terms, out


def gan_d_loss(disc, gan_loss, real, fake, beta_rate, beta_vq, real_y_hat=None,
               fake_y_hat=None, real_tokens=None, fake_tokens=None) -> torch.Tensor:
    """The discriminator's loss on reals and (detached) fakes; the OASIS
    loss keys them on ``real_tokens`` and ``fake_tokens``."""
    l_real = _adv(gan_loss, _disc(disc, real, beta_rate, beta_vq, real_y_hat), real_tokens,
                  is_real=True, is_disc=True)
    l_fake = _adv(gan_loss, _disc(disc, fake.detach(), beta_rate, beta_vq, fake_y_hat),
                  fake_tokens, is_real=False, is_disc=True)
    return 0.5 * (l_real + l_fake)


def _zero_grads(*modules):
    for m in modules:
        for p in m.parameters():
            p.grad = None


def _noise(generator: torch.Generator, dp: Optional[DataParallel]) -> Noise:
    return Noise(generator) if dp is None else Noise(generator, shard=dp.shard)


def _update(opts, terms: Dict[str, torch.Tensor], totals, dp: Optional[DataParallel],
            fsdp: Optional[FullyShardedState] = None):
    """The end of a step: with ``dp``, the logged terms averaged over the
    ranks in one collective and each optimizer's gradients averaged before
    its step (under ``fsdp`` reduce-scattered to the rank's slices where a
    tensor is sharded, and the gathered parameters released after the
    steps); the step is skipped unless every total (read from ``terms``
    after that average, so every rank decides alike) is finite. Returns the
    terms with ``skipped``."""
    with span("train.update"):
        terms = {k: v.detach() for k, v in terms.items()}
        if dp is not None:
            terms = dp.all_reduce_mean(terms)
        ok = _finite(terms[totals[0]])
        for name in totals[1:]:
            ok = ok & _finite(terms[name])
        for opt in opts:
            if fsdp is not None:
                grads = fsdp.mean_grads(opt)
            else:
                grads = None if dp is None else dp.mean_grads(opt.params)
            opt.step(grads, ok=ok)
        if fsdp is not None:
            fsdp.release()
        terms["skipped"] = (~ok).float()
    return terms


def rd_step(state: TrainState, batch: torch.Tensor, losses: Dict, policy: BetaPolicy,
            lpips_fn=None, dp: Optional[DataParallel] = None) -> Dict[str, torch.Tensor]:
    """One RD step (stages 1_1 and 1_2) on a batch NCHW in [-1, 1]: main and aux
    updates in one backward (the aux loss reaches only the quantiles, which
    the main loss never does). Returns the terms as device scalars. ``dp``:
    this rank's share of a data-parallel step, ``batch`` its slice of the
    global batch (``parallel/mesh.py``)."""
    model = state.model
    shard = None if dp is None else dp.shard
    beta_rate, beta_vq = policy.sample(state.generator, batch.shape[0], shard)
    if state.fsdp is not None:
        state.fsdp.gather()
    _zero_grads(model)
    with span("train.forward"):
        total, terms, out = rd_losses(model, losses, batch, beta_rate, beta_vq, policy,
                                      _noise(state.generator, dp), lpips_fn)
        aux = model.aux_loss()
    with span("train.backward"):
        (total + aux).backward()
    terms.update(bpp=out["bpp"], qbpp=out["qbpp"], vq_accuracy=out["vq_accuracy"],
                 total=total, aux=aux)
    terms = _update((state.g_opt, state.aux_opt), terms, ("total",), dp, state.fsdp)
    state.step += 1
    return terms


def gan_step(state: TrainState, batch: torch.Tensor, losses: Dict, policy: BetaPolicy,
             mc_sampling: bool = False, y_hat_cond: bool = False,
             lpips_fn=None, oasis: bool = False,
             dp: Optional[DataParallel] = None) -> Dict[str, torch.Tensor]:
    """One GAN step (stages 1_3 and 3): the generator's update against the
    discriminator as it is, then the discriminator's on the reals and the
    generator's (detached) fakes; both are skipped unless both losses are
    finite. ``mc_sampling`` trains D on the batch's second half as reals
    and G on its first; ``y_hat_cond`` gives D the y_hat of each;
    ``oasis`` keys the adversarial terms on VQ token maps: the fakes on the
    generator batch's, the reals on the same map, or with ``mc_sampling``
    on their own. ``dp`` as in ``rd_step``; with ``mc_sampling`` the rank's
    batch holds its slice of each half of the global batch, in that order
    (``shard_rows(..., groups=2)``)."""
    model, disc = state.model, state.disc
    gan_loss = losses["gan_loss"]
    if mc_sampling:
        half = batch.shape[0] // 2
        g_batch, d_real_batch = batch[:half], batch[half:half * 2]
    else:
        g_batch = d_real_batch = batch
    beta_rate, beta_vq = policy.sample(state.generator, g_batch.shape[0],
                                       None if dp is None else dp.shard)
    if state.fsdp is not None:
        state.fsdp.gather()
    _zero_grads(model, disc)
    disc.requires_grad_(False)
    try:
        with span("train.forward"):
            g_total, terms, out = gan_g_losses(model, disc, losses, g_batch, beta_rate,
                                               beta_vq, policy, _noise(state.generator, dp),
                                               lpips_fn, oasis)
        with span("train.backward"):
            g_total.backward()
    finally:
        disc.requires_grad_(True)
    with span("train.d_step"):
        # the encoder branch and the VQGAN are frozen in the GAN stages, so
        # the reals' y_hat and token map are the same before and after the
        # generator's update
        real_y_hat = (model.extract_y_hat(d_real_batch, beta_rate, beta_vq) if y_hat_cond
                      else None)
        fake_y_hat = out["quantized_code"]["y"].detach() if y_hat_cond else None
        fake_tokens = real_tokens = out["gt_vq_indices"] if oasis else None
        if oasis and mc_sampling:
            with torch.no_grad():
                real_tokens = model.vq_encode(d_real_batch)[1]
        d_total = gan_d_loss(disc, gan_loss, d_real_batch, out["fake_images"], beta_rate,
                             beta_vq, real_y_hat, fake_y_hat, real_tokens=real_tokens,
                             fake_tokens=fake_tokens)
        d_total.backward()
    terms.update(bpp=out["bpp"], vq_accuracy=out["vq_accuracy"], total=g_total,
                 d_loss=d_total)
    terms = _update((state.g_opt, state.d_opt), terms, ("total", "d_loss"), dp, state.fsdp)
    state.step += 1
    return terms

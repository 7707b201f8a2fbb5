"""Plain PyTorch reference of the GAN step of DC-VIC's stages 1_3 and 3
(iwa-shi/DC_VIC ``config/exp1_stage1_3.yaml``,
DualBetaCondGanDistortionVqCodeTrainer with
DualBetaCondTamingNLayerDiscriminator).

``PatchDisc``: both betas Fourier-encoded (L frequencies, x included),
through an MLP 2(2L + 1) -> cond_ch -> cond_ch with a ReLU between,
broadcast over H x W and concatenated to the image; then the PatchGAN trunk
without norms: 4x4 stride-2 convs ndf, 2 ndf, 4 ndf (n_layers of them), a
4x4 stride-1 conv to 8 ndf and a 4x4 stride-1 conv to one logit a patch,
LeakyReLU(0.2) after every conv but the last, every conv with a bias.

``GANStep.step``: the generator's forward with the encoder branch and the
entropy models under ``no_grad`` (their noise still drawn, in the RD step's
order); the loss MSE (images in [0, 1]) and LPIPS(alex), the VQ code's MSE
and plain cross entropy each weighted per sample by exp(beta_vq), and the
weighted BCE of the discriminator's logits on the fakes as reals, the
discriminator frozen (``requires_grad_(False)``) meanwhile; no rate term.
One backward into the trained leaves (``decoder``, ``vq_estimator``,
``fusion_module``). Then the discriminator's unweighted
1/2 (BCE(reals, 1) + BCE(detached fakes, 0)) and its backward. Both Adams
step only where both totals are finite and under 1e4.

Departures from the published description: the discriminator's Adam is
clipped at ``clip_max_norm`` like the generator's (the stage's trainer
builds both optimizers with the one setting); the discriminator's tensors
come in from the caller as a state dict under ``PatchDisc``'s own names
(``mlp.0``, ``mlp.2``, ``convs.0`` to ``convs.4``) rather than from a
checkpoint; the betas are always drawn per sample from the level grid
(``sample_batch_beta`` on, no selected pairs), as the stage 1_3
configuration has them. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dcvic
from .train import Adam, AlexLPIPS

GAN_ROOTS = ("decoder", "vq_estimator", "fusion_module")


class PatchDisc(nn.Module):
    """The dual-beta conditioned PatchGAN of the configuration's
    ``discriminator`` entry (``norm_type: none`` only)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg.get("norm_type", "none") != "none" or cfg.get("use_pi", False) \
                or not cfg.get("include_x", True):
            raise ValueError("the reference holds the published discriminator only")
        self.L, ndf, n = cfg["L"], cfg["ndf"], cfg["n_layers"]
        self.max_b = (cfg["max_beta_1"], cfg["max_beta_2"])
        c = cfg["cond_ch"]
        self.mlp = nn.Sequential(nn.Linear(2 * (2 * self.L + 1), c), nn.ReLU(), nn.Linear(c, c))
        widths = [3 + c] + [ndf * min(2 ** i, 8) for i in range(n + 1)] + [1]
        strides = [2] * n + [1, 1]
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 4, s, 1)
                                   for a, b, s in zip(widths[:-1], widths[1:], strides))

    def forward(self, x, b1, b2):
        B, _, H, W = x.shape
        e = torch.cat([dcvic.fourier(b1, self.L, self.max_b[0]),
                       dcvic.fourier(b2, self.L, self.max_b[1])], dim=-1)
        cond = self.mlp(e)[:, :, None, None].expand(B, -1, H, W)
        h = torch.cat([x, cond], dim=1)
        for conv in self.convs[:-1]:
            h = F.leaky_relu(conv(h), 0.2)
        return self.convs[-1](h)


def bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


class GANStep:
    """The model, the discriminator, their Adams and LPIPS on ``device``;
    ``step`` runs one GAN step of the configuration ``opt`` (the
    configuration file's ``model_config``). ``detach_fakes``, ``d_update``
    and ``token_noise`` exist for the calibration's planted faults: the
    last adds normal noise of that standard deviation to the estimator's
    logits before the argmax that the VQGAN decoder reads (the losses keep
    the logits as they are)."""

    def __init__(self, opt: dict, weights: Dict[str, torch.Tensor],
                 lpips_sd: Dict[str, torch.Tensor], disc_sd: Dict[str, torch.Tensor],
                 device, detach_fakes: bool = True, d_update: bool = True,
                 token_noise: float = 0.0):
        self.device = torch.device(device)
        with torch.device(self.device):
            self.model = dcvic.DCVIC(opt)
            self.disc = PatchDisc(opt["discriminator"])
        if self.device.type != "meta":
            self.model.load_state_dict(weights)
            self.disc.load_state_dict(disc_sd)
        self.g_names = [n for n, _ in self.model.named_parameters()
                        if n.split(".")[0] in GAN_ROOTS]
        p = dict(self.model.named_parameters())
        for n, t in p.items():
            t.requires_grad_(n in self.g_names)
        o = opt["optim"]
        clip = o.get("clip_max_norm")
        self.g_opt = Adam([p[n] for n in self.g_names], o["g_optimizer"]["lr"], clip)
        self.d_opt = Adam(list(self.disc.parameters()), o["d_optimizer"]["lr"], clip)
        with torch.device(self.device):
            self.lpips = AlexLPIPS(lpips_sd)
        enc = opt["subnet"]["encoder"]
        self.max_b = (enc["max_beta_1"], enc["max_beta_2"])
        self.levels = opt["model"].get("num_beta_levels", 100)
        self.loss = opt["loss"]
        self.detach_fakes, self.d_update = detach_fakes, d_update
        self.token_noise = token_noise

    def g_forward(self, x, b1, b2, noise: Callable, tokens: Optional[torch.Tensor] = None,
                  codes: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
        """The generator's loss terms (``total`` their sum), ``fake``, the
        estimator's ``logits``, the token map the VQGAN decoder read
        (``read``) and the frozen branch's own VQ token map and y_hat
        (``gt``, ``y_hat``). With ``codes`` = (VQ token map, y_hat) the rest
        of the step reads those instead of the frozen branch's own (which
        carries no gradient), and with ``tokens`` the VQGAN decoder reads
        that map instead of the estimator's argmax."""
        m, B = self.model, x.shape[0]
        with torch.no_grad():
            lat, idx = m.vq_encode(x)
            y = m.comp_encode(x, lat, idx, b1, b2)
            z = m.hyperencoder(y).float()
            noise((z.shape[1], 1, z.numel() // z.shape[1]))   # the bottleneck's draw
            med = m.entropy_model_z.medians().reshape(1, -1, 1, 1)
            z_hat = torch.round(z - med) + med
            hyper_out = m.hyperdecoder(z_hat)
            cm, prev = m.context_model, []
            for i, ys in enumerate(y.chunk(cm.slices, dim=1)):
                mu, _, ms = cm.mu_sigma(i, hyper_out, prev)
                noise(ys.shape)                               # the slice's draw
                prev.append(cm.lrp(i, ms, torch.round(ys - mu) + mu))
            own = {"gt": idx, "y_hat": torch.cat(prev, 1)}
            if codes is not None:
                idx = codes[0]
                lat = m.vq_model.quantize.lookup(idx)
        y_hat = own["y_hat"] if codes is None else codes[1]
        if tokens is None and self.token_noise:
            with torch.no_grad():
                _, lg = m.vq_estimator(m.decoder.get_feats(y_hat, b1, b2)[0])
                gen = torch.Generator(device=lg.device).manual_seed(0)
                tokens = torch.argmax(lg + self.token_noise * torch.randn(
                    lg.shape, generator=gen, device=lg.device), dim=1)
        fake, pred, logits, read = m.decode_from_y_hat(y_hat, b1, b2, tokens)
        L, wv = self.loss, torch.exp(b2)
        per_sample = lambda t: torch.mean(t.reshape(B, -1).mean(dim=1) * wv)
        nll = -torch.gather(F.log_softmax(logits, dim=1), 1, idx.long()[:, None])[:, 0]
        terms = {
            "distortion": L["distortion_loss"]["loss_weight"]
            * torch.mean(((x + 1) / 2 - (fake + 1) / 2) ** 2),
            "perceptual": L["perceptual_loss"]["loss_weight"] * torch.mean(self.lpips(x, fake)),
            "code_distortion": per_sample(L["code_distortion_loss"]["loss_weight"]
                                          * (lat - pred) ** 2),
            "code_ce": per_sample(L["code_ce_loss"]["loss_weight"] * nll),
        }
        self.disc.requires_grad_(False)
        try:
            terms["adv"] = L["gan_loss"]["loss_weight"] * bce(self.disc(fake, b1, b2), 1.0)
        finally:
            self.disc.requires_grad_(True)
        terms["total"] = sum(terms.values())
        terms.update(fake=fake, logits=logits, read=read, **own)
        return terms

    def d_forward(self, x, fake, b1, b2) -> torch.Tensor:
        """The discriminator's loss on the reals and the fakes."""
        fake = fake.detach() if self.detach_fakes else fake
        return 0.5 * (bce(self.disc(x, b1, b2), 1.0) + bce(self.disc(fake, b1, b2), 0.0))

    def step(self, x: torch.Tensor, draw_seed: int, tokens: Optional[torch.Tensor] = None,
             codes: Optional[tuple] = None) -> Dict:
        """One step on the batch ``x`` (NCHW in [-1, 1]), reading ``tokens``
        and ``codes`` where given (``g_forward``). Returns the loss terms
        (floats), ``d_loss``, ``ok``, the gradients as the optimizers took
        them (``names`` order), the token map the step chose (``tokens``:
        the map its decoder read where none was given, else the estimator's
        own argmax) and the lead of the estimator's best logit over the
        next (``margin``), and the frozen branch's own ``gt`` and
        ``y_hat``."""
        gen = torch.Generator(device=self.device).manual_seed(draw_seed)
        B = x.shape[0]
        i1 = torch.randint(0, self.levels + 1, (B,), generator=gen, device=self.device)
        i2 = torch.randint(0, self.levels + 1, (B,), generator=gen, device=self.device)
        b1 = self.max_b[0] * i1.float() / self.levels
        b2 = self.max_b[1] * i2.float() / self.levels
        noise = lambda shape: torch.rand(shape, generator=gen, device=self.device) - 0.5
        for t in self.g_opt.params + self.d_opt.params:
            t.grad = None
        terms = self.g_forward(x, b1, b2, noise, tokens, codes)
        own = {k: terms.pop(k) for k in ("gt", "y_hat")}
        logits = terms.pop("logits").detach()
        read = terms.pop("read")
        chose = read if tokens is None else torch.argmax(logits, dim=1)
        top2 = torch.topk(logits, 2, dim=1).values
        # attached fakes take the discriminator's loss back through the
        # generator, whose graph is then kept for it
        terms["total"].backward(retain_graph=not self.detach_fakes)
        d_loss = self.d_forward(x, terms.pop("fake"), b1, b2)
        d_loss.backward()
        fin = lambda t: bool(torch.isfinite(t)) and abs(float(t)) < 1e4
        ok = fin(terms["total"].detach()) and fin(d_loss.detach())
        grads = self.g_opt.step(ok) + self.d_opt.step(ok and self.d_update)
        out = {k: float(v.detach()) for k, v in terms.items()}
        out.update(d_loss=float(d_loss.detach()), ok=ok, grads=grads,
                   tokens=chose, margin=top2[:, 0] - top2[:, 1], **own)
        return out

"""Plain PyTorch reference of a dual-beta rate-distortion training step of
DC-VIC (iwa-shi/DC_VIC ``config/exp1_stage1_2.yaml``,
DualBetaCondRateDistortionVqCodeTrainer): the training forward with
additive uniform noise on the likelihoods and straight-through rounding,
the loss (beta-weighted rate, MSE, LPIPS(alex), beta-weighted VQ-code MSE
and focal cross entropy), one backward, clipping of the generator's
gradients by their global norm, Adam on the generator and Adam on the
bottleneck's quantiles (the aux loss), and the skip of a step whose loss is
not finite or too large.

The step's draws (per-sample betas, noise) come from a ``torch.Generator``
seeded with the same number as the program's, taken in the program's
order: two integer draws of the beta levels, the bottleneck's noise, then
each ChARM slice's. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import dcvic

LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class AlexLPIPS(nn.Module):
    """LPIPS(alex): torchvision AlexNet's five ReLU taps, unit-normalised
    along channels, weighted by |lin_i|, averaged over the plane, summed."""

    CONVS = ((0, 3, 64, 11, 4, 2), (3, 64, 192, 5, 1, 2), (6, 192, 384, 3, 1, 1),
             (8, 384, 256, 3, 1, 1), (10, 256, 256, 3, 1, 1))

    def __init__(self, sd: Dict[str, torch.Tensor]):
        super().__init__()
        self.convs = nn.ModuleList()
        for i, cin, cout, k, s, p in self.CONVS:
            c = nn.Conv2d(cin, cout, k, stride=s, padding=p)
            c.weight.data.copy_(sd[f"net.features.{i}.weight"])
            c.bias.data.copy_(sd[f"net.features.{i}.bias"])
            self.convs.append(c)
        self.lins = [sd[f"lin{i}.model.1.weight"].reshape(1, -1, 1, 1).abs() for i in range(5)]
        self.requires_grad_(False)

    def taps(self, x):
        out = []
        for j, c in enumerate(self.convs):
            x = F.relu(c(x))
            out.append(x)
            if j < 2:
                x = F.max_pool2d(x, 3, 2)
        return out

    def forward(self, a, b):
        norm = lambda x: (x - torch.tensor(LPIPS_SHIFT, device=x.device).view(1, 3, 1, 1)) \
            / torch.tensor(LPIPS_SCALE, device=x.device).view(1, 3, 1, 1)
        total = 0.0
        for i, (fa, fb) in enumerate(zip(self.taps(norm(a)), self.taps(norm(b)))):
            na = fa * torch.rsqrt(torch.sum(fa ** 2, 1, keepdim=True) + 1e-10)
            nb = fb * torch.rsqrt(torch.sum(fb ** 2, 1, keepdim=True) + 1e-10)
            w = self.lins[i].to(a.device)
            total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=1), dim=(1, 2))
        return total


class Adam:
    """optax's Adam on a list of tensors: the moments, bias correction,
    lr * m_hat / (sqrt(v_hat) + eps); with ``clip`` the gradients are first
    scaled by clip / norm where their global norm reaches ``clip``."""

    def __init__(self, params: List[torch.Tensor], lr: float, clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.clip = params, lr, clip
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, ok: bool) -> List[torch.Tensor]:
        """Update where ``ok``; returns the gradients as the update took
        them (clipped)."""
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
            if norm >= self.clip:
                gs = [g / norm * self.clip for g in gs]
        if not ok:
            return gs
        self.t += 1
        for p, g, m, v in zip(self.params, gs, self.m, self.v):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            mh, vh = m / (1 - self.b1 ** self.t), v / (1 - self.b2 ** self.t)
            p.add_(-self.lr * mh / (torch.sqrt(vh) + self.eps))
        return gs


class RDStep:
    """The model, its two optimizers and LPIPS, on ``device``; ``step``
    runs one training step of the configuration ``opt`` (the
    configuration file's ``model_config``)."""

    def __init__(self, opt: dict, weights: Dict[str, torch.Tensor],
                 lpips_sd: Dict[str, torch.Tensor], device):
        with torch.device(device):
            model = dcvic.DCVIC(opt)
        model.load_state_dict(weights)
        self.model = model
        self.device = torch.device(device)
        names = [n for n, _ in model.named_parameters()]
        self.aux_names = [n for n in names if n.split(".")[-1] == "quantiles"]
        self.main_names = [n for n in names if n not in self.aux_names
                           and n.split(".")[0] != "vq_model"]
        p = dict(model.named_parameters())
        for n, t in p.items():
            t.requires_grad_(n in self.main_names or n in self.aux_names)
        o = opt["optim"]
        self.g_opt = Adam([p[n] for n in self.main_names], o["g_optimizer"]["lr"],
                          o.get("clip_max_norm"))
        self.aux_opt = Adam([p[n] for n in self.aux_names], o["aux_optimizer"]["lr"])
        self.lpips = AlexLPIPS(lpips_sd).to(device)
        enc = opt["subnet"]["encoder"]
        self.max_b = (enc["max_beta_1"], enc["max_beta_2"])
        self.levels = opt["model"].get("num_beta_levels", 100)
        self.loss = opt["loss"]

    def names(self) -> List[str]:
        return self.main_names + self.aux_names

    def params(self) -> List[torch.Tensor]:
        return self.g_opt.params + self.aux_opt.params

    def step(self, x: torch.Tensor, draw_seed: int) -> Dict:
        """One step on the batch ``x`` (NCHW in [-1, 1]). Returns the loss
        terms (floats), ``ok``, and the gradients as the optimizers took
        them (names order)."""
        m = self.model
        gen = torch.Generator(device=self.device).manual_seed(draw_seed)
        B, _, H, W = x.shape
        i1 = torch.randint(0, self.levels + 1, (B,), generator=gen, device=self.device)
        i2 = torch.randint(0, self.levels + 1, (B,), generator=gen, device=self.device)
        b1 = self.max_b[0] * i1.float() / self.levels
        b2 = self.max_b[1] * i2.float() / self.levels
        noise = lambda shape: torch.rand(shape, generator=gen, device=self.device) - 0.5
        for t in self.params():
            t.grad = None
        with torch.no_grad():
            lat, idx = m.vq_encode(x)
        y = m.comp_encode(x, lat, idx, b1, b2)
        z = m.hyperencoder(y).float()
        eb = m.entropy_model_z
        C = z.shape[1]
        v = z.transpose(0, 1).reshape(C, 1, -1)
        lik_z = eb.likelihood_v(v + noise(v.shape)).reshape(C, B, *z.shape[2:]).transpose(0, 1)
        med = eb.medians().detach().reshape(1, C, 1, 1)
        z_hat = dcvic.ste_round(z - med) + med
        hyper_out = m.hyperdecoder(z_hat)
        cm, prev, liks = m.context_model, [], []
        for i, ys in enumerate(y.chunk(cm.slices, dim=1)):
            mu, sigma, ms = cm.mu_sigma(i, hyper_out, prev)
            liks.append(dcvic.gaussian_likelihood(ys + noise(ys.shape), sigma, mu))
            prev.append(cm.lrp(i, ms, dcvic.ste_round(ys - mu) + mu))
        fake, pred, logits, _ = m.decode_from_y_hat(torch.cat(prev, 1), b1, b2)
        bits = lambda lik: -torch.sum(torch.log(lik), dim=(1, 2, 3)) / math.log(2.0) / (H * W)
        bpp = bits(torch.cat(liks, 1)) + bits(lik_z)
        L = self.loss
        per_sample = lambda t, w: torch.mean(t.reshape(B, -1).mean(dim=1) * w)
        terms = {
            "rate": torch.mean(L["rate_loss"]["loss_weight"] * bpp * torch.exp(b1)),
            "distortion": L["distortion_loss"]["loss_weight"]
            * torch.mean(((x + 1) / 2 - (fake + 1) / 2) ** 2),
            "perceptual": L["perceptual_loss"]["loss_weight"] * torch.mean(self.lpips(x, fake)),
            "code_distortion": per_sample(L["code_distortion_loss"]["loss_weight"]
                                          * (lat - pred) ** 2, torch.exp(b2)),
        }
        logp = F.log_softmax(logits, dim=1)
        logpt = torch.gather(logp, 1, idx.long()[:, None])[:, 0]
        focal = (1.0 - torch.exp(logpt)) ** L["code_ce_loss"].get("gamma", 2.0) * (-logpt)
        terms["code_ce"] = per_sample(L["code_ce_loss"]["loss_weight"] * focal, torch.exp(b2))
        total = sum(terms.values())
        (total + eb.aux_loss()).backward()
        t = total.detach()
        ok = bool(torch.isfinite(t)) and abs(float(t)) < 1e4
        grads = self.g_opt.step(ok) + self.aux_opt.step(ok)
        out = {k: float(v) for k, v in terms.items()}
        out.update(total=float(total), ok=ok, grads=grads)
        return out

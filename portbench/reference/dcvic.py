"""Plain PyTorch reference of the HyperpriorCharmDualCondVic model (DC-VIC,
iwa-shi/DC_VIC ``config/_base_/model/hyperprior_charm_dual_cond_vic_model_vq_f8_n256.yaml``):
the frozen f8-n256 VQGAN prior, the ELIC analysis and synthesis transforms
with dual-beta FiLM, the Minnen'20 hyperprior, the ChARM context model, the
Swin VQ estimator and the SFT fusion blocks.

It is the benchmark's yardstick and imports nothing of the program: plain
``torch`` operations only, float32, no custom kernels, no cache and no
batching tricks. The parameter names are the published torch keys, so one
state dict made by the benchmark feeds the program and this reference alike.

Numerics. ``set_numerics(model, quant)`` chooses how the conv and dense
layers of the stacks that a deployment runs in bfloat16 (VQGAN, ELIC
transforms, hyperencoder, VQ estimator, fusion) take their products:
``None`` in float32, ``"fp8"`` with both operands rounded to float8 e4m3
under one scale per tensor (the control a step below bfloat16). The
entropy-parameter chain (hyperdecoder, context model) is float32 whatever
that is; ``entropy_tf32`` lets its convolutions multiply in TF32, as the
configuration's ``entropy_precision: default`` states, inside
``entropy_convs``. Departures from the published description: none in the
mathematics; attention is computed image by image to bound memory.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale (448 / max |t|), in f32."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _q(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    t = t.float()
    return fp8_round(t) if quant == "fp8" else t


class SConv(nn.Conv2d):
    """A conv of the bf16-deployed stacks (products per ``quant``)."""
    quant: Optional[str] = None

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.conv2d(_q(x, self.quant), _q(self.weight, self.quant), b, self.stride,
                        self.padding)


class SDeconv(nn.ConvTranspose2d):
    quant: Optional[str] = None

    def forward(self, x):
        return F.conv_transpose2d(_q(x, self.quant), _q(self.weight, self.quant),
                                  self.bias.float(), self.stride, self.padding,
                                  self.output_padding)


class SLinear(nn.Linear):
    quant: Optional[str] = None

    def forward(self, x):
        return F.linear(_q(x, self.quant), _q(self.weight, self.quant), self.bias.float())


class PointwiseLinear(SLinear):
    """A dense layer over the channels of an NCHW map (weight [out, in])."""

    def forward(self, x):
        return F.conv2d(_q(x, self.quant), _q(self.weight, self.quant)[:, :, None, None],
                        self.bias.float())


def conv(cin, cout, k=3, stride=1):
    return SConv(cin, cout, k, stride=stride, padding=(k - 1) // 2)


def econv(cin, cout, k=3):
    """An entropy-parameter conv: float32 always."""
    return nn.Conv2d(cin, cout, k, padding=(k - 1) // 2)


def deconv(cin, cout, k=5, cls=SDeconv):
    return cls(cin, cout, k, stride=2, padding=(k - 1) // 2, output_padding=1)


def num_groups32(c: int) -> int:
    return 32 if c % 32 == 0 else math.gcd(32, c)


class GroupNorm(nn.Module):
    """GroupNorm (two-pass variance), optionally followed by swish."""

    def __init__(self, groups: int, ch: int, eps: float = 1e-6, act: Optional[str] = None):
        super().__init__()
        self.groups, self.eps, self.act = groups, eps, act
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias, self.eps)
        return y * torch.sigmoid(y) if self.act == "swish" else y


# ------------------------------------------------------------------ ELIC
class BottleneckResBlock(nn.Module):
    def __init__(self, ch, mid):
        super().__init__()
        self.conv = nn.Sequential(conv(ch, mid, 1), nn.ReLU(), conv(mid, mid, 3), nn.ReLU(),
                                  conv(mid, ch, 1))

    def forward(self, x):
        return x + self.conv(x)


class ResidualBottleneckBlocks(nn.Module):
    def __init__(self, ch, mid, n=3):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"block{i}", BottleneckResBlock(ch, mid))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"block{i}")(x)
        return x


class NLAMResBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.c1, self.c2, self.c3 = conv(ch, ch // 2, 1), conv(ch // 2, ch // 2, 3), \
            conv(ch // 2, ch, 1)

    def forward(self, x):
        return x + self.c3(F.relu(self.c2(F.relu(self.c1(x)))))


class ChengNLAM(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.trunk_block = nn.ModuleList(NLAMResBlock(ch) for _ in range(3))
        self.attention_block = nn.ModuleList(NLAMResBlock(ch) for _ in range(3))
        self.conv = conv(ch, ch, 1)

    def forward(self, x):
        t, a = x, x
        for blk in self.trunk_block:
            t = blk(t)
        for blk in self.attention_block:
            a = blk(a)
        return x + t * torch.sigmoid(self.conv(a))


def fourier(beta, L, max_beta):
    nb = (beta.float().reshape(-1) / max_beta - 0.5) * 2.0
    ang = nb[:, None] * (2.0 ** torch.arange(L, dtype=torch.float32, device=beta.device))
    return torch.cat([nb[:, None], torch.sin(ang), torch.cos(ang)], dim=-1)


class BetaScaleShift(nn.Module):
    """FiLM: feat * (1 + scale(cond)) + shift(cond)."""

    def __init__(self, feat_ch, cond_ch):
        super().__init__()
        self.shared = nn.Sequential(SLinear(cond_ch, cond_ch), nn.ReLU())
        self.scale = SLinear(cond_ch, feat_ch)
        self.shift = SLinear(cond_ch, feat_ch)

    def forward(self, feat, cond):
        h = self.shared(cond)
        return feat * (1.0 + self.scale(h)[:, :, None, None]) + self.shift(h)[:, :, None, None]


class _Film(nn.Module):
    def _init_film(self, cond_ch, L, max_b1, max_b2):
        self.L, self.max_b1, self.max_b2 = L, max_b1, max_b2
        n_in = 2 * (2 * L + 1)
        self.mlp = nn.Sequential(SLinear(n_in, cond_ch), nn.ReLU(), SLinear(cond_ch, cond_ch))

    def cond(self, b1, b2):
        return self.mlp(torch.cat([fourier(b1, self.L, self.max_b1),
                                   fourier(b2, self.L, self.max_b2)], dim=-1))


class Encoder(_Film):
    """ElicDualBetaFtVqScEncoder: FiLM after each of the nine ELIC layers,
    the VQ feature concat-projected at /8."""

    def __init__(self, in_ch, feat_ch, out_ch, main_ch, mid_ch, cond_ch, L, max_b1, max_b2,
                 nb=3):
        super().__init__()
        self._init_film(cond_ch, L, max_b1, max_b2)
        self.conv1 = conv(in_ch, main_ch, 5, 2)
        self.block1 = ResidualBottleneckBlocks(main_ch, mid_ch, nb)
        self.conv2 = conv(main_ch, main_ch, 5, 2)
        self.block2 = ResidualBottleneckBlocks(main_ch, mid_ch, nb)
        self.attn2 = ChengNLAM(main_ch)
        self.conv3 = conv(main_ch, main_ch, 5, 2)
        self.projection = conv(feat_ch + main_ch, main_ch, 3)
        self.block3 = ResidualBottleneckBlocks(main_ch, mid_ch, nb)
        self.conv4 = conv(main_ch, out_ch, 5, 2)
        self.attn4 = ChengNLAM(out_ch)
        self.beta_ft_list = nn.ModuleList(
            BetaScaleShift(out_ch if i >= 7 else main_ch, cond_ch) for i in range(9))

    def forward(self, x, feat, b1, b2):
        c = self.cond(b1, b2)
        ft = lambda i, h: self.beta_ft_list[i](h, c)
        x = ft(0, self.conv1(x))
        x = ft(1, self.block1(x))
        x = ft(2, self.conv2(x))
        x = ft(3, self.block2(x))
        x = ft(4, self.attn2(x))
        x = ft(5, self.conv3(x))
        x = x + self.projection(torch.cat([feat, x], dim=1))
        x = ft(6, self.block3(x))
        x = ft(7, self.conv4(x))
        return ft(8, self.attn4(x))


class Decoder(_Film):
    """ElicDualBetaFtFeatFusionDecoder up to block3: the transformer
    feature at block1, fusion taps at block1, block2, block3."""

    NAMES = ("attn1", "conv1", "block1", "conv2", "attn2", "block2", "conv3", "block3")

    def __init__(self, in_ch, main_ch, mid_ch, cond_ch, L, max_b1, max_b2, taps: Dict, nb=3):
        super().__init__()
        self._init_film(cond_ch, L, max_b1, max_b2)
        self.taps = dict(taps)
        self.init_fuse = BetaScaleShift(in_ch, cond_ch)
        self.beta_ft_list = nn.ModuleList(
            BetaScaleShift(in_ch if i < 2 else main_ch, cond_ch) for i in range(len(self.NAMES)))
        make = {"attn1": lambda: ChengNLAM(in_ch), "conv1": lambda: deconv(in_ch, main_ch),
                "block1": lambda: ResidualBottleneckBlocks(main_ch, mid_ch, nb),
                "conv2": lambda: deconv(main_ch, main_ch), "attn2": lambda: ChengNLAM(main_ch),
                "block2": lambda: ResidualBottleneckBlocks(main_ch, mid_ch, nb),
                "conv3": lambda: deconv(main_ch, main_ch),
                "block3": lambda: ResidualBottleneckBlocks(main_ch, mid_ch, nb)}
        for n in self.NAMES:
            self.add_module(n, make[n]())

    def get_feats(self, x, b1, b2):
        c = self.cond(b1, b2)
        x = self.init_fuse(x, c) + x
        feat, fused = None, {}
        for i, n in enumerate(self.NAMES):
            x = getattr(self, n)(self.beta_ft_list[i](x, c))
            if n == "block1":
                feat = x
            if n in self.taps:
                fused[self.taps[n]] = x
        return feat, fused


class HyperEncoder(nn.Module):
    def __init__(self, y_ch, z_ch):
        super().__init__()
        self.conv1, self.conv2, self.conv3 = conv(y_ch, 320, 3), conv(320, 256, 5, 2), \
            conv(256, z_ch, 5, 2)

    def forward(self, y):
        return self.conv3(F.relu(self.conv2(F.relu(self.conv1(y)))))


class _HDBlock(nn.Module):
    def __init__(self, z_ch, out_ch):
        super().__init__()
        self.conv1 = deconv(z_ch, 192, cls=nn.ConvTranspose2d)
        self.conv2 = deconv(192, 256, cls=nn.ConvTranspose2d)
        self.conv3 = econv(256, out_ch, 3)

    def forward(self, z):
        return self.conv3(F.relu(self.conv2(F.relu(self.conv1(z)))))


class HyperDecoder(nn.Module):
    def __init__(self, z_ch, hyper_out):
        super().__init__()
        self.hd_mu, self.hd_std = _HDBlock(z_ch, hyper_out // 2), _HDBlock(z_ch, hyper_out // 2)

    def forward(self, z):
        return torch.cat([self.hd_mu(z), self.hd_std(z)], dim=1)


class SliceTransform(nn.Module):
    def __init__(self, cin, cout, mid=(224, 128)):
        super().__init__()
        self.model = nn.Sequential(econv(cin, mid[0], 5), nn.ReLU(), econv(mid[0], mid[1], 5),
                                   nn.ReLU(), econv(mid[1], cout, 3))

    def forward(self, x):
        return self.model(x)


# ------------------------------------------------------------- entropy
SCALE_BOUND = 0.11
SCALE_TABLE = np.exp(np.linspace(math.log(0.11), math.log(256.0), 64))
SYM_CLIP = 32000


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, torch.zeros_like(g)), None


def lower_bound(x, bound):
    return _LowerBound.apply(x, bound)


def ste_round(x):
    return x + (torch.round(x) - x).detach()


def gaussian_likelihood(y, scales, means):
    scales = lower_bound(scales, SCALE_BOUND)
    v = torch.abs(y - means)
    cdf = lambda t: 0.5 * torch.erfc(-t * (2 ** -0.5))
    return lower_bound(cdf((0.5 - v) / scales) - cdf((-0.5 - v) / scales), 1e-9)


def scale_indexes(sigma):
    """CDF row of each scale: the count of table scales below it."""
    bounds = torch.as_tensor(np.asarray(SCALE_TABLE[:-1], np.float32), device=sigma.device)
    return torch.bucketize(torch.clamp(sigma, min=SCALE_BOUND).contiguous(), bounds,
                           right=False)


class ContextModel(nn.Module):
    """ChARM over six slices of y, at most four earlier slices as support."""

    def __init__(self, y_ch=192, hyper_out=256, slices=6, support=4, mid=(224, 128)):
        super().__init__()
        self.slices, self.support, self.sc = slices, support, y_ch // slices
        hm, sc = hyper_out // 2, self.sc
        n = lambda i: min(i, support)
        self.mean_slice_transforms = nn.ModuleList(
            SliceTransform(hm + sc * n(i), sc, mid) for i in range(slices))
        self.scale_slice_transforms = nn.ModuleList(
            SliceTransform(hm + sc * n(i), sc, mid) for i in range(slices))
        self.lrp_slice_transforms = nn.ModuleList(
            SliceTransform(hm + sc * n(i) + sc, sc, mid) for i in range(slices))

    def mu_sigma(self, i, hyper_out, prev: List[torch.Tensor]):
        hm, hs = hyper_out.chunk(2, dim=1)
        sup = prev[:self.support]
        mean_support = torch.cat([hm] + sup, dim=1)
        mu = self.mean_slice_transforms[i](mean_support)
        sigma = self.scale_slice_transforms[i](torch.cat([hs] + sup, dim=1))
        return mu, sigma, mean_support

    def lrp(self, i, mean_support, y_hat_slice):
        t = self.lrp_slice_transforms[i](torch.cat([mean_support, y_hat_slice], dim=1))
        return y_hat_slice + 0.5 * torch.tanh(t)


class EntropyBottleneck(nn.Module):
    def __init__(self, ch, filters=(3, 3, 3, 3)):
        super().__init__()
        sizes = (1,) + tuple(filters) + (1,)
        self.K, self.ch = len(filters) + 1, ch
        for i in range(self.K):
            self.register_parameter(f"_matrix{i}",
                                    nn.Parameter(torch.empty(ch, sizes[i + 1], sizes[i])))
            self.register_parameter(f"_bias{i}", nn.Parameter(torch.empty(ch, sizes[i + 1], 1)))
            if i < self.K - 1:
                self.register_parameter(f"_factor{i}",
                                        nn.Parameter(torch.empty(ch, sizes[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(ch, 1, 3))

    def medians(self):
        return self.quantiles[:, 0, 1]

    def logits(self, v, detach=False):
        sg = (lambda t: t.detach()) if detach else (lambda t: t)
        for i in range(self.K):
            v = torch.matmul(F.softplus(sg(getattr(self, f"_matrix{i}"))), v) \
                + sg(getattr(self, f"_bias{i}"))
            if i < self.K - 1:
                v = v + torch.tanh(sg(getattr(self, f"_factor{i}"))) * torch.tanh(v)
        return v

    def likelihood_v(self, v):
        lo, up = self.logits(v - 0.5), self.logits(v + 0.5)
        s = -torch.sign(lo + up)
        return lower_bound(torch.abs(torch.sigmoid(s * up) - torch.sigmoid(s * lo)), 1e-9)

    def symbols(self, z):
        med = self.medians().reshape(1, -1, 1, 1)
        return torch.clamp(torch.round(z - med), -SYM_CLIP, SYM_CLIP).to(torch.int32)

    def dequantize(self, sym):
        return sym.to(torch.float32) + self.medians().reshape(1, -1, 1, 1)

    def aux_loss(self):
        t = math.log(2.0 / 1e-9 - 1.0)
        target = torch.tensor([-t, 0.0, t], device=self.quantiles.device).reshape(1, 1, 3)
        return torch.sum(torch.abs(self.logits(self.quantiles, detach=True) - target))


# ---------------------------------------------------------------- VQGAN
class VQResnetBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(num_groups32(cin), cin, act="swish")
        self.conv1 = conv(cin, cout, 3)
        self.norm2 = GroupNorm(num_groups32(cout), cout, act="swish")
        self.conv2 = conv(cout, cout, 3)
        self.nin_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (self.nin_shortcut(x) if self.nin_shortcut is not None else x) + h


def attention_f32(q, k, v):
    """softmax(q k^T) v over [B, N, C] in f32, one image at a time."""
    return torch.cat([torch.softmax(q[b:b + 1] @ k[b:b + 1].transpose(1, 2), dim=-1)
                      @ v[b:b + 1] for b in range(q.shape[0])], dim=0)


class VQAttnBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(num_groups32(ch), ch)
        self.q, self.k, self.v, self.proj_out = (conv(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        tok = lambda t: t.float().reshape(B, C, H * W).transpose(1, 2)
        out = attention_f32(tok(self.q(h) * C ** -0.5), tok(self.k(h)), tok(self.v(h)))
        return x + self.proj_out(out.transpose(1, 2).reshape(B, C, H, W))


class _Conv(nn.Module):
    def __init__(self, ch, pad_first: bool):
        super().__init__()
        self.pad_first = pad_first
        self.conv = SConv(ch, ch, 3, stride=2, padding=0) if pad_first else conv(ch, ch, 3)

    def forward(self, x):
        if self.pad_first:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block, self.attn = nn.ModuleList(), nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = VQResnetBlock(ch, ch), VQAttnBlock(ch), \
            VQResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VQEncoder(nn.Module):
    def __init__(self, ch, mult, nres, attn_res, res, zc):
        super().__init__()
        self.conv_in = conv(3, ch, 3)
        self.down = nn.ModuleList()
        cur, bin_ = res, ch
        for i, m in enumerate(mult):
            lv = _Level()
            for _ in range(nres):
                lv.block.append(VQResnetBlock(bin_, ch * m))
                bin_ = ch * m
                if cur in attn_res:
                    lv.attn.append(VQAttnBlock(bin_))
            if i != len(mult) - 1:
                lv.downsample = _Conv(bin_, True)
                cur //= 2
            self.down.append(lv)
        self.mid = _Mid(bin_)
        self.norm_out = GroupNorm(num_groups32(bin_), bin_, act="swish")
        self.conv_out = conv(bin_, zc, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for lv in self.down:
            for i, blk in enumerate(lv.block):
                h = blk(h)
                if len(lv.attn):
                    h = lv.attn[i](h)
            if hasattr(lv, "downsample"):
                h = lv.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class VQDecoder(nn.Module):
    def __init__(self, ch, mult, nres, attn_res, res, zc):
        super().__init__()
        n = len(mult)
        bin_ = ch * mult[-1]
        cur = res // 2 ** (n - 1)
        self.conv_in = conv(zc, bin_, 3)
        self.mid = _Mid(bin_)
        levels = [None] * n
        for i in reversed(range(n)):
            lv = _Level()
            for _ in range(nres + 1):
                lv.block.append(VQResnetBlock(bin_, ch * mult[i]))
                bin_ = ch * mult[i]
                if cur in attn_res:
                    lv.attn.append(VQAttnBlock(bin_))
            if i != 0:
                lv.upsample = _Conv(bin_, False)
                cur *= 2
            levels[i] = lv
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(num_groups32(bin_), bin_, act="swish")
        self.conv_out = conv(bin_, 3, 3)

    def forward(self, z, fusion, cond):
        fuse = lambda key, h: fusion[key](h, cond[key]) if key in fusion else h
        h = fuse("before_mid", self.conv_in(z))
        h = fuse("after_mid", self.mid(h))
        for i in reversed(range(len(self.up))):
            lv = self.up[i]
            for j, blk in enumerate(lv.block):
                h = blk(h)
                if len(lv.attn):
                    h = lv.attn[j](h)
            h = fuse(f"block_1_{2 ** i}", h)
            if hasattr(lv, "upsample"):
                h = lv.upsample(h)
        return self.conv_out(self.norm_out(h))


class Quantizer(nn.Module):
    def __init__(self, n, d):
        super().__init__()
        self.embedding = nn.Embedding(n, d)

    def lookup(self, idx):
        return self.embedding(idx.long()).permute(0, 3, 1, 2)

    def indices(self, z):
        """Nearest codeword of each latent position, [B, H, W]."""
        B, D, H, W = z.shape
        zf = z.float().permute(0, 2, 3, 1).reshape(-1, D)
        cb = self.embedding.weight.float()
        dist = (cb * cb).sum(-1)[None] - 2.0 * (zf @ cb.t())
        return torch.argmin(dist, dim=-1).reshape(B, H, W)


class VQModel(nn.Module):
    def __init__(self, n_embed, embed_dim, dd):
        super().__init__()
        a = (dd["ch"], tuple(dd["ch_mult"]), dd["num_res_blocks"], tuple(dd["attn_resolutions"]),
             dd["resolution"], dd["z_channels"])
        self.encoder, self.decoder = VQEncoder(*a), VQDecoder(*a)
        self.quantize = Quantizer(n_embed, embed_dim)
        self.quant_conv = PointwiseLinear(dd["z_channels"], embed_dim)
        self.post_quant_conv = PointwiseLinear(embed_dim, dd["z_channels"])


# -------------------------------------------------------- VQ estimator
class FemasrResBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        norm = lambda: _NormLayer(ch)
        self.conv = nn.Sequential(norm(), nn.Identity(), conv(ch, ch, 3), norm(), nn.Identity(),
                                  conv(ch, ch, 3))

    def forward(self, x):
        return x + self.conv(x)


class _NormLayer(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = GroupNorm(num_groups32(ch), ch, act="swish")

    def forward(self, x):
        return self.norm(x)


def _rel_index(ws):
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    r = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return torch.from_numpy((r[..., 0] * (2 * ws - 1) + r[..., 1]).reshape(-1).astype(np.int64))


def _shift_mask(H, W, ws, shift, device):
    def band(n):
        i = torch.arange(n, device=device)
        return (i >= n - ws).long() + (i >= n - shift).long()
    img = band(H)[:, None] * 3 + band(W)[None, :]
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(1, 2).reshape(-1, ws * ws)
    return torch.where(win[:, None, :] != win[:, :, None], -100.0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, ws):
        super().__init__()
        self.heads = heads
        self.qkv, self.proj = SLinear(dim, 3 * dim), SLinear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("relative_position_index", _rel_index(ws), persistent=False)

    def forward(self, xw, mask=None):
        Bn, N, C = xw.shape
        h, hd = self.heads, C // self.heads
        q, k, v = self.qkv(xw).reshape(Bn, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        a = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index]
        a = a + bias.reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            a = (a.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]).reshape(Bn, h, N, N)
        return self.proj((torch.softmax(a, dim=-1) @ v).transpose(1, 2).reshape(Bn, N, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1, self.fc2 = SLinear(dim, hidden), SLinear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, heads, ws)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x):
        B, H, W, C = x.shape
        ws = self.ws
        shift = self.shift if min(H, W) > ws else 0
        y = self.norm1(x)
        if shift:
            y = torch.roll(y, (-shift, -shift), (1, 2))
        yw = y.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5) \
            .reshape(-1, ws * ws, C)
        yw = self.attn(yw, _shift_mask(H, W, ws, shift, x.device) if shift else None)
        y = yw.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5) \
            .reshape(B, H, W, C)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class _Group(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    def __init__(self, dim, depth, heads, ws):
        super().__init__()
        self.residual_group = _Group(SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2)
                                     for i in range(depth))
        self.conv = conv(dim, dim, 3)

    def forward(self, x):
        y = x.permute(0, 2, 3, 1)
        for blk in self.residual_group.blocks:
            y = blk(y)
        return x + self.conv(y.permute(0, 3, 1, 2))


class VqEstimator(nn.Module):
    """DualBlockSwinVqEstimator: (pred_embed, logits)."""

    def __init__(self, in_ch, main_ch, n_embed, embed_dim, depth, heads, ws, n_swin):
        super().__init__()
        self.ws = ws
        self.first_block = nn.Sequential(conv(in_ch, main_ch, 3), nn.Identity(),
                                         FemasrResBlock(main_ch), FemasrResBlock(main_ch),
                                         conv(main_ch, main_ch, 3))
        self.embed_projection = conv(main_ch, embed_dim, 1)
        self.swin_blks = nn.ModuleList(RSTB(main_ch, depth, heads, ws) for _ in range(n_swin))
        self.out_block = nn.Sequential(FemasrResBlock(main_ch), conv(main_ch, n_embed, 3))

    def forward(self, x):
        x = self.first_block(x)
        pred = self.embed_projection(x)
        H, W = x.shape[2:]
        ph, pw = (-H) % self.ws, (-W) % self.ws
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        for blk in self.swin_blks:
            x = blk(x)
        return pred, self.out_block(x[:, :, :H, :W])


# -------------------------------------------------------------- fusion
class GNResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(num_groups32(cin), cin, act="swish")
        self.conv1 = conv(cin, cout, 3)
        self.norm2 = GroupNorm(num_groups32(cout), cout, act="swish")
        self.conv2 = conv(cout, cout, 3)
        self.conv_out = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (self.conv_out(x) if self.conv_out is not None else x) + h


class FuseSftBlock(nn.Module):
    def __init__(self, dec_ch, cond_ch, mid_ch):
        super().__init__()
        self.fuse_block = GNResBlock(cond_ch + dec_ch, mid_ch)
        self.scale = nn.Sequential(conv(mid_ch, dec_ch, 3), nn.LeakyReLU(0.2),
                                   conv(dec_ch, dec_ch, 3))
        self.shift = nn.Sequential(conv(mid_ch, dec_ch, 3), nn.LeakyReLU(0.2),
                                   conv(dec_ch, dec_ch, 3))

    def forward(self, dec, cond):
        f = self.fuse_block(torch.cat([cond, dec], dim=1))
        return dec + (dec * self.scale(f) + self.shift(f))


class FusionModule(nn.Module):
    def __init__(self, schedule):
        super().__init__()
        self.fusion_modules = nn.ModuleDict(
            {k: FuseSftBlock(s["dec_ch"], s["cond_ch"], s.get("mid_ch", s["dec_ch"]))
             for k, s in schedule.items()})


# ---------------------------------------------------------------- model
CODEC_STACKS = ("encoder", "decoder", "hyperencoder", "vq_estimator", "vq_model",
                "fusion_module")


class DCVIC(nn.Module):
    """The whole model; ``opt`` is the configuration file's ``model_config``."""

    def __init__(self, opt):
        super().__init__()
        sub, m = opt["subnet"], opt["model"]
        enc, dec, vq = sub["encoder"], sub["decoder"], sub["vq_model"]
        est, ctx = sub["vq_estimator"], sub["context_model"]
        n_embed, d = vq["n_embed"], vq["embed_dim"]
        y_ch, z_ch = enc["out_ch"], sub["entropy_model_z"]["channels"]
        hyper_out = sub["hyperdecoder"]["hyper_out_ch"]
        self.n_embed = n_embed
        self.entropy_tf32 = opt.get("entropy_precision", "high") == "default"
        self.encoder = Encoder(enc["in_ch"], d + n_embed, y_ch, enc["main_ch"],
                               enc["block_mid_ch"], enc["cond_ch"], enc["L"],
                               enc["max_beta_1"], enc["max_beta_2"], enc.get("num_blocks", 3))
        self.decoder = Decoder(y_ch, dec["main_ch"], dec["block_mid_ch"], dec["cond_ch"],
                               dec["L"], dec["max_beta_1"], dec["max_beta_2"],
                               dec["fusion_layer_dict"], dec.get("num_blocks", 3))
        self.hyperencoder = HyperEncoder(y_ch, z_ch)
        self.hyperdecoder = HyperDecoder(z_ch, hyper_out)
        self.context_model = ContextModel(y_ch, hyper_out, ctx["num_slices"],
                                          ctx["max_support_slices"],
                                          tuple(ctx.get("slice_mid_ch", (224, 128))))
        self.vq_estimator = VqEstimator(dec["main_ch"], est["main_ch"], n_embed, d, est["blk_depth"],
                                        est.get("num_heads", 8), est.get("window_size", 8),
                                        est["num_swin_blocks"])
        self.vq_model = VQModel(n_embed, d, vq["ddconfig"])
        self.fusion_module = FusionModule(sub["fusion_module"]["fuse_scedule_dict"])
        self.entropy_model_z = EntropyBottleneck(z_ch)
        assert m["type"] == "HyperpriorCharmDualCondVicModel"
        assert m.get("enc_vq_input", "onehot_indices") == "onehot_indices"

    # ---- numerics
    @contextlib.contextmanager
    def entropy_convs(self):
        """The entropy-parameter convs' products as configured, on the
        backend settings of a codec call: TF32 in cuDNN only with
        ``entropy_precision: default``, deterministic algorithms."""
        cudnn = torch.backends.cudnn
        before = (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, cudnn.deterministic,
                  cudnn.benchmark)
        cudnn.allow_tf32 = self.entropy_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            yield
        finally:
            (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark) = before

    # ---- encode
    def vq_encode(self, x):
        h = self.vq_model.quant_conv(self.vq_model.encoder(x)).float()
        idx = self.vq_model.quantize.indices(h)
        return self.vq_model.quantize.lookup(idx), idx

    def comp_encode(self, x, lat, idx, b1, b2):
        onehot = F.one_hot(idx.long(), self.n_embed).permute(0, 3, 1, 2).to(lat.dtype)
        feat = torch.cat([lat, onehot], dim=1)
        return self.encoder(x, feat, b1, b2).float()

    def front(self, x, b1, b2):
        """Image in [-1, 1] -> (y, z, token map)."""
        lat, idx = self.vq_encode(x)
        y = self.comp_encode(x, lat, idx, b1, b2)
        return y, self.hyperencoder(y).float(), idx

    def vq_latent(self, x):
        """The VQGAN encoder's latent before the quantizer, f32."""
        return self.vq_model.quant_conv(self.vq_model.encoder(x)).float()

    def front_stages(self, x, b1, b2):
        """(VQGAN latent, y, z) of the encode front, each stage fed by the
        one before."""
        h = self.vq_latent(x)
        idx = self.vq_model.quantize.indices(h)
        y = self.comp_encode(x, self.vq_model.quantize.lookup(idx), idx, b1, b2)
        return h, y, self.hyperencoder(y).float()

    # ---- entropy chain (the decoder's, driven by symbols)
    def hyper_decode(self, z_sym):
        z_hat = self.entropy_model_z.dequantize(z_sym.contiguous())
        with self.entropy_convs():
            return self.hyperdecoder(z_hat).contiguous(), z_hat

    def slice_params(self, i, hyper_out, prev):
        with self.entropy_convs():
            mu, sigma, _ = self.context_model.mu_sigma(i, hyper_out, prev)
        return mu.contiguous(), scale_indexes(sigma.contiguous())

    def slice_reconstruct(self, i, hyper_out, prev, sym, mu):
        hm, _ = hyper_out.chunk(2, dim=1)
        with self.entropy_convs():
            mean_support = torch.cat([hm] + prev[:self.context_model.support], dim=1)
            return self.context_model.lrp(i, mean_support, sym.to(mu.dtype) + mu)

    # ---- decode
    def decode_from_y_hat(self, y_hat, b1, b2, tokens=None):
        """y_hat -> (image [-1, 1], pred_embed, logits, token map); with
        ``tokens`` the VQGAN decoder reads that token map instead of the
        estimator's argmax."""
        feat, cond = self.decoder.get_feats(y_hat, b1, b2)
        pred, logits = self.vq_estimator(feat)
        idx = torch.argmax(logits, dim=1) if tokens is None else tokens
        lat = self.vq_model.post_quant_conv(self.vq_model.quantize.lookup(idx))
        fake = self.vq_model.decoder(lat, self.fusion_module.fusion_modules, cond).float()
        return fake, pred, logits, idx


def set_numerics(model: DCVIC, quant: Optional[str]) -> None:
    """Products of the bf16-deployed stacks in float32 (None) or fp8."""
    for name in CODEC_STACKS:
        for mod in getattr(model, name).modules():
            if isinstance(mod, (SConv, SDeconv, SLinear)):
                mod.quant = quant


def to_pixels(fake: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> uint8 NHWC."""
    px = torch.round((torch.clamp(fake, -1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)
    return px.permute(0, 2, 3, 1)


def from_pixels(px: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> [-1, 1] NCHW f32."""
    t = px.permute(0, 3, 1, 2).float() / 255.0
    return (t - 0.5) / 0.5

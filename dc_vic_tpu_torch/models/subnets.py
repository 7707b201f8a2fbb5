"""Compression subnets of the DCVICModel family (port of
dc_vic_tpu/models/subnets.py): the ELIC analysis and synthesis transforms
with and without dual-beta FiLM and VQ insertion, the Minnen'20 and
Balle'18 hyperpriors, the ChARM context model and the Swin VQ estimator.

NCHW modules with the reference's torch parameter names. Unlike flax, torch
needs every input width at construction; build_comp_model supplies them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..codec.gaussian import GaussianConditional
from ..codec.ops import Noise
from ..nn.layers import (BetaScaleShift, ChengNLAM, FemasrResBlock,
                         ResidualBottleneckBlocks, beta_cond, beta_mlp, conv,
                         deconv, up_conv)
from ..nn.swin import RSTB
from ..utils.profiling import span
from ..utils.registry import (CONTEXTMODEL_REGISTRY, DECODER_REGISTRY,
                              ENCODER_REGISTRY, HYPERDECODER_REGISTRY,
                              HYPERENCODER_REGISTRY, VQ_ESTIMATOR_REGISTRY)


class _BetaFilm(nn.Module):
    """Shared dual-beta conditioning of the ELIC transforms."""

    def _init_beta(self, cond_ch, L, max_beta_1, max_beta_2, use_pi, include_x):
        self.beta_args = (L, max_beta_1, max_beta_2, use_pi, include_x)
        self.mlp = beta_mlp(cond_ch, L, include_x)

    def cond(self, beta_1, beta_2):
        with span("nn.fusion"):
            return beta_cond(self.mlp, beta_1, beta_2, *self.beta_args)


@ENCODER_REGISTRY.register()
class ElicDualBetaFtVqScEncoder(_BetaFilm):
    """Shipped encoder: beta-FiLM after each of the 9 ELIC layers and the VQ
    feature concat-projection at /8."""

    def __init__(self, in_ch: int = 3, input_feat_ch: int = 260, out_ch: int = 192,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 res_in_res: bool = False, max_beta_1: float = 3.0,
                 max_beta_2: float = 3.5, cond_ch: int = 128, L: int = 10,
                 use_pi: bool = False, include_x: bool = True):
        super().__init__()
        self._init_beta(cond_ch, L, max_beta_1, max_beta_2, use_pi, include_x)
        rb = lambda: ResidualBottleneckBlocks(main_ch, block_mid_ch, num_blocks, res_in_res)
        self.conv1 = conv(in_ch, main_ch, 5, 2)
        self.block1 = rb()
        self.conv2 = conv(main_ch, main_ch, 5, 2)
        self.block2 = rb()
        self.attn2 = ChengNLAM(main_ch)
        self.conv3 = conv(main_ch, main_ch, 5, 2)
        self.projection = conv(input_feat_ch + main_ch, main_ch, 3)
        self.block3 = rb()
        self.conv4 = conv(main_ch, out_ch, 5, 2)
        self.attn4 = ChengNLAM(out_ch)
        self.beta_ft_list = nn.ModuleList(
            BetaScaleShift(out_ch if i >= 7 else main_ch, cond_ch) for i in range(9))

    def forward(self, x, feat, beta_1, beta_2):
        cond = self.cond(beta_1, beta_2)
        ft = lambda i, h: self.beta_ft_list[i](h, cond)
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


@ENCODER_REGISTRY.register()
class ElicVqCatScEncoder(nn.Module):
    """The stage 1_1 encoder: the ELIC analysis layers of
    ElicDualBetaFtVqScEncoder without the FiLM, and the VQ feature
    concat-projection after conv3 (/8) or, with ``proj_pos`` "conv4", after
    conv4 (/16)."""

    def __init__(self, in_ch: int = 3, input_feat_ch: int = 260, out_ch: int = 192,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 res_in_res: bool = False, proj_pos: str = "conv3"):
        super().__init__()
        if proj_pos not in ("conv3", "conv4"):
            raise ValueError(f"proj_pos {proj_pos!r}: 'conv3' or 'conv4'")
        self.proj_pos = proj_pos
        rb = lambda: ResidualBottleneckBlocks(main_ch, block_mid_ch, num_blocks, res_in_res)
        proj_ch = main_ch if proj_pos == "conv3" else out_ch
        self.conv1 = conv(in_ch, main_ch, 5, 2)
        self.block1 = rb()
        self.conv2 = conv(main_ch, main_ch, 5, 2)
        self.block2 = rb()
        self.attn2 = ChengNLAM(main_ch)
        self.conv3 = conv(main_ch, main_ch, 5, 2)
        self.projection = conv(input_feat_ch + proj_ch, proj_ch, 3)
        self.block3 = rb()
        self.conv4 = conv(main_ch, out_ch, 5, 2)
        self.attn4 = ChengNLAM(out_ch)

    def forward(self, x, feat):
        project = lambda h: h + self.projection(torch.cat([feat, h], dim=1))
        x = self.attn2(self.block2(self.conv2(self.block1(self.conv1(x)))))
        x = self.conv3(x)
        if self.proj_pos == "conv3":
            x = project(x)
        x = self.conv4(self.block3(x))
        if self.proj_pos == "conv4":
            x = project(x)
        return self.attn4(x)


class IndexEmbedding(nn.Embedding):
    """The learned embedding of the VQ token map that the ``long_indices``
    encoders concatenate into their projection; ``init_weights`` draws it
    N(0, 1), as flax does (not the codebook's U(-1/n, 1/n))."""

    def forward(self, indices):
        """indices [B, h, w] -> [B, dim, h, w]."""
        return super().forward(indices.long()).permute(0, 3, 1, 2)


class _ElicAnalysis(nn.Module):
    """The ELIC analysis layers conv1, block1, conv2, block2, attn2, conv3,
    block3, conv4, attn4 (``projection``, where given, registered after
    conv3) and the VQ insertion of the encoders that take the token map."""

    def _build_layers(self, in_ch, out_ch, main_ch, block_mid_ch, num_blocks, res_in_res,
                      projection: Optional[nn.Module] = None):
        rb = lambda: ResidualBottleneckBlocks(main_ch, block_mid_ch, num_blocks, res_in_res)
        self.conv1 = conv(in_ch, main_ch, 5, 2)
        self.block1 = rb()
        self.conv2 = conv(main_ch, main_ch, 5, 2)
        self.block2 = rb()
        self.attn2 = ChengNLAM(main_ch)
        self.conv3 = conv(main_ch, main_ch, 5, 2)
        if projection is not None:
            self.projection = projection
        self.block3 = rb()
        self.conv4 = conv(main_ch, out_ch, 5, 2)
        self.attn4 = ChengNLAM(out_ch)

    def _init_emb_projection(self, input_feat_ch, out_ch, main_ch, proj_pos, vq_n_embed,
                             vq_ind_embed_dim) -> nn.Module:
        """The index embedding and the 3x3 projection of concat(feat, h,
        emb) after conv3 (/8) or conv4 (/16)."""
        if proj_pos not in ("conv3", "conv4"):
            raise ValueError(f"proj_pos {proj_pos!r}: 'conv3' or 'conv4'")
        self.proj_pos = proj_pos
        self.vq_ind_emb = IndexEmbedding(vq_n_embed, vq_ind_embed_dim)
        proj_ch = main_ch if proj_pos == "conv3" else out_ch
        return conv(input_feat_ch + proj_ch + vq_ind_embed_dim, proj_ch, 3)

    def _project_emb(self, h, feat, vq_indices):
        return h + self.projection(torch.cat([feat, h, self.vq_ind_emb(vq_indices)], dim=1))


@ENCODER_REGISTRY.register()
class ElicEncoder(_ElicAnalysis):
    """The plain ELIC analysis transform: four stride-2 5x5 convs, residual
    bottleneck stacks, NLAM at /4 and /16 (standalone: it takes x alone)."""

    def __init__(self, in_ch: int = 3, out_ch: int = 192, main_ch: int = 192,
                 block_mid_ch: int = 96, num_blocks: int = 3, res_in_res: bool = False):
        super().__init__()
        self._build_layers(in_ch, out_ch, main_ch, block_mid_ch, num_blocks, res_in_res)

    def forward(self, x):
        x = self.attn2(self.block2(self.conv2(self.block1(self.conv1(x)))))
        return self.attn4(self.conv4(self.block3(self.conv3(x))))


@ENCODER_REGISTRY.register()
class ElicVqScEncoder(_ElicAnalysis):
    """ElicEncoder with a 1x1 projection of the VQ feature added after
    conv3 (/8)."""

    def __init__(self, in_ch: int = 3, input_feat_ch: int = 260, out_ch: int = 192,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 res_in_res: bool = False):
        super().__init__()
        self._build_layers(in_ch, out_ch, main_ch, block_mid_ch, num_blocks, res_in_res,
                           projection=conv(input_feat_ch, main_ch, 1))

    def forward(self, x, feat):
        x = self.attn2(self.block2(self.conv2(self.block1(self.conv1(x)))))
        x = self.conv3(x) + self.projection(feat)
        return self.attn4(self.conv4(self.block3(x)))


@ENCODER_REGISTRY.register()
class ElicVqEmbCatEncoder(_ElicAnalysis):
    """ElicVqCatScEncoder with a learned embedding of the VQ indices
    concatenated into the projection (``enc_vq_input: long_indices``)."""

    def __init__(self, in_ch: int = 3, input_feat_ch: int = 4, out_ch: int = 192,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 res_in_res: bool = False, proj_pos: str = "conv3", vq_n_embed: int = 256,
                 vq_ind_embed_dim: int = 32):
        super().__init__()
        proj = self._init_emb_projection(input_feat_ch, out_ch, main_ch, proj_pos, vq_n_embed,
                                         vq_ind_embed_dim)
        self._build_layers(in_ch, out_ch, main_ch, block_mid_ch, num_blocks, res_in_res, proj)

    def forward(self, x, feat, vq_indices):
        x = self.attn2(self.block2(self.conv2(self.block1(self.conv1(x)))))
        x = self.conv3(x)
        if self.proj_pos == "conv3":
            x = self._project_emb(x, feat, vq_indices)
        x = self.conv4(self.block3(x))
        if self.proj_pos == "conv4":
            x = self._project_emb(x, feat, vq_indices)
        return self.attn4(x)


@ENCODER_REGISTRY.register()
class ElicDualBetaFtVqEmbCatEncoder(_ElicAnalysis, _BetaFilm):
    """Dual-beta FiLM and the embedded-index VQ insertion. As the reference,
    it has no FiLM right after conv3: ``beta_ft_list`` holds 0-4 and 6-8,
    keyed by position."""

    FILM = (0, 1, 2, 3, 4, 6, 7, 8)

    def __init__(self, in_ch: int = 3, input_feat_ch: int = 4, out_ch: int = 192,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 res_in_res: bool = False, proj_pos: str = "conv3", vq_n_embed: int = 256,
                 vq_ind_embed_dim: int = 32, max_beta_1: float = 3.0,
                 max_beta_2: float = 3.5, cond_ch: int = 128, L: int = 10,
                 use_pi: bool = False, include_x: bool = True):
        super().__init__()
        self._init_beta(cond_ch, L, max_beta_1, max_beta_2, use_pi, include_x)
        proj = self._init_emb_projection(input_feat_ch, out_ch, main_ch, proj_pos, vq_n_embed,
                                         vq_ind_embed_dim)
        self._build_layers(in_ch, out_ch, main_ch, block_mid_ch, num_blocks, res_in_res, proj)
        self.beta_ft_list = nn.ModuleDict({
            str(i): BetaScaleShift(out_ch if i >= 7 else main_ch, cond_ch) for i in self.FILM})

    def forward(self, x, feat, beta_1, beta_2, vq_indices):
        cond = self.cond(beta_1, beta_2)
        ft = lambda i, h: self.beta_ft_list[str(i)](h, cond)
        x = ft(0, self.conv1(x))
        x = ft(1, self.block1(x))
        x = ft(2, self.conv2(x))
        x = ft(3, self.block2(x))
        x = ft(4, self.attn2(x))
        x = self.conv3(x)
        if self.proj_pos == "conv3":
            x = self._project_emb(x, feat, vq_indices)
        x = ft(6, self.block3(x))
        x = self.conv4(x)
        if self.proj_pos == "conv4":
            x = self._project_emb(x, feat, vq_indices)
        x = ft(7, x)
        return ft(8, self.attn4(x))


class _ElicFeatDecoder(nn.Module):
    """The ELIC synthesis stack with fusion taps, shared by the decoders
    with and without FiLM: ``_run`` returns the transformer feature and the
    fusion features, and stops at the last layer it needs (so the layers
    after it are not built at all)."""

    LAYER_NAMES = ("attn1", "conv1", "block1", "conv2", "attn2", "block2",
                   "conv3", "block3", "conv4")

    @classmethod
    def _num_layers(cls, fusion_layer_dict, feat_layer_name) -> int:
        wanted = set(fusion_layer_dict) | {feat_layer_name}
        return 1 + max(cls.LAYER_NAMES.index(n) for n in wanted)

    def _build_layers(self, fusion_layer_dict, in_ch, feat_layer_name, out_ch, main_ch,
                      block_mid_ch, num_blocks, pixel_shuffle, res_in_res):
        self.fusion_layer_dict = dict(fusion_layer_dict)
        self.feat_layer_name = feat_layer_name
        self.num_layers = self._num_layers(self.fusion_layer_dict, feat_layer_name)
        rb = lambda: ResidualBottleneckBlocks(main_ch, block_mid_ch, num_blocks, res_in_res)
        make = {
            "attn1": lambda: ChengNLAM(in_ch),
            "conv1": lambda: up_conv(in_ch, main_ch, pixel_shuffle),
            "block1": rb,
            "conv2": lambda: up_conv(main_ch, main_ch, pixel_shuffle),
            "attn2": lambda: ChengNLAM(main_ch),
            "block2": rb,
            "conv3": lambda: up_conv(main_ch, main_ch, pixel_shuffle),
            "block3": rb,
            "conv4": lambda: up_conv(main_ch, out_ch, pixel_shuffle),
        }
        for name in self.LAYER_NAMES[:self.num_layers]:
            self.add_module(name, make[name]())

    def _run(self, x, film=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The layers in order, ``film(i, x)`` before layer i where given."""
        feat, fusion_feats = None, {}
        for i, name in enumerate(self.LAYER_NAMES[:self.num_layers]):
            x = getattr(self, name)(x if film is None else film(i, x))
            if name == self.feat_layer_name:
                feat = x
            if name in self.fusion_layer_dict:
                fusion_feats[self.fusion_layer_dict[name]] = x
        return feat, fusion_feats


@DECODER_REGISTRY.register()
class ElicDecoder(_ElicFeatDecoder):
    """The plain ELIC synthesis transform: all nine layers, then tanh
    (``use_tanh``); standalone, it takes y alone and has no taps."""

    def __init__(self, in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 block_mid_ch: int = 96, num_blocks: int = 3, use_tanh: bool = True,
                 pixel_shuffle: bool = False, res_in_res: bool = False):
        super().__init__()
        self.use_tanh = use_tanh
        self._build_layers({}, in_ch, self.LAYER_NAMES[-1], out_ch, main_ch, block_mid_ch,
                           num_blocks, pixel_shuffle, res_in_res)

    def forward(self, x):
        x, _ = self._run(x)
        return torch.tanh(x) if self.use_tanh else x


@DECODER_REGISTRY.register()
class ElicFeatFusionDecoder(_ElicFeatDecoder):
    """The stage 1_1 decoder: the ELIC synthesis stack with fusion taps and
    no FiLM."""

    def __init__(self, fusion_layer_dict: Dict[str, str], in_ch: int = 192,
                 feat_layer_name: str = "block1", out_ch: int = 3,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 use_tanh: bool = False, pixel_shuffle: bool = False,
                 res_in_res: bool = False):
        super().__init__()
        self._build_layers(fusion_layer_dict, in_ch, feat_layer_name, out_ch, main_ch,
                           block_mid_ch, num_blocks, pixel_shuffle, res_in_res)

    def get_feats(self, x) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self._run(x)


@DECODER_REGISTRY.register()
class ElicDualBetaFtFeatFusionDecoder(_ElicFeatDecoder, _BetaFilm):
    """Shipped decoder: beta-FiLM before each ELIC synthesis layer plus an
    initial residual FiLM."""

    def __init__(self, fusion_layer_dict: Dict[str, str], in_ch: int = 192,
                 feat_layer_name: str = "block1", out_ch: int = 3,
                 main_ch: int = 192, block_mid_ch: int = 96, num_blocks: int = 3,
                 use_tanh: bool = False, pixel_shuffle: bool = False,
                 res_in_res: bool = False, max_beta_1: float = 3.0,
                 max_beta_2: float = 3.5, cond_ch: int = 128, L: int = 10,
                 use_pi: bool = False, include_x: bool = True):
        super().__init__()
        self._init_beta(cond_ch, L, max_beta_1, max_beta_2, use_pi, include_x)
        self.init_fuse = BetaScaleShift(in_ch, cond_ch)
        self.beta_ft_list = nn.ModuleList(
            BetaScaleShift(in_ch if i < 2 else main_ch, cond_ch)
            for i in range(self._num_layers(fusion_layer_dict, feat_layer_name)))
        self._build_layers(fusion_layer_dict, in_ch, feat_layer_name, out_ch, main_ch,
                           block_mid_ch, num_blocks, pixel_shuffle, res_in_res)

    def get_feats(self, x, beta_1, beta_2) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cond = self.cond(beta_1, beta_2)
        x = self.init_fuse(x, cond) + x
        return self._run(x, lambda i, h: self.beta_ft_list[i](h, cond))


@HYPERENCODER_REGISTRY.register()
class Minnen20HyperEncoder(nn.Module):
    def __init__(self, in_ch: int = 192, bottleneck_z: int = 192):
        super().__init__()
        self.conv1 = conv(in_ch, 320, 3)
        self.conv2 = conv(320, 256, 5, 2)
        self.conv3 = conv(256, bottleneck_z, 5, 2)

    def forward(self, y):
        y = F.relu(self.conv1(y))
        y = F.relu(self.conv2(y))
        return self.conv3(y)


class _HyperDecoderBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = deconv(in_ch, 192)
        self.conv2 = deconv(192, 256)
        self.conv3 = conv(256, out_ch, 3, entropy=True)

    def forward(self, z):
        z = F.relu(self.conv1(z))
        z = F.relu(self.conv2(z))
        return self.conv3(z)


@HYPERDECODER_REGISTRY.register()
class Minnen20HyperDecoder(nn.Module):
    """Two deconv towers -> concat(mu, std) [B, hyper_out_ch, h, w]."""

    def __init__(self, in_ch: int = 192, hyper_out_ch: int = 256):
        super().__init__()
        self.hd_mu = _HyperDecoderBlock(in_ch, hyper_out_ch // 2)
        self.hd_std = _HyperDecoderBlock(in_ch, hyper_out_ch // 2)

    def forward(self, z):
        return torch.cat([self.hd_mu(z), self.hd_std(z)], dim=1)


@HYPERENCODER_REGISTRY.register()
class Balle18HyperEncoder(nn.Module):
    """|y| -> 3x3 conv -> two stride-2 5x5 convs, ReLU between."""

    def __init__(self, in_ch: int = 192, bottleneck_z: int = 192):
        super().__init__()
        self.conv1 = conv(in_ch, bottleneck_z, 3)
        self.conv2 = conv(bottleneck_z, bottleneck_z, 5, 2)
        self.conv3 = conv(bottleneck_z, bottleneck_z, 5, 2)

    def forward(self, y):
        y = F.relu(self.conv1(torch.abs(y)))
        y = F.relu(self.conv2(y))
        return self.conv3(y)


@HYPERDECODER_REGISTRY.register()
class Balle18HyperDecoder(_HyperDecoderBlock):
    """One deconv tower -> [B, hyper_out_ch, h, w] (the non-ChARM models
    read it as means then scales)."""

    def __init__(self, in_ch: int = 192, hyper_out_ch: int = 256):
        super().__init__(in_ch, hyper_out_ch)


class SliceTransform(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, mid_ch: Sequence[int] = (224, 128)):
        super().__init__()
        self.model = nn.Sequential(conv(in_ch, mid_ch[0], 5, entropy=True), nn.ReLU(),
                                   conv(mid_ch[0], mid_ch[1], 5, entropy=True), nn.ReLU(),
                                   conv(mid_ch[1], out_ch, 3, entropy=True))

    def forward(self, x):
        return self.model(x)


@CONTEXTMODEL_REGISTRY.register()
class Minnen20CharmContextModel(nn.Module):
    """y in num_slices channel slices; per-slice convnets predict mu and
    sigma from the hyper output and up to max_support_slices decoded slices;
    an LRP convnet adds 0.5 * tanh(.) to each reconstructed slice."""

    def __init__(self, num_slices: int = 6, bottleneck_y: int = 192,
                 hyper_out_ch: int = 256, max_support_slices: int = 4,
                 slice_mid_ch: Sequence[int] = (224, 128),
                 gaussian: Optional[GaussianConditional] = None):
        super().__init__()
        if bottleneck_y % num_slices:
            raise ValueError("bottleneck_y must divide into num_slices")
        self.num_slices = num_slices
        self.max_support_slices = max_support_slices
        self.slice_ch = sc = bottleneck_y // num_slices
        self.gaussian = gaussian or GaussianConditional()
        hm = hyper_out_ch // 2
        mid = tuple(slice_mid_ch)

        def n_sup(i):
            return i if max_support_slices < 0 else min(i, max_support_slices)
        self.mean_slice_transforms = nn.ModuleList(
            SliceTransform(hm + sc * n_sup(i), sc, mid) for i in range(num_slices))
        self.scale_slice_transforms = nn.ModuleList(
            SliceTransform(hm + sc * n_sup(i), sc, mid) for i in range(num_slices))
        self.lrp_slice_transforms = nn.ModuleList(
            SliceTransform(hm + sc * n_sup(i) + sc, sc, mid) for i in range(num_slices))

    def _supports(self, y_hat_prev: torch.Tensor) -> List[torch.Tensor]:
        slices = list(torch.split(y_hat_prev, self.slice_ch, dim=1)) \
            if y_hat_prev.shape[1] else []
        return slices if self.max_support_slices < 0 \
            else slices[:self.max_support_slices]

    def _mu_sigma(self, i: int, hyper_out, sup: List[torch.Tensor]):
        hyper_mean, hyper_scale = hyper_out.chunk(2, dim=1)
        mean_support = torch.cat([hyper_mean] + sup, dim=1)
        mu = self.mean_slice_transforms[i](mean_support)
        sigma = self.scale_slice_transforms[i](torch.cat([hyper_scale] + sup, dim=1))
        return mu, sigma, mean_support

    def _lrp(self, i: int, mean_support, y_hat_slice):
        lrp = self.lrp_slice_transforms[i](torch.cat([mean_support, y_hat_slice], dim=1))
        return y_hat_slice + 0.5 * torch.tanh(lrp)

    def slice_params(self, i: int, hyper_out, y_hat_prev):
        """(mu, sigma) of slice i from the hyper output and the previously
        decoded slices stacked on the channel axis."""
        mu, sigma, _ = self._mu_sigma(i, hyper_out, self._supports(y_hat_prev))
        return mu, sigma

    def slice_reconstruct(self, i: int, hyper_out, y_hat_prev, symbols, mu):
        """Dequantize slice i from its symbols and add the LRP term."""
        hyper_mean, _ = hyper_out.chunk(2, dim=1)
        mean_support = torch.cat([hyper_mean] + self._supports(y_hat_prev), dim=1)
        return self._lrp(i, mean_support, self.gaussian.dequantize(symbols, mu))

    def compress_forward(self, y, hyper_out):
        """The deterministic encode pass: (symbols int32, sigma, y_hat,
        likelihood), slices concatenated on the channel axis. y_hat comes
        from the clipped symbols, as the decoder rebuilds it."""
        y_hat_slices, syms, sigmas, liks = [], [], [], []
        for i, y_slice in enumerate(y.chunk(self.num_slices, dim=1)):
            sup = y_hat_slices if self.max_support_slices < 0 \
                else y_hat_slices[:self.max_support_slices]
            mu, sigma, mean_support = self._mu_sigma(i, hyper_out, sup)
            sym = self.gaussian.quantize_symbols(y_slice, mu)
            y_hat_slice = self.gaussian.dequantize(sym, mu)
            syms.append(sym)
            sigmas.append(sigma)
            liks.append(self.gaussian.likelihood(y_hat_slice, sigma, mu))
            y_hat_slices.append(self._lrp(i, mean_support, y_hat_slice))
        return (torch.cat(syms, dim=1), torch.cat(sigmas, dim=1),
                torch.cat(y_hat_slices, dim=1), torch.cat(liks, dim=1))

    def forward(self, y, hyper_out, is_train: bool, noise: Optional[Noise] = None,
                calc_q_likelihood: bool = True):
        """All slices in one pass (the training and eval forward). Returns
        (y_hat, y_likelihood) and, with ``calc_q_likelihood``, the
        likelihood of the hard-rounded y under detached parameters."""
        y_hat_slices, liks, q_liks = [], [], []
        for i, y_slice in enumerate(y.chunk(self.num_slices, dim=1)):
            sup = y_hat_slices if self.max_support_slices < 0 \
                else y_hat_slices[:self.max_support_slices]
            mu, sigma, mean_support = self._mu_sigma(i, hyper_out, sup)
            params = torch.cat([mu, sigma], dim=1)
            y_hat_slice, lik = self.gaussian(y_slice, params, is_train, noise)
            liks.append(lik)
            if calc_q_likelihood:
                q_liks.append(self.gaussian(y_slice.detach(), params.detach(), False)[1])
            y_hat_slices.append(self._lrp(i, mean_support, y_hat_slice))
        y_hat, y_lik = torch.cat(y_hat_slices, dim=1), torch.cat(liks, dim=1)
        if calc_q_likelihood:
            return y_hat, y_lik, torch.cat(q_liks, dim=1)
        return y_hat, y_lik


@VQ_ESTIMATOR_REGISTRY.register()
class DualBlockSwinVqEstimator(nn.Module):
    """conv + GN ResBlocks head -> embed projection -> N x RSTB -> logits.
    Returns (pred_embed [B, embed_dim, h, w], logits [B, n_embed, h, w]).
    Reflect-pads to a window multiple when h or w is not one."""

    def __init__(self, in_ch: int = 192, main_ch: int = 128, n_embed: int = 256,
                 embed_dim: int = 4, blk_depth: int = 3, num_heads: int = 8,
                 window_size: int = 8, num_swin_blocks: int = 3,
                 act_type: str = "silu", use_upsample: bool = False,
                 proj_pos: str = "before_rstb"):
        super().__init__()
        if proj_pos not in ("before_rstb", "after_rstb"):
            raise ValueError(proj_pos)
        self.use_upsample = use_upsample
        self.proj_pos = proj_pos
        self.window_size = window_size
        self.first_block = nn.Sequential(
            conv(in_ch, main_ch, 3),
            nn.Upsample(scale_factor=2, mode="nearest") if use_upsample else nn.Identity(),
            FemasrResBlock(main_ch, act_type), FemasrResBlock(main_ch, act_type),
            conv(main_ch, main_ch, 3))
        self.embed_projection = conv(main_ch, embed_dim, 1)
        self.swin_blks = nn.ModuleList(
            RSTB(main_ch, blk_depth, num_heads, window_size)
            for _ in range(num_swin_blocks))
        self.out_block = nn.Sequential(FemasrResBlock(main_ch, act_type),
                                       conv(main_ch, n_embed, 3))

    def forward(self, x):
        x = self.first_block(x)
        pred_embed = self.embed_projection(x) if self.proj_pos == "before_rstb" else None
        H, W = x.shape[2:]
        ws = self.window_size
        pad_h, pad_w = (-H) % ws, (-W) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
        for blk in self.swin_blks:
            x = blk(x)
        if pad_h or pad_w:
            x = x[:, :, :H, :W]
        if self.proj_pos == "after_rstb":
            pred_embed = self.embed_projection(x)
        return pred_embed, self.out_block(x)

"""The registered alternative analysis and synthesis transforms of
non-default configs (port of dc_vic_tpu/models/alt_autoencoders.py):
Balle'18 (GDN), Cheng'20 (residual blocks, GDN and NLAM) and the tiny
Test stubs. Each takes one input and runs standalone, as in the JAX
package: none of them fits inside DCVICModel, whose encoder reads the VQ
feature and whose decoder gives fusion taps.

The JAX modules' children are anonymous and in call order; the port keeps
that order in one ``nn.Sequential`` per transform (``model.<i>``), and
``models/convert.py::transform_state_dict`` maps the flax tree onto it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GDN, ChengNLAM, conv, deconv, pixel_shuffle_up
from ..utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY


class _Transform(nn.Module):
    """``model`` in order, then tanh where ``use_tanh``."""

    use_tanh = False

    def forward(self, x):
        x = self.model(x)
        return torch.tanh(x) if self.use_tanh else x


@ENCODER_REGISTRY.register()
class Balle18Encoder(_Transform):
    """Three stride-2 5x5 convs each followed by GDN, then a stride-2 5x5
    conv to ``out_ch``."""

    def __init__(self, in_ch: int = 3, out_ch: int = 192, main_ch: int = 192):
        super().__init__()
        layers = []
        for i in range(3):
            layers += [conv(in_ch if i == 0 else main_ch, main_ch, 5, 2), GDN(main_ch)]
        self.model = nn.Sequential(*layers, conv(main_ch, out_ch, 5, 2))


@DECODER_REGISTRY.register()
class Balle18Decoder(_Transform):
    """Three 5x5 transposed convs each followed by inverse GDN, a transposed
    conv to ``out_ch``, tanh."""

    def __init__(self, in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 use_tanh: bool = True):
        super().__init__()
        self.use_tanh = use_tanh
        layers = []
        for i in range(3):
            layers += [deconv(in_ch if i == 0 else main_ch, main_ch), GDN(main_ch, inverse=True)]
        self.model = nn.Sequential(*layers, deconv(main_ch, out_ch))


def _actv2(kind: str, ch: int) -> nn.Module:
    return {"lrelu": lambda: nn.LeakyReLU(0.2), "gdn": lambda: GDN(ch),
            "igdn": lambda: GDN(ch, inverse=True)}[kind]()


class ChengResBlock(nn.Module):
    """3x3 conv (stride 2 with ``downscale``), leaky ReLU 0.2, 3x3 conv,
    ``actv2`` ("lrelu", "gdn" or "igdn"); a 1x1 ``skip`` (same stride)
    where the width or the size changes."""

    def __init__(self, in_ch: int, out_ch: int, actv2: str = "lrelu",
                 downscale: bool = False):
        super().__init__()
        stride = 2 if downscale else 1
        self.conv1 = conv(in_ch, out_ch, 3, stride)
        self.conv2 = conv(out_ch, out_ch, 3)
        self.actv2 = _actv2(actv2, out_ch)
        self.skip = conv(in_ch, out_ch, 1, stride) if downscale or in_ch != out_ch else None

    def forward(self, x):
        h = self.actv2(self.conv2(F.leaky_relu(self.conv1(x), 0.2)))
        return (x if self.skip is None else self.skip(x)) + h


class ChengUpResBlock(nn.Module):
    """Pixel-shuffle upsampling residual block: 3x3 pixel-shuffle conv,
    leaky ReLU 0.2, 3x3 conv, ``actv2`` ("igdn" or "lrelu"), plus a 1x1
    pixel-shuffle shortcut."""

    def __init__(self, in_ch: int, out_ch: int, actv2: str = "igdn"):
        super().__init__()
        self.up = pixel_shuffle_up(in_ch, out_ch, 3)
        self.conv = conv(out_ch, out_ch, 3)
        self.actv2 = _actv2(actv2, out_ch)
        self.shortcut = pixel_shuffle_up(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.actv2(self.conv(F.leaky_relu(self.up(x), 0.2)))
        return h + self.shortcut(x)


@ENCODER_REGISTRY.register()
class Cheng20Encoder(_Transform):
    """Cheng'20 analysis: residual blocks (three of them stride 2 with GDN),
    NLAM at /4, a stride-2 3x3 conv to ``out_ch`` and NLAM."""

    def __init__(self, in_ch: int = 3, out_ch: int = 192, main_ch: int = 192):
        super().__init__()
        m = main_ch
        self.model = nn.Sequential(
            ChengResBlock(in_ch, m, "gdn", downscale=True), ChengResBlock(m, m, "lrelu"),
            ChengResBlock(m, m, "gdn", downscale=True), ChengNLAM(m),
            ChengResBlock(m, m, "lrelu"), ChengResBlock(m, m, "gdn", downscale=True),
            ChengResBlock(m, m, "lrelu"), conv(m, out_ch, 3, 2), ChengNLAM(out_ch))


@DECODER_REGISTRY.register()
class Cheng20Decoder(_Transform):
    """Cheng'20 synthesis: NLAM, residual and pixel-shuffle upsampling
    blocks (inverse GDN), NLAM at /8, a 3x3 pixel-shuffle conv to
    ``out_ch``, tanh."""

    def __init__(self, in_ch: int = 192, out_ch: int = 3, main_ch: int = 192,
                 use_tanh: bool = True):
        super().__init__()
        self.use_tanh = use_tanh
        m = main_ch
        self.model = nn.Sequential(
            ChengNLAM(in_ch), ChengResBlock(in_ch, m, "lrelu"), ChengUpResBlock(m, m, "igdn"),
            ChengResBlock(m, m, "lrelu"), ChengUpResBlock(m, m, "igdn"), ChengNLAM(m),
            ChengResBlock(m, m, "lrelu"), ChengUpResBlock(m, m, "igdn"),
            ChengResBlock(m, m, "lrelu"), pixel_shuffle_up(m, out_ch, 3))


@ENCODER_REGISTRY.register()
class TestEncoder(_Transform):
    """Wiring stub: three stride-2 5x5 convs to 32 channels with ReLU, one
    to ``out_ch``."""

    def __init__(self, in_ch: int = 3, out_ch: int = 192):
        super().__init__()
        layers = []
        for i in range(3):
            layers += [conv(in_ch if i == 0 else 32, 32, 5, 2), nn.ReLU()]
        self.model = nn.Sequential(*layers, conv(32, out_ch, 5, 2))


@DECODER_REGISTRY.register()
class TestDecoder(_Transform):
    """Wiring stub: three 5x5 transposed convs to 32 channels with ReLU, one
    to ``out_ch``."""

    def __init__(self, in_ch: int = 192, out_ch: int = 3):
        super().__init__()
        layers = []
        for i in range(3):
            layers += [deconv(in_ch if i == 0 else 32, 32), nn.ReLU()]
        self.model = nn.Sequential(*layers, deconv(32, out_ch))

"""The plain reference's side of a codec cell's check: decode the
program's streams with its own entropy parameters and NumPy rANS decoder,
follow the program's encode front and reconstruction stage by stage, and
read off the numbers that ``correct`` compares, by the worst image of a
sampled batch:

* ``stream_bad``: streams whose header is not the one the traffic asked for
  (tpu format, size, quality, lanes, encode batch), or that decoding with
  the reference's entropy parameters does not consume word for word. The
  parameters are floats, so this also holds the program's entropy chain to
  the reference's on the card (``entropy_precision`` as configured). Limit 0.
* ``h_gap``, ``y_gap``, ``z_gap``: the encode front (VQGAN encoder; the
  quantizer's token map and the ELIC analysis transform; the hyperencoder),
  each stage fed the program's own input (``CodecReference.front_gaps``).
* ``token_flips``: the VQ estimator's token map where the reference's
  choice is decided (``_tokens``).
* ``px_rmse``: the program's pixels against the reference's reconstruction
  of the stream's latents with the program's token map: the synthesis
  transform, the fusion blocks and the VQGAN decoder (``_pixels``).

The program's outputs and its own state at those stages are only read here,
to be judged; nothing the program made (weights, tables, plans) enters the
reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import dcvic, entropy


class CodecReference:
    """The reference model on ``device`` with the benchmark's weights, and
    its CDF tables."""

    def __init__(self, model_config: dict, weights: Dict[str, torch.Tensor], device,
                 quant=None):
        with torch.device(device):
            model = dcvic.DCVIC(model_config)
        model.load_state_dict(weights)
        self.model = model.eval().requires_grad_(False)
        dcvic.set_numerics(self.model, quant)
        self.device = torch.device(device)
        self.selected = (model_config["model"]["selected_beta_rate"],
                         model_config["model"]["selected_beta_vq"])
        eb = {k.split(".")[-1]: v.detach().double().cpu().numpy()
              for k, v in self.model.entropy_model_z.named_parameters()}
        self.z_table = entropy.Table(*entropy.bottleneck_table(eb))
        self.y_table = entropy.Table(*entropy.gaussian_table(dcvic.SCALE_TABLE))
        self.slices = self.model.context_model.slices

    def betas(self, quality: int, B: int):
        t = lambda v: torch.full((B,), float(v), device=self.device)
        return t(self.selected[0][quality]), t(self.selected[1][quality])

    # ---------------------------------------------------------------- encode
    @torch.no_grad()
    def encode(self, images: np.ndarray, quality: int) -> torch.Tensor:
        """The reference's own encode of uint8 NHWC images down to y_hat,
        through its own entropy chain."""
        x = _pad(images)
        block = _block(*x.shape[1:3])
        ys, zs = [], []
        with _plain_numerics():
            for lo in range(0, len(x), block):
                part = dcvic.from_pixels(torch.from_numpy(x[lo:lo + block]).to(self.device))
                y, z, _ = self.model.front(part, *self.betas(quality, len(part)))
                ys.append(y)
                zs.append(z)
        y = torch.cat(ys)
        hyper_out, _ = self.model.hyper_decode(self.model.entropy_model_z.symbols(torch.cat(zs)))
        prev, sc = [], y.shape[1] // self.slices
        for i in range(self.slices):
            mu, _ = self.model.slice_params(i, hyper_out, prev)
            sym = torch.clamp(torch.round(y[:, i * sc:(i + 1) * sc] - mu), -dcvic.SYM_CLIP,
                              dcvic.SYM_CLIP).to(torch.int32)
            prev.append(self.model.slice_reconstruct(i, hyper_out, prev, sym, mu))
        return torch.cat(prev, 1)

    @torch.no_grad()
    def front_gaps(self, images: np.ndarray, quality: int, front) -> Dict[str, float]:
        """The judged encoder followed stage by stage from its own state
        ``front`` = (VQGAN latent, y, z): its latent against the reference's
        VQGAN encoder on the source images; its y against the reference's
        analysis transform given that latent's nearest codewords (the
        reference's own search); its z against the reference's
        hyperencoder on its y. Mean absolute gap over the reference's mean
        magnitude, by the worst image."""
        h_j, y_j, z_j = (t.float() for t in front)
        x = _pad(images)
        block = _block(*x.shape[1:3])
        gaps = {"h_gap": [], "y_gap": [], "z_gap": []}
        rel = lambda a, b: (a - b).abs().flatten(1).mean(1) / b.abs().flatten(1).mean(1)
        with _plain_numerics():
            for lo in range(0, len(x), block):
                hi = min(len(x), lo + block)
                xr = dcvic.from_pixels(torch.from_numpy(x[lo:hi]).to(self.device))
                b1, b2 = self.betas(quality, hi - lo)
                h = self.model.vq_latent(xr)
                q = self.model.vq_model.quantize
                idx = q.indices(h_j[lo:hi].to(self.device))
                y = self.model.comp_encode(xr, q.lookup(idx), idx, b1, b2)
                z = self.model.hyperencoder(y_j[lo:hi].to(self.device)).float()
                gaps["h_gap"].append(rel(h_j[lo:hi].to(self.device), h))
                gaps["y_gap"].append(rel(y_j[lo:hi].to(self.device), y))
                gaps["z_gap"].append(rel(z_j[lo:hi].to(self.device), z))
        return {k: float(torch.cat(v).max()) for k, v in gaps.items()}

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_streams(self, strings: Sequence[Sequence[bytes]], H: int, W: int,
                       quality: int, lanes: int) -> Dict:
        """Decode one batch of streams (as it was encoded together) with the
        reference's entropy chain at that batch. Returns per-image
        ``bad`` flags and the latents."""
        B = len(strings)
        _, _, zH, zW, yH, yW = entropy.geometry(H, W)
        bad = np.zeros(B, bool)
        for b, s in enumerate(strings):
            try:
                h = entropy.parse_header(s[0])
            except ValueError:
                bad[b] = True
                continue
            bad[b] |= not (h["tpu"] and (h["H"], h["W"]) == (H, W) and h["quality"] == quality
                           and h["lanes"] == lanes and h["encode_batch"] == B
                           and not h["portable"])
        zc = self.model.entropy_model_z.ch
        Lz = entropy.section_lanes(zc * zH * zW, lanes)
        zdec = entropy.StreamDecoder([entropy.words_of(s[1]) for s in strings])
        rows = np.broadcast_to(np.arange(zc)[None, :, None, None], (B, zc, zH, zW))
        z_sym = entropy.from_stream(zdec.section(entropy.to_stream(rows, Lz), self.z_table),
                                    zc, zH, zW)
        hyper_out, _ = self.model.hyper_decode(torch.from_numpy(
            np.ascontiguousarray(z_sym)).to(self.device, torch.int32))
        ydec = entropy.StreamDecoder([entropy.words_of(s[2]) for s in strings])
        sc = self.model.context_model.sc
        Ly = entropy.section_lanes(sc * yH * yW, lanes)
        prev = []
        for i in range(self.slices):
            mu, idx = self.model.slice_params(i, hyper_out, prev)
            got = ydec.section(entropy.to_stream(idx.cpu().numpy().astype(np.int64), Ly),
                               self.y_table)
            sym = np.ascontiguousarray(entropy.from_stream(got, sc, yH, yW))
            prev.append(self.model.slice_reconstruct(
                i, hyper_out, prev, torch.from_numpy(sym).to(self.device, torch.int32), mu))
        bad |= ~zdec.exact() | ~ydec.exact()
        return dict(bad=bad, y_hat=torch.cat(prev, 1))

    # ---------------------------------------------------------- reconstruct
    @torch.no_grad()
    def reconstruct(self, y_hat: torch.Tensor, quality: int, H: int, W: int,
                    tokens: Optional[torch.Tensor] = None) -> Dict:
        """uint8 NHWC pixels of y_hat cropped to H x W, the estimator's
        token map and the margin of its best logit over the second; with
        ``tokens`` the pixels are those of that token map."""
        px, idx, margin = [], [], []
        block = _block(y_hat.shape[2] * 16, y_hat.shape[3] * 16)
        with _plain_numerics():
            for lo in range(0, y_hat.shape[0], block):
                part = y_hat[lo:lo + block]
                t = None if tokens is None else tokens[lo:lo + block].to(self.device)
                fake, _, logits, i = self.model.decode_from_y_hat(
                    part, *self.betas(quality, len(part)), tokens=t)
                top2 = torch.topk(logits.float(), 2, dim=1).values
                margin.append((top2[:, 0] - top2[:, 1]).cpu())
                idx.append(torch.argmax(logits, dim=1).cpu())
                px.append(dcvic.to_pixels(fake)[:, :H, :W].cpu().numpy())
        return dict(px=np.concatenate(px), tokens=torch.cat(idx), margin=torch.cat(margin))


def _block(H: int, W: int) -> int:
    """Images per block of the reference's float32 stacks: four of 768 x
    512, more of smaller ones."""
    return max(1, 4 * 768 * 512 // (H * W))


def _pad(images: np.ndarray) -> np.ndarray:
    H, W = images.shape[1:3]
    ph, pw = (-H) % 64, (-W) % 64
    if ph or pw:
        images = np.pad(images, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return np.ascontiguousarray(images)


class _plain_numerics:
    """Float32 products without TF32 for the reference's stacks."""

    def __enter__(self):
        c, m = torch.backends.cudnn, torch.backends.cuda.matmul
        self.before = (c.allow_tf32, m.allow_tf32)
        c.allow_tf32 = m.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.before


# a token whose reference logit leads the next by this much is decided:
# the program's logits lie a few hundredths from the reference's
DECIDED = 1.0


def _tokens(theirs: torch.Tensor, mine: Dict) -> Dict[str, float]:
    """The share of decided positions (``DECIDED``) where the judged token
    map is not the reference estimator's choice, by the worst image."""
    B = len(theirs)
    decided = (mine["margin"] > DECIDED).reshape(B, -1)
    wrong = (theirs.cpu().reshape(B, -1) != mine["tokens"].reshape(B, -1)) & decided
    return {"token_flips": float((wrong.sum(1).float() / decided.sum(1).clamp(min=1)).max())}


def _pixels(a: np.ndarray, b: np.ndarray) -> Dict[str, float]:
    """The RMS gap of two decodes in 8-bit levels, by the worst image."""
    d = a.astype(np.float64) - b.astype(np.float64)
    return {"px_rmse": float(np.sqrt((d * d).reshape(len(a), -1).mean(axis=1)).max())}


def judge_batch(ref: CodecReference, images: np.ndarray, quality: int,
                strings: List[List[bytes]], pixels: np.ndarray, lanes: int, front,
                tokens: torch.Tensor) -> Dict[str, float]:
    """The numbers of one batch that the program encoded and decoded
    together (module docstring). ``front`` and ``tokens`` are the
    program's own state, taken where it was produced: the reference follows
    the program from it, because at the estimator's near-ties rounding alone
    picks a token and the decoder's attention spreads one token's change
    over the image, and because at the served rate the symbols hide the
    front's errors (y is about 0.1 against bins of 1)."""
    H, W = images.shape[1:3]
    dec = ref.decode_streams(strings, H, W, quality, lanes)
    own = ref.reconstruct(dec["y_hat"], quality, H, W, tokens=tokens)
    return {"stream_bad": float(dec["bad"].sum()), **_tokens(tokens, own),
            **_pixels(pixels, own["px"]), **ref.front_gaps(images, quality, front)}


def judge_control(ref: CodecReference, ctrl: CodecReference, images: np.ndarray,
                  quality: int) -> Dict[str, float]:
    """The same numbers for the reference computed at a lower precision
    (``ctrl``) in the program's place: its front stage by stage, its token
    map against the reference estimator's on its own latents, its
    reconstruction against the reference's of the same latents and token
    map. It writes no stream: ``stream_bad`` is not read."""
    H, W = images.shape[1:3]
    y_hat = ctrl.encode(images, quality)
    x = _pad(images)
    parts = []
    with _plain_numerics(), torch.no_grad():
        for lo in range(0, len(x), _block(*x.shape[1:3])):
            hi = min(len(x), lo + _block(*x.shape[1:3]))
            xr = dcvic.from_pixels(torch.from_numpy(x[lo:hi]).to(ctrl.device))
            parts.append(ctrl.model.front_stages(xr, *ctrl.betas(quality, hi - lo)))
    front = tuple(torch.cat([p[i] for p in parts]) for i in range(3))
    c = ctrl.reconstruct(y_hat, quality, H, W)
    r = ref.reconstruct(y_hat, quality, H, W, tokens=c["tokens"])
    return {**_tokens(c["tokens"], r), **_pixels(c["px"], r["px"]),
            **ref.front_gaps(images, quality, front)}

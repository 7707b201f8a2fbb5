"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the environment, builds the CUDA kernels and the host rANS coder.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and times both: K1 vq_argmin, K2 flash attention, K3
   gn_channel_sums, K4 gn_apply, K5 conv3x3_same, K6 conv3x3_gn_swish. The
   conv kernels are also compared on the one-pixel border alone, and K2 to
   K6 are run twice on the same input and must give the same bits.
3. Drives the codec of the flagship model (config/dc_vic_patchgan.yaml,
   full width, random weights from a seed) on its default path: a batch of
   four 768x512 images through Codec.compress -> bitstreams ->
   Codec.decompress in the compressai format with the entropy chain on the
   card (params_backend "accel"), then one 500x740 image. It checks that the decoder's
   y_hat equals the encoder's bitwise, that the decoded images equal the
   reconstruction of the encoder's y_hat, and that the path launched K1 and
   K2.
4. Drives the same batch through a second model with the same weights built
   with recon_kernels = gn, conv3x3, fused_resblock: the same checks, all six
   kernels launched as often as the shape rules say for the modules that
   ran, and the reconstruction held against the default model's. The
   distinct shapes of the K5 and K6 launches of that round trip are printed
   with their counts, and K5 is timed beside F.conv2d at each of its shapes.

5. Holds the tpu stream format's coder kernels, R1 (rANS encode + pack) and
   R2 (decode of one section), against their plain versions on the card and
   against the host coder, at the main path's section shapes (six chained y
   sections of [4, 32, 48, 32] and one z section [4, 192, 12, 8]) for lane
   caps 128 and 512, with symbol mixes without escapes, with tier-1 escapes
   and with tier-2 escapes: equal bytes, symbols, cursors and lane states,
   all lanes back at 2^16 after the last section, equal bits on a second
   run; a stream that breaks a header guarantee must fail the integrity
   check. Integers: no tolerance.
6. Drives the flagship model in the tpu format, host and device encode
   backends (identical strings), lanes 128 and 512, default model and
   reconstruction kernels on: R1 launches twice per compress (y and z), R2
   seven times per decompress (z and six ChARM slices). A batch-4 stream
   decoded as batch 2 must raise, and the decode chain must run under
   torch.cuda.set_sync_debug_mode("error"). Warm encode and decode seconds of both
   formats and Codec.bench_device_cycle are printed.
7. Holds K3 to K6 in bf16 at the path's largest plane, [4, 128, 768, 512]
   (128 output channels), against their plain versions (K4 to K6 within one
   bf16 step), with times, the bf16 bounds (half the bytes; one product per
   multiply over the 989 TFLOP/s dense bf16 rate) and the library calls in
   bf16: F.conv2d for K5, F.silu(F.group_norm(.)) for the pair K3 + K4, K4's
   apply then F.conv2d as K6's unfused route. K5's and K6's bf16 kernels
   (csrc/conv3x3_bf16.cu) repack the weights first; that repack is held to
   its plain version bit for bit. K1 and K2 are also held to
   their plain versions at the deployment batch (M = 98304; [16, 6144, 512]).
8. Drives the deployment configuration: codec_dtype bfloat16,
   entropy_precision default, tpu format, device backend, lanes 512, a batch
   of sixteen 768x512 images (smooth content plus noise, from
   numpy.random.default_rng(0)), encoder weights scaled by 0.55, with the
   reconstruction kernels off and on: compress -> decompress -> bit-exact
   latents and pixels, consumed words checked, launch counts held against the
   shape rules (K1 1, K2 7, R1 2, R2 7), bpp, peak memory and
   Codec.bench_device_cycle printed, the f32 model's device cycle at the same
   batch beside it, and the entropy chain timed with the TF32 allowance on
   and off. The bf16 reconstruction with the kernels on and the one
   with the kernels off, of the same y_hat and codeword indices, are both
   held against the f32 model's: image by image the kernels' route may be at
   most BF16_NOISE_RATIO times as far from it as the default route.
9. Runs the pipelined cycle for three batches (dispatch k + 1, fetch k - 1,
   finalize k, decompress k with the fetch deferred), prints its seconds and
   holds every decoded batch against a plain round trip of the same images.
10. Portable streams of the same configuration: a batch-16 stream decoded as
   16, as 4 x 4 and as 16 x 1, and by another Codec, latents bit-exact in
   every grouping. Pixels are not part of the guarantee (the reconstruction
   runs at the decode batch, and the estimator's argmax turns rounding into
   other codewords): their distance between groupings is printed, and with
   the batch-16 codeword indices fed, a batch-1 reconstruction must be no
   further from the f32 model's than BF16_NOISE_RATIO times the batch-16
   reconstruction's distance. The header's portable bit is set; a non-portable batch-16 stream decoded as batch 4 raises; the
   portable decode chain runs under torch.cuda.set_sync_debug_mode("error").
11. Holds K3 to K6 in bf16 against their plain versions at every distinct
   shape that round trip launched them with, at batch 16, image by image,
   and times K5 and K6 at each of those shapes beside their bound, F.conv2d
   bf16 and (K6) the unfused route.
12. Images over 1024 px and the rest of the Codec surface, on the f32 model
   with the workload's weights: one 2048x1365 image (smooth content plus
   noise, seed 0; it pads to 2048x1408: 35 encode tiles and 35
   reconstruction tiles, 3 chunks of 16 each) round-trips through the tiled
   VQGAN encode and the tiled reconstruction in the tpu format (device
   backend, lanes 512, the decode chain under
   torch.cuda.set_sync_debug_mode("error")) and in the compressai format
   (params_backend "cpu"): latents bit-exact, pixels equal to
   _split_reconstruct of the encoder's y_hat, consumed words checked (the
   tpu stream's latents also through a default compressai Codec, whose
   tpu-format decode runs on the model's own chain), K1
   launched once per compress and K2 as often as the chunks give; encode
   and decode seconds and peak memory printed. The same image with the
   reconstruction kernels on: K3 to K6 at the tile shapes, each shape held
   against the plain version image by image, and one chunk's
   reconstruction against the kernels-off model's. A batch-4 768x512
   compressai stream encoded on the card (params_backend "cpu") decodes
   bit-exactly on a model built on the CPU from the same weights, at
   another thread count; its latents as 4, 2 x 2 and 4 x 1 are printed.
   Quality 2's betas given as betas write quality 2's strings with quality
   0 in the header, and decompress_raw with them gives quality 2's pixels.
   The compress CLI's array function (tools/compress.py) runs on two
   768x512 images with selfcheck and decompress. Last, attention with C = 64
   and a VQ with D = 8 take the plain versions on the card.
13. The training path of the flagship (f32, batch 6 of 256x256 crops of
   synthetic .npy images written from seed 0 to a temporary directory,
   random weights from seed 0 with the encoder x 0.55): (1) one RD step of
   config/exp1_stage1_2.yaml with every kernel that has a plain route off,
   then on, on the same batch, betas, noise and (pinned) VQ targets: every
   parameter main_mask trains, and the quantiles, has a finite gradient, no
   frozen one has any, and each tensor's gradient with the kernels on is
   within GRAD_TOL relative L2 (+1e-7) of the one with them off; the
   launches and the kernel Functions' backwards are held against the shape
   rules. (2) TRAIN_STEPS timed RD steps off and on, a checkpoint; stage 1_3
   (the GAN step, the PatchGAN of its config) boots it with the shipped
   knobs, TRAIN_STEPS GAN steps off and on, a checkpoint; stage 3 boots
   that with its optimizer (schedule reset, Adam's count kept) and its
   discriminator, two steps, one validation on two 768x512 images at the
   four beta corners. The frozen prior stays bit-identical, the GAN stages
   leave the encoder and move the decoder, every loss is finite. (3) Each
   kernel Function at the path's largest shape: its output has a grad_fn
   and its gradients are within GRAD_TOL of autograd of the plain version;
   forward and backward timed with CUDA events. Prints seconds per step,
   images/s, peak memory and launches per step; the kernels line carries
   the training keys (train_*).
14. The evaluation and calibration path on the f32 flagship with the
   workload's weights and every reconstruction kernel on: (1) fifty
   768x512 images (smooth content plus noise, seed 0; fifty is FID's
   minimum) through the compress CLI's body (tools/compress.py
   compress_arrays: tpu format, device backend, lanes 512, batch 16,
   selfcheck and decompress), K1 to K6, R1 and R2 launches held against the
   shape rules; (2) seeded random LPIPS(alex), DISTS and InceptionV3 weights
   (tools/workload.py metric_state_dicts) written to .pth files and loaded
   through the loaders on the card and on the host CPU: LPIPS and DISTS of
   two pairs within METRIC_TOL, the pool3 features of their patches within
   POOL3_RTOL; Inception's patches per second (host clock around the FID
   feature function) and LPIPS's and DISTS's milliseconds per image (CUDA
   events) timed, then calc_metrics over the
   fifty pairs (PSNR, MS-SSIM, LPIPS, DISTS, FID, all finite, none skipped);
   (3) build_val_dataset's crops and token maps of the fifty images, the
   rate search over CALIB_IMAGES crops on both paths (token maps and the
   eval forward) for two beta_vq and two target rates: every target within
   TOL, the two paths' results equal to rtol 1e-5, and each path's probe
   launches held against the shape rules; (4) beta_selection of two of the
   search's candidates over the fifty crops with FID, one selected; (5) a
   stage 1_2 trainer with the LPIPS file as lpips_weights: RD steps timed,
   and the LPIPS loss's forward and backward on the same batch by CUDA
   events, its share of the step. The kernels line
   carries this phase's launches (launches_eval_*).
A Codec constructed and called with the caller's TF32 and cuDNN benchmark
on leaves them so and round-trips bit-exactly (after item 3).

For every kernel it prints the least time the card could take for the same
work: each input read once and each output written once over 3.35 TB/s, or
the operations over the rate of the unit a correct kernel can use, whichever
is larger. For K1, K3 and K4 that unit is the 67 TFLOP/s f32 rate outside the
tensor cores. K2, K5 and K6 need f32-class results from matrix products,
which the tensor cores give as an error-compensated split in three TF32
products: three times the operations over the 495 TFLOP/s dense TF32 rate
(bound_ms); the f32 figure is kept beside it (bound_ffma_ms). A kernel faster
than its bound fails the run: the bound or the timing would be wrong. Where
one PyTorch call computes the same function, that call's time is printed too.
K1 is one launch of a microsecond's arithmetic, so its entry also carries the
launch-to-finish time of an empty kernel (launch_floor_ms) and the larger of
that and the operation bound (bound_with_launch_ms). The bf16 entries
(names ending in _bf16) are bound by bytes or by their operations over the
bf16 rate; their launches are those of the deployment configuration's round
trip with the reconstruction kernels on, which the other entries carry as
launches_bf16_batch16. R1 and R2 are bound by
neither bytes nor operations but by their dependent chain: their entries
carry chain_ms, the steps of the longest chain times the time of one step as
measured with a single warp (batch 1, 32 lanes), where nothing but latency
is left.

Any failure raises and the script exits non-zero. It needs CUDA and fails
without it. The last line is a JSON object naming the device.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _time_ms(fn, *args, reps=10):
    import torch
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16 on the tensor cores


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """(ms, what binds): the larger of bytes over the memory rate and
    operations over the given rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bounds(nbytes, flops, split_tf32=False):
    """The bound keys of a kernel entry. ``split_tf32``: the kernel's
    products can run as three TF32 products each on the tensor cores."""
    ffma_ms, _ = bound(nbytes, flops)
    if split_tf32:
        ms, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    else:
        ms, by = bound(nbytes, flops)
    return {"bound_ms": ms, "bound_by": by, "bound_ffma_ms": ffma_ms}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _border(t):
    """The one-pixel frame of the last two dims, flattened."""
    import torch
    return torch.cat([t[..., 0, :].flatten(), t[..., -1, :].flatten(),
                      t[..., :, 0].flatten(), t[..., :, -1].flatten()])


def check_vq(vq, dev, gen):
    """K1 against its plain version: random rows at the main-path M (batch
    4, where it is timed), a ragged M, exact-tie rows, and the M of the
    deployment configuration's batch of 16."""
    import torch
    worst = 0.0
    near_ties = 0
    cb = torch.randn(256, 4, generator=gen, device=dev) * 0.05
    dup = cb.clone()
    dup[100], dup[255] = dup[7], dup[0]
    cases = [(torch.randn(4 * 96 * 64, 4, generator=gen, device=dev) * 0.05, cb),
             (torch.randn(1037, 4, generator=gen, device=dev) * 0.05, cb),
             (dup.repeat_interleave(8, 0), dup),
             (torch.randn(16 * 96 * 64, 4, generator=gen, device=dev) * 0.05, cb)]
    for z, book in cases:
        got = vq.vq_argmin(z, book)
        want = vq.vq_argmin_plain(z, book)
        dist = (book * book).sum(-1)[None] - 2.0 * (z @ book.t())
        d_got = dist.gather(1, got.long()[:, None])[:, 0]
        d_want = dist.gather(1, want.long()[:, None])[:, 0]
        gap = (d_got - d_want).abs()
        bad = got != want
        tol = 1e-6 * torch.clamp(d_want.abs(), min=1.0)
        if bool((bad & (gap >= tol)).any()):
            raise AssertionError(f"vq_argmin disagrees beyond near-ties at M={z.shape[0]}")
        near_ties += int(bad.sum())
        worst = max(worst, float(gap.max()))
    got = vq.vq_argmin(cases[2][0], dup)
    if int(got[100 * 8]) != 7 or int(got[255 * 8]) != 0:
        raise AssertionError("vq_argmin tie rows must resolve to the lower index")
    print(f"K1 vq_argmin: indices equal to plain except {near_ties} near-tie rows "
          f"(top-two gap < 1e-6*max(1,|d|)); max distance gap {worst:.3e}")
    z = cases[0][0]
    M, D = z.shape
    N = cb.shape[0]
    # per row and codeword: D multiply-adds for the cross term, 2 more flops
    return {"name": "vq_argmin", "route": "cuda",
            "source": "dc_vic_tpu_torch/csrc/vq_argmin.cu",
            "replaces": "dc_vic_tpu/ops/vq.py:21", "max_abs_err": worst,
            "ms": _time_ms(vq.vq_argmin, z, cb),
            "plain_ms": _time_ms(vq.vq_argmin_plain, z, cb),
            **bounds(_nbytes(z, cb) + M * 4, M * N * (2 * D + 2)), "library_ms": None}


ATTENTION_CASES = [((4, 6144, 512), 1.0), ((2, 6144, 512), 1.0), ((1, 1000, 512), 1.0),
                   ((1, 1024, 128), 3.0),
                   ((1, 1037, 512), 1.0),      # N a multiple of no tile
                   ((1, 2048, 512), 0.728),    # scores over about +-60
                   ((16, 6144, 512), 1.0)]     # the deployment configuration's batch


def _attention_float64(q, k, v):
    """softmax(q k^T) v with every step in float64, one image at a time."""
    import torch
    out = torch.empty_like(q)
    lo = hi = 0.0
    for b in range(q.shape[0]):
        s = q[b].double() @ k[b].double().t()
        lo, hi = min(lo, float(s.min())), max(hi, float(s.max()))
        out[b] = (torch.softmax(s, dim=-1) @ v[b].double()).float()
    return out, lo, hi


def check_attention(attention, dev, gen):
    """K2 against its plain version and against the same function in
    float64 (atol = rtol = 1e-4: the summation order differs and the
    products are three TF32 products each), first at the main path's shape
    [4, 6144, 512], where it is also timed, beside
    F.scaled_dot_product_attention on the same f32 operands. A scale other
    than 1 multiplies q and k (instead of q's C^-1/2): 0.728 spreads the
    scores of 512 channels over about +-60, where the running maximum moves
    most and the rescale works hardest; 3.0 at C = 128 spreads them over
    +-500, where an f32 score is only good to 1e-4 and the f32 plain version
    itself leaves the tolerance against float64 on some inputs. So the
    kernel is held to float64 always, and to the plain version wherever the
    plain version is itself within the tolerance of float64; where it is
    not, the line says how far off it is. Each case twice: equal bits."""
    import torch
    import torch.nn.functional as F
    worst = 0.0
    entry = None
    tol = dict(atol=1e-4, rtol=1e-4)
    for (B, N, C), scale in ATTENTION_CASES:
        pre = C ** -0.5 if scale == 1.0 else scale
        q = torch.randn(B, N, C, generator=gen, device=dev) * pre
        k = torch.randn(B, N, C, generator=gen, device=dev) * scale
        v = torch.randn(B, N, C, generator=gen, device=dev)
        got = attention.flash_attention(q, k, v)
        want = attention.attention_plain(q, k, v)
        exact, s_lo, s_hi = _attention_float64(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention gave non-finite values at {(B, N, C)}")
        torch.testing.assert_close(got, exact, **tol)
        err = float((got - want).abs().max())
        plain_off = float((want - exact).abs().max())
        if torch.allclose(want, exact, **tol):
            torch.testing.assert_close(got, want, **tol)
            note = ""
        else:
            note = (f"; the f32 plain version is {plain_off:.3e} from float64, outside the "
                    f"tolerance: held to float64 alone")
        if not torch.equal(got, attention.flash_attention(q, k, v)):
            raise AssertionError(f"flash_attention is not repeatable at {(B, N, C)}")
        print(f"K2 flash_attention [{B},{N},{C}] q,k x{scale}, scores in [{s_lo:.1f}, "
              f"{s_hi:.1f}]: max abs err {err:.3e} to plain, "
              f"{float((got - exact).abs().max()):.3e} to float64; repeatable{note}")
        worst = max(worst, err)
        del exact
        if entry is None:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
            torch.testing.assert_close(lib(), want, atol=1e-4, rtol=1e-4)
            # two products of 2*N*N*C flops per image
            entry = {"ms": _time_ms(attention.flash_attention, q, k, v),
                     "plain_ms": _time_ms(attention.attention_plain, q, k, v),
                     **bounds(_nbytes(q, k, v, got), 4 * B * N * N * C, split_tf32=True),
                     "library_ms": _time_ms(lib)}
    return {"name": "flash_attention", "route": "cuda",
            "source": "dc_vic_tpu_torch/csrc/flash_attn_f32.cu",
            "replaces": "dc_vic_tpu/ops/attention.py:25", "max_abs_err": worst, **entry}


GN_SHAPES = [((4, 128, 768, 512), "float32"), ((4, 256, 384, 256), "float32"),
             ((4, 512, 96, 64), "float32"), ((2, 24, 37, 53), "float32"),
             ((4, 128, 192, 128), "bfloat16")]


def check_gn(gn, dev, gen):
    """K3 and K4 at the main path's planes, a ragged plane and a bf16 plane.
    K3 and its plain version are both held to a float64 sum of the same
    input within 1e-5 of sum|x| (for the sums) and of sum x^2 (for the sums
    of squares): f32 accumulation over up to 393,216 values. K4 is held to
    its plain version at atol = rtol = 1e-6 in f32 (the affine has the
    plain version's bits; the sigmoid may differ in the last place) and
    1e-2 in bf16 (one step of the output type). Both twice: equal bits.
    Timed at [4, 128, 768, 512] f32, the largest plane of the path."""
    import torch
    import torch.nn.functional as F
    k3 = k4 = None
    for shape, dtype_name in GN_SHAPES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        scale = torch.rand(shape[:2], generator=gen, device=dev) * 1.5 + 0.5
        bias = torch.randn(shape[:2], generator=gen, device=dev)
        sums = gn.channel_sums(x)
        plain = gn.channel_sums_plain(x)
        want = torch.empty(shape[0], 2, shape[1], dtype=torch.float64, device=dev)
        ref_scale = torch.empty_like(want)
        for b in range(shape[0]):                     # float64 one image at a time
            xd = x[b].double().flatten(1)
            sq = (xd * xd).sum(-1)
            want[b, 0], want[b, 1] = xd.sum(-1), sq
            ref_scale[b, 0], ref_scale[b, 1] = xd.abs().sum(-1), sq
            del xd
        torch.cuda.synchronize()
        rel = {}
        for name, val in (("kernel", sums), ("plain", plain)):
            rel[name] = float(((val.double() - want).abs() / ref_scale).max())
            if not rel[name] <= 1e-5:
                raise AssertionError(f"gn_channel_sums {name} off float64 by {rel[name]:.2e} "
                                     f"of the scale at {shape}")
        if not torch.equal(sums, gn.channel_sums(x)):
            raise AssertionError(f"gn_channel_sums is not repeatable at {shape}")
        err3 = float((sums - plain).abs().max())
        print(f"K3 gn_channel_sums {list(shape)} {dtype_name}: against float64, in units of "
              f"sum|x| / sum x^2: kernel {rel['kernel']:.2e}, plain {rel['plain']:.2e}; "
              f"max abs diff to plain {err3:.3e}; repeatable")
        err4 = 0.0
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        for act in (None, "swish"):
            got = gn.apply_affine(x, scale, bias, act)
            ref = gn.apply_affine_plain(x, scale, bias, act)
            torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
            if not torch.equal(got, gn.apply_affine(x, scale, bias, act)):
                raise AssertionError(f"gn_apply is not repeatable at {shape}")
            err4 = max(err4, float((got.float() - ref.float()).abs().max()))
            del got, ref
        print(f"K4 gn_apply {list(shape)} {dtype_name}: max abs err {err4:.3e} "
              f"(act none and swish, tolerance {tol:g}); repeatable")
        if k3 is None:
            n = x.numel()
            b3 = bounds(_nbytes(x, sums), 3 * n)                # add, multiply-add
            b4 = bounds(2 * _nbytes(x) + _nbytes(scale, bias), 6 * n)
            k3 = {"name": "gn_channel_sums", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/gn.cu",
                  "replaces": "dc_vic_tpu/ops/gn.py:52", "max_abs_err": err3,
                  "ms": _time_ms(gn.channel_sums, x),
                  "plain_ms": _time_ms(gn.channel_sums_plain, x),
                  **b3, "library_ms": None}
            k4 = {"name": "gn_apply", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/gn.cu",
                  "replaces": "dc_vic_tpu/ops/gn.py:117", "max_abs_err": err4,
                  "ms": _time_ms(gn.apply_affine, x, scale, bias, "swish"),
                  "plain_ms": _time_ms(gn.apply_affine_plain, x, scale, bias, "swish"),
                  **b4, "library_ms": None}
            # no single PyTorch call computes K3's or K4's function; the pair
            # (GroupNorm + swish) is F.group_norm then F.silu
            gamma = torch.rand(shape[1], generator=gen, device=dev) + 0.5
            beta = torch.randn(shape[1], generator=gen, device=dev) * 0.1
            pair = lambda: gn.group_norm(x, gamma, beta, 32, 1e-6, "swish")
            lib = lambda: F.silu(F.group_norm(x, 32, gamma, beta, 1e-6))
            torch.testing.assert_close(pair(), lib(), atol=2e-5, rtol=2e-5)
            print(f"K3+K4 as GroupNorm+swish at {list(shape)}: {_time_ms(pair):.3f} ms; "
                  f"F.silu(F.group_norm(.)) {_time_ms(lib):.3f} ms (2e-5 apart at most)")
        del x, sums, plain, want, ref_scale
    print(f"K3 at {list(GN_SHAPES[0][0])}: kernel {k3['ms']:.3f} ms, plain "
          f"{k3['plain_ms']:.3f} ms, bound {k3['bound_ms']:.3f} ms ({k3['bound_by']})")
    print(f"K4 at {list(GN_SHAPES[0][0])}: kernel {k4['ms']:.3f} ms, plain "
          f"{k4['plain_ms']:.3f} ms, bound {k4['bound_ms']:.3f} ms ({k4['bound_by']})")
    return k3, k4


CONV_SHAPES = [((4, 128, 128, 768, 512), "float32"), ((4, 256, 256, 384, 256), "float32"),
               ((4, 256, 128, 192, 128), "float32"), ((2, 128, 64, 13, 37), "float32"),
               ((4, 128, 128, 192, 128), "bfloat16"),
               ((4, 512, 512, 192, 128), "float32")]    # the path's deepest reduction


def check_conv(conv3x3, dev, gen):
    """K5 and K6 (with and without the residual) at four planes of the main
    path, an odd-sized plane whose tiles are ragged, and a bf16 plane,
    against their plain versions (F.conv2d with TF32 off): atol = rtol =
    1e-4 in f32 (another summation order over up to 4608 taps, each product
    three TF32 products), 1e-2 in bf16
    (one step of the output type: kernel and plain version both round an f32
    sum once), over the whole tensor and over the one-pixel
    border alone. K6's affine has a bias near 2, so a halo that was not
    zeroed after the swish would show in the border. Each twice: equal
    bits. Timed at every f32 plane; the first is the one reported."""
    import torch
    import torch.nn.functional as F
    k5 = k6 = None
    for (B, C, Cout, H, W), dtype_name in CONV_SHAPES:
        dtype = getattr(torch, dtype_name)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        x = torch.randn(B, C, H, W, generator=gen, device=dev).to(dtype)
        w = (torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
        scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
        bias = torch.randn(B, C, generator=gen, device=dev) + 2.0
        cbias = torch.randn(Cout, generator=gen, device=dev)
        res = torch.randn(B, Cout, H, W, generator=gen, device=dev).to(dtype)
        label = f"[{B},{C},{H},{W}]->{Cout} {dtype_name}"
        cases = [("K5 conv3x3_same", lambda: conv3x3.conv3x3_same(x, w),
                  lambda: conv3x3.conv3x3_same_plain(x, w)),
                 ("K6 conv3x3_gn_swish", lambda: conv3x3.conv3x3_gn_swish(
                     x, w, scale, bias, cbias, None),
                  lambda: conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, None)),
                 ("K6 conv3x3_gn_swish +res", lambda: conv3x3.conv3x3_gn_swish(
                     x, w, scale, bias, cbias, res),
                  lambda: conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res))]
        errs, times = [], []
        for name, kernel, plain in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            whole = float((got.float() - want.float()).abs().max())
            edge = float((_border(got).float() - _border(want).float()).abs().max())
            torch.testing.assert_close(_border(got), _border(want), atol=tol, rtol=tol)
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
            if not torch.equal(got, kernel()):
                raise AssertionError(f"{name} is not repeatable at {label}")
            del got, want
            line = (f"{name} {label}: max abs err {whole:.3e} whole, {edge:.3e} border "
                    f"(tolerance {tol:g}); repeatable")
            if dtype == torch.float32 and H * W > 1000:
                times.append((_time_ms(kernel, reps=3), _time_ms(plain, reps=3)))
                line += f"; kernel {times[-1][0]:.3f} ms, plain {times[-1][1]:.3f} ms"
            print(line)
            errs.append(max(whole, edge))
        if k5 is None:
            flops = 2 * 9 * C * Cout * B * H * W
            b5 = bounds(_nbytes(x, w) + _nbytes(res), flops, split_tf32=True)
            # K6 also reads the residual, scale, bias and the conv bias; the
            # affine and swish add about 6 flops per input element
            b6 = bounds(_nbytes(x, w, scale, bias, cbias, res) + _nbytes(res),
                        flops + 6 * x.numel() + 2 * res.numel(), split_tf32=True)
            k5 = {"name": "conv3x3_same", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/conv3x3.cu",
                  "replaces": "dc_vic_tpu/ops/conv3x3.py:59", "max_abs_err": errs[0],
                  "ms": times[0][0], "plain_ms": times[0][1], **b5,
                  "library_ms": _time_ms(lambda: F.conv2d(x, w, padding=1), reps=3)}
            k6 = {"name": "conv3x3_gn_swish", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/conv3x3.cu",
                  "replaces": "dc_vic_tpu/ops/conv3x3.py:220",
                  "max_abs_err": max(errs[1:]), "ms": times[2][0],
                  "plain_ms": times[2][1], **b6, "library_ms": None}
        del x, w, res
    for k in (k5, k6):
        print(f"{k['name']} at [4,128,768,512]->128: kernel {k['ms']:.3f} ms, plain "
              f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms ({k['bound_by']}, "
              f"3xTF32; {k['bound_ffma_ms']:.3f} ms at the f32 rate), "
              f"library {k['library_ms']}")
    return k5, k6


def time_conv_shapes(conv3x3, shapes, dev, gen):
    """K5 beside F.conv2d (TF32 off) at each distinct shape the main path
    launched it with: one printed line per shape, with its launch count."""
    import torch
    import torch.nn.functional as F
    rows = []
    for (B, C, Cout, H, W), count in sorted(shapes.items()):
        x = torch.randn(B, C, H, W, generator=gen, device=dev)
        w = torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05
        ms = _time_ms(conv3x3.conv3x3_same, x, w, reps=3)
        lib = _time_ms(lambda: F.conv2d(x, w, padding=1), reps=3)
        rows.append({"shape": [B, C, Cout, H, W], "launches": count, "ms": ms,
                     "library_ms": lib})
        print(f"K5 at [{B},{C},{H},{W}]->{Cout}: {count} launches per round trip, kernel "
              f"{ms:.3f} ms, F.conv2d {lib:.3f} ms")
        del x, w
    return rows


def launch_floor_ms(native):
    """Launch-to-finish time of an empty kernel, by the same CUDA-event
    method as every other time here."""
    import torch
    lib = native.kernels()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        native.check(lib.dcvic_launch_floor(1, 32, stream), "launch_floor")
    return _time_ms(launch, reps=200)


Y_PLANES = (4, 192, 48, 32)     # y of four 768x512 images: six sections of 32 channels
Z_PLANES = (4, 192, 12, 8)      # z of the same: one section, CDF row = channel
RANS_MIXES = ("no escapes", "tier-1 escapes", "tier-2 escapes")


def _rans_planes(rng, table, shape, mix, factorised):
    """Symbol and index planes on the host: each symbol drawn inside its
    row's range; then 2% of them up to +-20000 (one tier-1 word each), then
    0.5% of them up to +-40000 (payloads past 0xFFFF: two tier-2 words)."""
    B, C, H, W = shape
    rows = len(table.offsets)
    if factorised:
        idx = np.broadcast_to(np.arange(C).reshape(1, C, 1, 1), shape)
    else:
        idx = rng.integers(0, rows, shape)
    maxv = (np.asarray(table.cdf_lengths) - 2)[idx]
    width = np.maximum(maxv // 6, 1)
    centre = maxv // 2
    value = np.clip(np.round(centre + rng.normal(0, 1, shape) * width), 0, maxv - 1)
    sym = (value + np.asarray(table.offsets)[idx]).astype(np.int32)
    if mix != "no escapes":
        hot = rng.random(shape) < 0.02
        sym = np.where(hot, rng.integers(-20000, 20000, shape), sym)
    if mix == "tier-2 escapes":
        hot = rng.random(shape) < 0.005
        sym = np.where(hot, rng.integers(-40000, 40000, shape), sym)
        sym[0, 0, 0, 1], sym[-1, -1, -1, -2] = 40000, -40000
    return sym.astype(np.int32), (None if factorised else idx.astype(np.uint8))


def _rans_case(rd, rans_host, dev, host_table, table, shape, S, lanes, mix, rng, label,
               factorised=False):
    """One stream per image through R1 and R2 and through everything they
    are held against. Returns (sym, idx, packed words, base, counts) on the
    card for the timings."""
    import torch
    B, C, H, W = shape
    sc = C // S
    sym_np, idx_np = _rans_planes(rng, host_table, shape, mix, factorised)
    wide = mix == "tier-2 escapes"          # +-40000 does not fit the model's int16 planes
    sym = torch.from_numpy(sym_np if wide else sym_np.astype(np.int16)).to(dev)
    idx = None if idx_np is None else torch.from_numpy(idx_np).to(dev)
    L = rd.section_lanes(sc * H * W, lanes)

    packed, offsets, counts, esc, big = rd.encode_pack(sym, idx, S, lanes, table)
    again = rd.encode_pack(sym, idx, S, lanes, table)
    torch.cuda.synchronize()
    rows = rd.channel_rows(B, C, H, W, dev) if idx is None else idx
    sections = [(rd.to_stream(sym[:, s * sc:(s + 1) * sc], L),
                 rd.to_stream(rows[:, s * sc:(s + 1) * sc], L)) for s in range(S)]
    vals, mask, p_esc, p_big = rd.encode_stream_plain(sections, table)
    p_packed, p_counts = rd.pack_streams_plain(vals, mask)
    if not (torch.equal(counts, p_counts) and torch.equal(esc, p_esc)
            and torch.equal(big, p_big)):
        raise AssertionError(f"{label}: R1 counts differ from the plain version")
    if not (torch.equal(again[2], counts) and all(
            torch.equal(again[0][int(o):int(o) + int(n)], packed[int(o):int(o) + int(n)])
            for o, n in zip(offsets, counts))):
        raise AssertionError(f"{label}: R1 is not repeatable")
    counts_np = counts.cpu().numpy()
    p_base = np.cumsum(counts_np) - counts_np
    words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
    if not torch.equal(words, p_packed[:words.numel()]):
        raise AssertionError(f"{label}: R1 bytes differ from the plain version")
    words_np = words.cpu().numpy().view(np.uint16)
    for b in range(B):
        secs = [(s[b].cpu().numpy(), i[b].cpu().numpy()) for s, i in sections]
        data, esc_max, has_t2 = rans_host.tpu_encode_sections(secs, host_table, True)
        if data != words_np[p_base[b]:p_base[b] + counts_np[b]].tobytes():
            raise AssertionError(f"{label}: R1 bytes differ from the host coder, image {b}")
        if esc_max != int(esc[b].max()) or has_t2 != bool(big[b] > 0):
            raise AssertionError(f"{label}: R1 escape counts differ from the host coder")
    if bool(esc.sum() > 0) != (mix != "no escapes") or bool(big.sum() > 0) != wide:
        raise AssertionError(f"{label}: the symbol mix is not what its name says")

    base = torch.from_numpy(p_base.astype(np.int32)).to(dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    runs = []
    for _ in range(2):
        cur, state, p_cur, p_state, outs = zero, None, zero, None, []
        for s in range(S):
            sec_idx = None if idx is None else idx[:, s * sc:(s + 1) * sc].contiguous()
            got, cur, state = rd.decode_section(words, base, cur, state, sec_idx,
                                                (B, sc, H, W), lanes, table,
                                                out_dtype=torch.int32)
            want, p_cur, p_state = rd.decode_section_plain(
                words, base, p_cur, p_state, sections[s][1], table)
            if not (torch.equal(got, rd.from_stream(want, sc, H, W))
                    and torch.equal(cur, p_cur) and torch.equal(state, p_state)):
                raise AssertionError(f"{label}: R2 differs from the plain version, section {s}")
            if not torch.equal(got, sym[:, s * sc:(s + 1) * sc].to(torch.int32)):
                raise AssertionError(f"{label}: R2 does not return the symbols, section {s}")
            outs.append(got)
        if not torch.equal(cur, counts) or not bool((state == rd.RANS_L).all()):
            raise AssertionError(f"{label}: the last section leaves words or lane states over")
        runs.append(outs)
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{label}: R2 is not repeatable")
    print(f"{label}: R1 bytes equal to plain and host coder ({int(counts.sum())} words, "
          f"{int(esc.sum())} escapes, {int(big.sum())} tier-2), R2 symbols, cursors and "
          f"states equal to plain over {S} sections, lanes back at 2^16; repeatable")
    return sym, idx, words, base, counts


def _rans_poison_cases(rd, Codec, dev, host_table, table):
    """A stream that breaks what the flag promises must fail the integrity
    check; without the flag the same stream passes it."""
    import torch
    B, C, H, W = 2, 32, 48, 32
    rng = np.random.default_rng(7)
    cases = {"escfree": ("tier-1 escapes", dict(escfree=True)),
             "t2free": ("tier-2 escapes", dict(tier2=False)),
             "esc_cap": (None, dict(sparse_esc=True))}
    for name, (mix, flags) in cases.items():
        if mix is None:
            sym_np, idx_np = _rans_planes(rng, host_table, (B, C, H, W), "no escapes", False)
            sym_np[1] = rng.integers(3000, 9000, sym_np[1].shape)    # every symbol escapes
        else:
            sym_np, idx_np = _rans_planes(rng, host_table, (B, C, H, W), mix, False)
        sym, idx = torch.from_numpy(sym_np).to(dev), torch.from_numpy(idx_np).to(dev)
        packed, offsets, counts, _, _ = rd.encode_pack(sym, idx, 1, 128, table)
        words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
        base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        strs = [b"\0\0" * int(n) for n in counts]
        _, cur, _ = rd.decode_section(words, base, zero, None, idx, (B, C, H, W), 128, table)
        Codec._check_consumed(torch.stack([cur, cur]).cpu().numpy(), strs, strs)
        _, cur, _ = rd.decode_section(words, base, zero, None, idx, (B, C, H, W), 128, table,
                                      **flags)
        try:
            Codec._check_consumed(torch.stack([cur, cur]).cpu().numpy(), strs, strs)
        except RuntimeError:
            continue
        raise AssertionError(f"R2 did not poison the cursor of a stream that breaks {name}")
    print("R2 poison: a stream with an escape under escfree, with a tier-2 marker under "
          "t2free, and with more escapes than esc_cap each fail the integrity check")


def check_rans(rd, rans_host, Codec, dev):
    """R1 and R2 against their plain versions and the host coder (see the
    module docstring, item 5), then their times at the main path's y
    shapes, lanes 128: R1 over the whole six-section stream, R2 over one
    section. Returns the two kernel entries."""
    import torch
    from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck, build_bottleneck_cdf
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional, get_scale_table
    from dc_vic_tpu_torch.models import init_weights
    y_host = GaussianConditional().build_cdf_table(get_scale_table())
    eb = EntropyBottleneck(Z_PLANES[1])
    init_weights(eb, torch.Generator().manual_seed(1))
    z_host = build_bottleneck_cdf(eb)
    y_table, z_table = rd.DeviceCdfTable(y_host, dev), rd.DeviceCdfTable(z_host, dev)
    rng = np.random.default_rng(1)
    kept = {}
    for lanes in (128, 512):
        for mix in RANS_MIXES:
            kept[lanes, mix] = _rans_case(
                rd, rans_host, dev, y_host, y_table, Y_PLANES, 6, lanes, mix, rng,
                f"R1/R2 y {list(Y_PLANES)} six sections, lanes {lanes}, {mix}")
        _rans_case(rd, rans_host, dev, z_host, z_table, Z_PLANES, 1, lanes, "tier-1 escapes",
                   rng, f"R1/R2 z {list(Z_PLANES)}, lanes {lanes}, tier-1 escapes",
                   factorised=True)
    _rans_case(rd, rans_host, dev, y_host, y_table, (2, 12, 6, 8), 3, 4, "tier-1 escapes", rng,
               "R1/R2 a small stream, three sections, lanes 4, tier-1 escapes")
    _rans_case(rd, rans_host, dev, y_host, y_table, (1, 64, 96, 128), 1, 4096,
               "tier-1 escapes", rng, "R1/R2 one wide section, lanes 4096, tier-1 escapes")
    _rans_poison_cases(rd, Codec, dev, y_host, y_table)

    B, C, H, W = Y_PLANES
    S, sc = 6, C // 6
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    timed = {}
    for lanes in (128, 512):
        sym, idx, words, base, counts = kept[lanes, "no escapes"]
        L = rd.section_lanes(sc * H * W, lanes)
        idx0 = idx[:, :sc].contiguous()
        sections = [(rd.to_stream(sym[:, s * sc:(s + 1) * sc], L),
                     rd.to_stream(idx[:, s * sc:(s + 1) * sc], L)) for s in range(S)]
        timed[lanes] = dict(
            L=L, steps=sc * H * W // L, words=int(counts.sum()),
            r1=_time_ms(rd.encode_pack, sym, idx, S, lanes, y_table),
            r2=_time_ms(rd.decode_section, words, base, zero, None, idx0, (B, sc, H, W),
                        lanes, y_table),
            r1_plain=_time_ms(lambda: rd.pack_streams_plain(
                *rd.encode_stream_plain(sections, y_table)[:2]), reps=1),
            r2_plain=_time_ms(rd.decode_section_plain, words, base, zero, None,
                              sections[0][1], y_table, reps=1))
    # one step's latency: a single warp (batch 1, 32 lanes) leaves nothing else
    sym1, idx1 = kept[128, "no escapes"][0][:1].contiguous(), kept[128, "no escapes"][1][:1].contiguous()
    p1, o1, c1, _, _ = rd.encode_pack(sym1, idx1, S, 32, y_table)
    w1 = p1[:int(c1[0])].contiguous()
    one_steps = sc * H * W // 32
    z1 = torch.zeros(1, dtype=torch.int32, device=dev)
    r1_step = _time_ms(rd.encode_pack, sym1, idx1, S, 32, y_table) / (S * one_steps)
    r2_step = _time_ms(rd.decode_section, w1, z1, z1, None, idx1[:, :sc].contiguous(),
                       (1, sc, H, W), 32, y_table) / one_steps
    for lanes, t in timed.items():
        print(f"R1 rans_encode_pack y {list(Y_PLANES)} lanes {lanes} ({S * t['steps']} steps): "
              f"kernel {t['r1']:.4f} ms, plain {t['r1_plain']:.1f} ms; R2 rans_decode_section "
              f"one section ({t['steps']} steps): kernel {t['r2']:.4f} ms, plain "
              f"{t['r2_plain']:.1f} ms")
    print(f"one step of the chain with a single warp: R1 {r1_step * 1e3:.3f} us, "
          f"R2 {r2_step * 1e3:.3f} us")
    t = timed[128]
    n_sym = B * C * H * W
    # bytes: each symbol (2) and index (1) read once, each word written (R1)
    # or read (R2) once, R2's symbols written; operations: about 12 integer
    # operations a symbol, held against the f32 rate outside the tensor cores
    r1 = {"name": "rans_encode_pack", "route": "cuda",
          "source": "dc_vic_tpu_torch/csrc/rans_device.cu",
          "replaces": "dc_vic_tpu/ops/rans_device.py:222", "max_abs_err": 0.0,
          "ms": t["r1"], "plain_ms": t["r1_plain"],
          **bounds(3 * n_sym + 2 * t["words"], 12 * n_sym), "library_ms": None,
          "chain_ms": S * t["steps"] * r1_step, "ms_lanes512": timed[512]["r1"]}
    r2 = {"name": "rans_decode_section", "route": "cuda",
          "source": "dc_vic_tpu_torch/csrc/rans_device.cu",
          "replaces": "dc_vic_tpu/ops/rans_device.py:366", "max_abs_err": 0.0,
          "ms": t["r2"], "plain_ms": t["r2_plain"],
          **bounds((3 * n_sym + 2 * t["words"]) // S, 12 * n_sym // S), "library_ms": None,
          "chain_ms": t["steps"] * r2_step, "ms_lanes512": timed[512]["r2"]}
    return r1, r2


BF16_PLANE = (4, 128, 768, 512)     # the largest plane of the path; 128 output channels


def check_bf16_kernels(gn, conv3x3, dev, gen):
    """K3 to K6 in bf16 at the path's largest plane against their plain
    versions: K3 within 1e-5 of sum|x| and sum x^2 against float64 (f32
    sums of bf16 values), K4, K5 and K6 atol = rtol = 1e-2 (one step of the
    output type: K5's and K6's plain versions, like the kernels, round an f32
    sum once), whole tensor and border; each twice: equal bits. The bf16
    kernels' weight repack equals its plain version bit for bit. Times, bf16
    bounds, and the library calls in bf16; K6 also beside its unfused route
    (K4's apply with swish, then F.conv2d bf16 with the conv bias, then the
    residual add). Returns the four entries."""
    import torch
    import torch.nn.functional as F
    B, C, H, W = BF16_PLANE
    Cout = C
    bf = torch.bfloat16
    x = (torch.randn(B, C, H, W, generator=gen, device=dev) * 2 + 0.5).to(bf)
    scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
    bias = torch.randn(B, C, generator=gen, device=dev)
    label = f"{list(BF16_PLANE)} bfloat16"

    sums, plain = gn.channel_sums(x), gn.channel_sums_plain(x)
    want = torch.empty(B, 2, C, dtype=torch.float64, device=dev)
    ref_scale = torch.empty_like(want)
    for b in range(B):
        xd = x[b].double().flatten(1)
        sq = (xd * xd).sum(-1)
        want[b, 0], want[b, 1] = xd.sum(-1), sq
        ref_scale[b, 0], ref_scale[b, 1] = xd.abs().sum(-1), sq
        del xd
    rel = float(((sums.double() - want).abs() / ref_scale).max())
    if not rel <= 1e-5 or not torch.equal(sums, gn.channel_sums(x)):
        raise AssertionError(f"gn_channel_sums bf16: {rel:.2e} of the scale off float64, "
                             f"or not repeatable, at {label}")
    err3 = float((sums - plain).abs().max())
    print(f"K3 gn_channel_sums {label}: {rel:.2e} of sum|x| / sum x^2 off float64; max abs "
          f"diff to plain {err3:.3e}; repeatable")
    err4 = 0.0
    for act in (None, "swish"):
        got, ref = gn.apply_affine(x, scale, bias, act), gn.apply_affine_plain(x, scale, bias, act)
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)
        if not torch.equal(got, gn.apply_affine(x, scale, bias, act)):
            raise AssertionError(f"gn_apply bf16 is not repeatable at {label}")
        err4 = max(err4, float((got.float() - ref.float()).abs().max()))
        del got, ref
    print(f"K4 gn_apply {label}: max abs err {err4:.3e} (act none and swish, tolerance "
          f"0.01); repeatable")
    n = x.numel()
    b3, _ = bound(_nbytes(x, sums), 3 * n)
    b4, _ = bound(2 * _nbytes(x) + _nbytes(scale, bias), 6 * n)
    common = {"route": "cuda", "library_ms": None, "dtype": "bfloat16",
              "shape": list(BF16_PLANE)}
    k3 = {"name": "gn_channel_sums_bf16", "source": "dc_vic_tpu_torch/csrc/gn.cu",
          "replaces": "dc_vic_tpu/ops/gn.py:52", "max_abs_err": err3,
          "ms": _time_ms(gn.channel_sums, x), "plain_ms": _time_ms(gn.channel_sums_plain, x),
          "bound_ms": b3, "bound_by": "bytes", **common}
    k4 = {"name": "gn_apply_bf16", "source": "dc_vic_tpu_torch/csrc/gn.cu",
          "replaces": "dc_vic_tpu/ops/gn.py:117", "max_abs_err": err4,
          "ms": _time_ms(gn.apply_affine, x, scale, bias, "swish"),
          "plain_ms": _time_ms(gn.apply_affine_plain, x, scale, bias, "swish"),
          "bound_ms": b4, "bound_by": "bytes", **common}
    gamma = torch.rand(C, generator=gen, device=dev) + 0.5
    beta = torch.randn(C, generator=gen, device=dev) * 0.1
    pair = lambda: gn.group_norm(x, gamma, beta, 32, 1e-6, "swish")
    lib = lambda: F.silu(F.group_norm(x, 32, gamma.to(bf), beta.to(bf), 1e-6))
    torch.testing.assert_close(pair(), lib(), atol=5e-2, rtol=5e-2)
    pair_ms, lib_ms = _time_ms(pair), _time_ms(lib)
    k3["pair_ms"], k3["pair_library_ms"] = pair_ms, lib_ms
    print(f"K3+K4 as GroupNorm+swish at {label}: {pair_ms:.3f} ms; F.silu(F.group_norm(.)) in "
          f"bf16 {lib_ms:.3f} ms (0.05 apart at most: the library rounds to bf16 twice)")

    x = torch.randn(B, C, H, W, generator=gen, device=dev).to(bf)
    w = (torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05).to(bf)
    bias = torch.randn(B, C, generator=gen, device=dev) + 2.0
    cbias = torch.randn(Cout, generator=gen, device=dev)
    res = torch.randn(B, Cout, H, W, generator=gen, device=dev).to(bf)
    if not torch.equal(conv3x3.repack_weights_bf16(w), conv3x3.repack_weights_bf16_plain(w)):
        raise AssertionError(f"the bf16 weight repack differs from its plain version at "
                             f"{list(w.shape)}")
    print(f"bf16 weight repack {list(w.shape)}: equal to its plain version bit for bit")
    cases = [("K5 conv3x3_same", lambda: conv3x3.conv3x3_same(x, w),
              lambda: conv3x3.conv3x3_same_plain(x, w)),
             ("K6 conv3x3_gn_swish +res", lambda: conv3x3.conv3x3_gn_swish(
                 x, w, scale, bias, cbias, res),
              lambda: conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res))]
    out = []
    for name, kernel, plain_fn in cases:
        got, ref = kernel(), plain_fn()
        torch.testing.assert_close(_border(got), _border(ref), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)
        if not torch.equal(got, kernel()):
            raise AssertionError(f"{name} bf16 is not repeatable at {label}")
        err = float((got.float() - ref.float()).abs().max())
        del got, ref
        ms, plain_ms = _time_ms(kernel, reps=5), _time_ms(plain_fn, reps=5)
        print(f"{name} {label}->{Cout}: max abs err {err:.3e} (tolerance 0.01, whole and "
              f"border); repeatable; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        out.append((err, ms, plain_ms))
    flops = 2 * 9 * C * Cout * B * H * W
    b5, by5 = bound(_nbytes(x, w) + _nbytes(res), flops, BF16_FLOPS_PER_S)
    b6, by6 = bound(_nbytes(x, w, scale, bias, cbias, res) + _nbytes(res),
                    flops + 6 * x.numel() + 2 * res.numel(), BF16_FLOPS_PER_S)
    k5 = {"name": "conv3x3_same_bf16", "source": "dc_vic_tpu_torch/csrc/conv3x3_bf16.cu",
          "replaces": "dc_vic_tpu/ops/conv3x3.py:59", "max_abs_err": out[0][0],
          "ms": out[0][1], "plain_ms": out[0][2], "bound_ms": b5, "bound_by": by5,
          **common, "library_ms": _time_ms(lambda: F.conv2d(x, w, padding=1), reps=5)}
    k6 = {"name": "conv3x3_gn_swish_bf16", "source": "dc_vic_tpu_torch/csrc/conv3x3_bf16.cu",
          "replaces": "dc_vic_tpu/ops/conv3x3.py:220", "max_abs_err": out[1][0],
          "ms": out[1][1], "plain_ms": out[1][2], "bound_ms": b6, "bound_by": by6, **common,
          "unfused_ms": _time_ms(_unfused_k6(gn, x, w, scale, bias, cbias, res), reps=5)}
    for k in (k3, k4, k5, k6):
        unfused = f", unfused route {k['unfused_ms']:.3f} ms" if "unfused_ms" in k else ""
        print(f"{k['name']} at {label}: kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}), library {k['library_ms']}"
              f"{unfused}")
    return k3, k4, k5, k6


def _unfused_k6(gn, x, w, scale, bias, cbias, res):
    """K6's function as the unfused route computes it: K4's apply with
    swish, F.conv2d with the conv bias, then the residual add, in x's type."""
    import torch.nn.functional as F

    def run():
        y = F.conv2d(gn.apply_affine(x, scale, bias, "swish"), w, cbias.to(x.dtype), padding=1)
        return y if res is None else y + res
    return run


def _held_per_image(got, plain_one, tol, what):
    """``got`` [B, ...] of one launch over the whole batch against
    ``plain_one(b)`` [1, ...], the plain version of image b alone, whole and
    border, atol = rtol = ``tol``. Returns the largest absolute error."""
    import torch
    worst = 0.0
    for b in range(got.shape[0]):
        ref = plain_one(b)[0]
        try:
            torch.testing.assert_close(_border(got[b]), _border(ref), atol=tol, rtol=tol)
            torch.testing.assert_close(got[b], ref, atol=tol, rtol=tol)
        except AssertionError as e:
            raise AssertionError(f"{what}, image {b} of the batch: {e}") from None
        worst = max(worst, float((got[b].float() - ref.float()).abs().max()))
    return worst


def _repeatable(kernel, first, what):
    import torch
    if not torch.equal(first, kernel()):
        raise AssertionError(f"{what} is not repeatable")


# (K4, K5 and K6) tolerances of a kernel against its plain version, by dtype:
# one step of bf16 (kernel and plain version each round an f32 value once);
# in f32 the affine's last place and another summation order of three TF32
# products per product
PATH_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-6, 1e-4)}


def check_path_shapes(gn, conv3x3, shapes, dev, gen, dtype_name="bfloat16"):
    """K3 to K6 in ``dtype_name`` at every distinct shape a round trip
    launched them with (``shapes`` as expected_launch_recorder tallied them:
    the deployment configuration's batch 16, or the tiles of an image over
    1024 px). The kernel takes the whole batch in one launch; its plain
    version takes one image at a time, so the reference never forms a batch
    offset and an index that wraps beyond the first images (a [16, 256, 768,
    512] plane has 1.6 G elements) shows as a mismatch in the later ones.
    Tolerances: K3 1e-5 of sum|x| and sum x^2 against float64, K4 and K5/K6
    (with and without the residual) PATH_TOL, whole and border; each launch
    twice: equal bits. In bf16 K5 and K6 (without the residual) are also
    timed at each shape beside their bf16 bound, F.conv2d bf16 of the same
    shape and, for K6, its unfused route (K4's apply, then F.conv2d with the
    conv bias); the rows are returned."""
    import torch
    import torch.nn.functional as F
    dtype = getattr(torch, dtype_name)
    rows = []
    tol4, tol_conv = PATH_TOL[dtype_name]
    for (B, C, H, W), count in sorted(shapes["gn"].items()):
        label = f"[{B},{C},{H},{W}] {dtype_name} ({count} launches per round trip)"
        x = torch.randn(B, C, H, W, generator=gen, device=dev, dtype=dtype) * 2 + 0.5
        scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
        bias = torch.randn(B, C, generator=gen, device=dev)
        sums = gn.channel_sums(x)
        rel = 0.0
        for b in range(B):
            xd = x[b].double().flatten(1)
            sq = (xd * xd).sum(-1)
            off = torch.stack([(sums[b, 0].double() - xd.sum(-1)).abs() / xd.abs().sum(-1),
                               (sums[b, 1].double() - sq).abs() / sq])
            rel = max(rel, float(off.max()))
            del xd, sq
        if not rel <= 1e-5:
            raise AssertionError(f"gn_channel_sums off float64 by {rel:.2e} of the scale "
                                 f"at {label}")
        _repeatable(lambda: gn.channel_sums(x), sums, f"gn_channel_sums at {label}")
        got = gn.apply_affine(x, scale, bias, "swish")
        err4 = _held_per_image(got, lambda b: gn.apply_affine_plain(
            x[b:b + 1], scale[b:b + 1], bias[b:b + 1], "swish"), tol4, f"gn_apply at {label}")
        _repeatable(lambda: gn.apply_affine(x, scale, bias, "swish"), got,
                    f"gn_apply at {label}")
        print(f"K3, K4 at {label}: sums {rel:.2e} of the scale off float64; apply max abs "
              f"err {err4:.3e} to plain (tolerance {tol4:g}); every image; repeatable")
        del x, got, sums
    for name in ("conv3x3_same", "conv3x3_gn_swish"):
        for (B, C, Cout, H, W), count in sorted(shapes[name].items()):
            label = f"[{B},{C},{H},{W}]->{Cout} {dtype_name} ({count} launches per round trip)"
            x = torch.randn(B, C, H, W, generator=gen, device=dev, dtype=dtype)
            w = (torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
            if name == "conv3x3_same":
                scale = bias = cbias = None
                cases = [("K5 conv3x3_same", lambda: conv3x3.conv3x3_same(x, w),
                          lambda b: conv3x3.conv3x3_same_plain(x[b:b + 1], w))]
            else:
                scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
                bias = torch.randn(B, C, generator=gen, device=dev) + 2.0
                cbias = torch.randn(Cout, generator=gen, device=dev)
                res = torch.randn(B, Cout, H, W, generator=gen, device=dev, dtype=dtype)
                cases = [(f"K6 conv3x3_gn_swish{'' if r is None else ' +res'}",
                          lambda r=r: conv3x3.conv3x3_gn_swish(x, w, scale, bias, cbias, r),
                          lambda b, r=r: conv3x3.conv3x3_gn_swish_plain(
                              x[b:b + 1], w, scale[b:b + 1], bias[b:b + 1], cbias,
                              None if r is None else r[b:b + 1]))
                         for r in (None, res)]
            for what, kernel, plain_one in cases:
                got = kernel()
                err = _held_per_image(got, plain_one, tol_conv, f"{what} at {label}")
                _repeatable(kernel, got, f"{what} at {label}")
                print(f"{what} at {label}: max abs err {err:.3e} to plain (atol = rtol = "
                      f"{tol_conv:g}, whole and border, every image); repeatable")
                del got
            if dtype == torch.bfloat16:
                rows.append(_time_path_shape(gn, name, cases[0][1], x, w, scale, bias, cbias,
                                             label))
            del x, w, cases
            scale = bias = cbias = res = None
            torch.cuda.empty_cache()
    return rows


def _time_path_shape(gn, name, kernel, x, w, scale, bias, cbias, label):
    """One bf16 K5 or K6 (no residual) launch shape of the path: the
    kernel's time, its bound, F.conv2d bf16 and, for K6, the unfused route."""
    import torch.nn.functional as F
    B, C, H, W = x.shape
    Cout = w.shape[0]
    flops = 2 * 9 * C * Cout * B * H * W
    nbytes = _nbytes(x, w) + B * Cout * H * W * x.element_size()
    if name == "conv3x3_gn_swish":
        nbytes += _nbytes(scale, bias, cbias)
        flops += 6 * x.numel() + B * Cout * H * W
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    row = {"name": f"{name}_bf16", "shape": [B, C, Cout, H, W], "ms": _time_ms(kernel, reps=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _time_ms(lambda: F.conv2d(x, w, padding=1), reps=3)}
    line = (f"{name} bf16 at {label}: kernel {row['ms']:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}, {bound_ms / row['ms']:.0%} of it), F.conv2d bf16 "
            f"{row['library_ms']:.3f} ms")
    if name == "conv3x3_gn_swish":
        row["unfused_ms"] = _time_ms(_unfused_k6(gn, x, w, scale, bias, cbias, None), reps=3)
        line += f", unfused route (K4 apply + F.conv2d) {row['unfused_ms']:.3f} ms"
    print(line)
    return row


def pipelined_cycle(codec, images, n_batches=3):
    """The serving loop: per cycle k dispatch batch k + 1's encode, fetch
    batch k - 1's decoded images, finalize batch k's streams and dispatch its
    decode with the fetch deferred. Returns the cycles' seconds (the drain of
    the last fetch folded into the last) and checks every decoded batch
    against a plain round trip of the same images."""
    import torch
    batches = [np.ascontiguousarray(np.roll(images, i, axis=0)) for i in range(n_batches)]
    want = [codec.decompress([r["string_list"] for r in codec.compress(b, 0)])
            for b in batches]
    torch.cuda.synchronize()
    handle = codec.compress_dispatch(batches[0], 0)
    pending, outs, cycles = None, [], []
    for k in range(n_batches):
        t0 = time.perf_counter()
        nxt = codec.compress_dispatch(batches[k + 1], 0) if k + 1 < n_batches else None
        if pending is not None:
            outs.append(pending.fetch())
        res = codec.compress_finalize(handle)
        pending = codec.decompress([r["string_list"] for r in res], defer_fetch=True)
        handle = nxt
        cycles.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs.append(pending.fetch())
    cycles[-1] += time.perf_counter() - t0
    for k in range(n_batches):
        if not np.array_equal(outs[k], want[k]):
            raise AssertionError(f"the pipelined cycle decoded batch {k} to other pixels than "
                                 f"a plain round trip of the same images")
    return cycles


def entropy_chain_ms(codec, images):
    """The entropy-parameter chain of one encode (hyper_decode, slice
    parameters, six decode steps, batch as given) with the module's
    entropy_precision as built and with "high", on the same y and z symbols:
    (ms as built, ms with "high")."""
    import torch
    m = codec.module
    x = torch.from_numpy(np.ascontiguousarray(images)).to(codec.device)
    with torch.no_grad():
        y, z_sym = m.encode_front(x.permute(0, 3, 1, 2), *codec._betas(0))
        built = m.entropy_precision
        out = []
        for precision in (built, "high"):
            m.entropy_precision = precision
            out.append(_time_ms(codec._encode_param_chain, y, z_sym, reps=5))
        m.entropy_precision = built
    return tuple(out)


def check_portable(spec, fresh_spec, plain_codec, plain_strings, images, parts16, ref):
    """Portable streams of the deployment configuration (module docstring,
    item 10). ``fresh_spec``: a second model built from the same weights,
    for the decoder that never saw the encoder. ``plain_codec`` /
    ``plain_strings``: the non-portable codec of ``spec`` and its batch-16
    streams. ``parts16``, ``ref``: what bf16_against_f32 returned for
    ``spec``'s model."""
    import torch
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.tools.workload import DEPLOYMENT
    B, H, W = images.shape[:3]
    codec = Codec(spec, encode_backend="device", lanes=DEPLOYMENT["lanes"], portable=True)
    res = codec.compress(images, 0, debug=True)
    strings = [r["string_list"] for r in res]
    hdr = HeaderHandler.decode(strings[0][0])
    if not (hdr["portable"] and hdr["bf16"] and hdr["fast_entropy"]
            and hdr["lanes"] == DEPLOYMENT["lanes"] and hdr["encode_batch"] == B):
        raise AssertionError(f"portable header {hdr}")
    fresh = Codec(fresh_spec, lanes=128)     # built non-portable: the header decides
    whole = codec.decompress(strings)
    if not np.array_equal(fresh.decompress(strings), whole):
        raise AssertionError("another codec decoded the same batch to other pixels")
    differing = {}
    for name, size in (("16", B), ("4 x 4", 4), ("16 x 1", 1)):
        for dec in (codec, fresh):
            for lo in range(0, B, size):
                if not dec.verify_roundtrip(res[lo:lo + size], strings[lo:lo + size], (H, W)):
                    raise AssertionError(f"portable stream decoded as {name}: latents differ "
                                         f"from the encoder's (images {lo}..{lo + size - 1})")
        parts = np.concatenate([codec.decompress(strings[lo:lo + size])
                                for lo in range(0, B, size)])
        diff = np.abs(parts.astype(np.int16) - whole.astype(np.int16))
        differing[name] = (float((diff > 1).mean()), float(diff.mean()))
    if differing["16"] != (0.0, 0.0):
        raise AssertionError("decoding the same batch twice gave other pixels")
    # where the groupings' pixels part: the VQ estimator, in the batch of 16
    # and alone, on the same y_hat. With the batch's estimator indices fed to
    # the batch-1 reconstruction, what is left is rounding: for the first, a
    # middle and the last image it must be within BF16_NOISE_RATIO of the
    # batch-16 reconstruction's distance to the f32 model's
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2))).to(codec.device)
    b1, b2 = codec._betas(0)
    logits16, idx16, img16 = parts16
    flips = gap = spread = 0.0
    fed = []
    with torch.no_grad():
        for b in (0, B // 2, B - 1):
            one = slice(b, b + 1)
            logits1, idx1, img1 = recon_parts(codec.module, y_hat[one].clone(), b1, b2,
                                              indices=idx16[one].clone())
            flips = max(flips, float((idx16[one] != idx1).float().mean()))
            gap = max(gap, float((logits16[one].float() - logits1.float()).abs().max()))
            spread = float(logits1.float().std())
            fed.append((b, float(_per_image_mean(img1, ref[one])),
                        float(_per_image_mean(img16[one], ref[one])),
                        float(_per_image_mean(img1, img16[one])) * 127.5))
    del y_hat, logits1, img1
    for b, e1, e16, _ in fed:
        if not e1 <= BF16_NOISE_RATIO * e16:
            raise AssertionError(f"image {b} reconstructed alone with the batch-16 codeword "
                                 f"indices is {e1:.5f} from the f32 model's, the batch-16 "
                                 f"reconstruction {e16:.5f}: more than rounding explains")
    print(f"portable, batch {B} lanes {DEPLOYMENT['lanes']}: header {hdr}; decoded as 16, 4 x 4 "
          f"and 16 x 1 by the encoding codec and by another one: y_hat and z_hat equal the "
          f"encoder's bitwise in every grouping, and the same grouping gives the same pixels. "
          f"Pixels against the batch-16 decode (share over one step apart, mean steps apart): "
          + "; ".join(f"{k}: {a:.4f}, {b:.3f}" for k, (a, b) in differing.items())
          + " (the reconstruction is not part of the guarantee: it runs at the decode batch, "
            "another batch picks other bf16 kernels, and with random weights the estimator's "
            "argmax turns such differences into other codewords: for images 0, "
            f"{B // 2} and {B - 1} the estimator's logits differ by at most {gap:.3e} between "
            f"batch 16 and batch 1, against a spread of {spread:.3e}, and up to {flips:.4f} of "
            f"an image's indices differ; with the batch-16 indices fed to the batch-1 "
            f"reconstruction, (image, its mean distance to the f32 model's reconstruction "
            f"on the [-1, 1] scale, the batch-16 reconstruction's, mean uint8 steps between "
            f"the two): {[(b, round(a, 5), round(c, 5), round(d, 3)) for b, a, c, d in fed]}, "
            f"ratio allowed {BF16_NOISE_RATIO:g})")
    try:
        plain_codec.decompress(plain_strings[:4])
    except ValueError as e:
        print(f"a non-portable batch-16 stream decoded as batch 4 raises: {str(e)[:80]}...")
    else:
        raise AssertionError("a non-portable batch-16 stream decoded as batch 4 did not raise")
    try:
        codec.decompress([strings[0], plain_strings[1]])
    except ValueError as e:
        print(f"a portable and a non-portable stream in one batch raise: {str(e)[:60]}...")
    else:
        raise AssertionError("mixed portable and non-portable streams did not raise")
    pipeline = codec._decode_pipeline
    seen = []

    def no_sync(*args, **kwargs):
        seen.append(kwargs.get("portable"))
        torch.cuda.set_sync_debug_mode("error")
        try:
            return pipeline(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    codec._decode_pipeline = no_sync
    again = codec.decompress(strings)
    codec._decode_pipeline = pipeline
    if seen != [True] or not np.array_equal(again, whole):
        raise AssertionError("the portable decode chain did not run, or is not repeatable")
    print("portable: the decode chain (16 per-image parameter chains, 7 batched section "
          "decodes) ran with torch.cuda.set_sync_debug_mode('error') and gave the same pixels")
    return codec, float(np.mean([r["bpp"] for r in res]))


def drive(codec, images):
    """The main path: compress -> bitstreams -> decompress. Returns
    (results, decoded images, encode s, decode s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codec.compress(images, 0, debug=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = codec.decompress([r["string_list"] for r in res])
    torch.cuda.synchronize()
    return res, out, t1 - t0, time.perf_counter() - t1


def verify(codec, images, res, out, enc_s, dec_s, label):
    """The decoder's y_hat equals the encoder's bitwise, and the decoded
    images are the reconstruction of the encoder's y_hat. Returns y_hat on
    the device."""
    import torch
    B, H, W = images.shape[:3]
    if out.shape != (B, H, W, 3) or out.dtype != np.uint8:
        raise AssertionError(f"{label}: decoded {out.shape} {out.dtype}")
    y_hat = np.stack([r["y_hat"] for r in res])
    if not np.isfinite(y_hat).all():
        raise AssertionError(f"{label}: non-finite y_hat")
    if not codec.verify_roundtrip(res, [r["string_list"] for r in res], (H, W)):
        raise AssertionError(f"{label}: decode-side y_hat differs from the encoder's")
    y_hat = torch.from_numpy(np.ascontiguousarray(y_hat.transpose(0, 3, 1, 2))).to(codec.device)
    b1, b2 = codec._betas(0)
    with torch.no_grad():
        recon = codec.module.reconstruct_uint8(y_hat, b1, b2)
        recon = recon[:, :, :H, :W].permute(0, 2, 3, 1).cpu().numpy()
    if not np.array_equal(out, recon):
        raise AssertionError(f"{label}: decoded images differ from reconstruct_uint8(y_hat)")
    bpp = float(np.mean([r["bpp"] for r in res]))
    print(f"{label}: y_hat round trip bit-exact, decoded images equal "
          f"reconstruct_uint8(y_hat), {bpp:.4f} bpp, encode {enc_s:.3f} s, "
          f"decode {dec_s:.3f} s")
    return y_hat


def counters(vq, attention, gn, conv3x3, rans_device):
    return {"vq_argmin": vq.launches, "flash_attention": attention.launches,
            **gn.launches, **conv3x3.launches, **rans_device.launches}


def reset_counters(vq, attention, gn, conv3x3, rans_device):
    vq.launches = 0
    attention.launches = 0
    for table in (gn.launches, conv3x3.launches, rans_device.launches):
        for name in table:
            table[name] = 0


def expected_launch_recorder(module):
    """Forward hooks that apply the shape rules to the shapes the modules
    are really called with: the launches the rules give for this run,
    counted apart from the wrappers' own counters. A module inside a block
    that took the fused route is never called, so it counts nothing."""
    import torch
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock, VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import Conv2d, GroupNorm
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn, vq
    want = {"vq_argmin": 0, "flash_attention": 0, "gn_channel_sums": 0, "gn_apply": 0,
            "conv3x3_same": 0, "conv3x3_gn_swish": 0}
    # (B, C, Cout, H, W) -> launches of the two conv kernels, (B, C, H, W) ->
    # launches of the GroupNorm pair
    shapes = {"conv3x3_same": {}, "conv3x3_gn_swish": {}, "gn": {}}

    def tally(kernel, key):
        shapes[kernel][key] = shapes[kernel].get(key, 0) + 1

    def hook(m, args):
        shape = tuple(args[0].shape)
        if isinstance(m, VQAttnBlock):                 # f32 tokens whatever the conv dtype
            B, C, H, W = shape
            want["flash_attention"] += attention.use_kernel((B, H * W, C), torch.float32)
        elif isinstance(m, GroupNorm):
            if m.recon_kernel and gn.use_kernel(shape):
                want["gn_channel_sums"] += 1
                want["gn_apply"] += 1
                tally("gn", shape)
        elif isinstance(m, Conv2d):
            B, C, H, W = shape
            if (m.recon_kernel and m.kernel_size == (3, 3) and m.stride == (1, 1)
                    and conv3x3.use_kernel(B, C, m.out_channels, H, W)):
                want["conv3x3_same"] += 1
                tally("conv3x3_same", (B, C, m.out_channels, H, W))
        elif isinstance(m, VQResnetBlock):
            B, C, H, W = shape
            if m.fused and conv3x3.use_kernel(B, C, m.conv1.out_channels, H, W):
                want["conv3x3_gn_swish"] += 2
                Cout = m.conv1.out_channels
                tally("conv3x3_gn_swish", (B, C, Cout, H, W))       # conv1
                tally("conv3x3_gn_swish", (B, Cout, Cout, H, W))    # conv2
        else:                                          # the quantizer, on an f32 latent
            N, D = m.embedding.weight.shape
            want["vq_argmin"] += vq.use_kernel(D, N, torch.float32)

    kinds = (VQAttnBlock, GroupNorm, Conv2d, VQResnetBlock)
    handles = [m.register_forward_pre_hook(hook) for m in module.modules()
               if isinstance(m, kinds) or m is module.vq_model.quantize]
    return want, shapes, handles


def counted_round_trip(codec, images, label, ops):
    """The main path with every launch counter set to 0 just before it and
    read just after, held against what the shape rules give for the modules
    that ran in between; then the checks of what came out. Returns (y_hat,
    launches, the conv kernels' launch shapes)."""
    want, shapes, handles = expected_launch_recorder(codec.module)
    # the coder kernels: y and z pack per compress on the device backend, z
    # and one section per ChARM slice per decompress
    tpu = codec.stream_format == "tpu"
    want["rans_encode_pack"] = 2 if tpu and codec.encode_backend == "device" else 0
    want["rans_decode_section"] = 1 + codec.num_slices if tpu else 0
    reset_counters(*ops)
    res, out, enc_s, dec_s = drive(codec, images)
    launches = counters(*ops)
    for h in handles:
        h.remove()
    print(f"{label}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, the shape rules "
                             f"give {want}")
    return verify(codec, images, res, out, enc_s, dec_s, label), launches, shapes


def recon_parts(module, y_hat, b1, b2, indices=None):
    """decode_from_y_hat step by step: (logits, indices, image in [-1, 1]).
    With ``indices`` given, the VQGAN decoder is fed those instead of the
    estimator's own argmax."""
    feat, cond = module.decoder.get_feats(y_hat, b1, b2)
    _, logits = module.vq_estimator(feat)
    own = logits.argmax(1)
    idx = own if indices is None else indices
    latent = module.vq_model.post_quant_conv(module.vq_model.quantize.lookup(idx))
    image = module.vq_model.decoder(latent, module.fusion_module.fusion_modules, cond, 1.0)
    return logits, own, image.float()


RECON_TOL = 1e-3   # [-1, 1] scale; about a tenth of one uint8 step (2 / 255)


def compare_models(default, recon, images, y_hat):
    """The model with the reconstruction kernels on against the default
    model, same weights, same inputs. Decode side: the float reconstruction
    of the same y_hat, with the VQGAN decoder of both fed the default
    model's estimator indices (an argmax that flips on a near-tie would
    swap a codeword and say nothing about the kernels; flips are counted
    and printed). Encode side: how many VQ indices differ (printed only)."""
    import torch
    from dc_vic_tpu_torch.models.dc_vic import to_model_range
    compare_recon(default, recon, y_hat)
    with torch.no_grad():
        x = to_model_range(torch.from_numpy(images).to(default.device).permute(0, 3, 1, 2))
        _, vq0 = default.module.vq_encode(x)
        _, vq1 = recon.module.vq_encode(x)
        print(f"encode side: {int((vq0 != vq1).sum())} of {vq0.numel()} VQ indices differ "
              f"between the two models")


def compare_recon(default, recon, y_hat):
    """The decode side of compare_models: the float reconstructions of the
    same y_hat by both models, the VQGAN decoders fed the default model's
    estimator indices, within RECON_TOL."""
    import torch
    b1, b2 = default._betas(0)
    with torch.no_grad():
        logits0, idx0, img0 = recon_parts(default.module, y_hat, b1, b2)
        logits1, idx1, img1 = recon_parts(recon.module, y_hat, b1, b2, indices=idx0)
        diff = (img1 - img0).abs()
        flips = int((idx1 != idx0).sum())
        print(f"reconstruction kernels on vs default, same y_hat: image max abs diff "
              f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e} on the [-1, 1] "
              f"scale (tolerance {RECON_TOL:g}); estimator logits max abs diff "
              f"{float((logits1 - logits0).abs().max()):.3e}; {flips} of {idx0.numel()} "
              f"estimator indices differ")
        if not torch.isfinite(img1).all() or float(diff.max()) > RECON_TOL:
            raise AssertionError("the reconstruction with the kernels on is too far "
                                 "from the default model's")


# Two bf16 reconstructions of one y_hat and one set of codeword indices differ
# by rounding alone (every layer rounds to 8 bits, each route in its own
# order), which random weights carry to the pixels: no fixed tolerance says
# how far. The f32 model's reconstruction of the same inputs does: per image,
# a bf16 route may be at most this many times as far from it (mean absolute
# difference) as the bf16 default model at batch 16 is (measured: 0.99 to
# 1.01 for every image and route, all about 0.014 on the [-1, 1] scale).
BF16_NOISE_RATIO = 1.25


def _per_image_mean(a, b):
    return (a - b).abs().flatten(1).mean(1)


def bf16_against_f32(f32, off, on, y_hat):
    """The bf16 reconstruction with the kernels on, with the kernels off and
    the f32 model's, all of the same y_hat at batch 16 and all fed the
    codeword indices of the bf16 default model's estimator. Image by image
    the kernels' route must be within BF16_NOISE_RATIO of the default
    route's distance to the f32 reconstruction: a kernel that mixed up one
    image's planes would be off by the image's own scale. Returns the
    default route's (logits, indices, image) and the f32 image."""
    import torch
    with torch.no_grad():
        logits, idx, img_off = recon_parts(off.module, y_hat, *off._betas(0))
        _, own, img_on = recon_parts(on.module, y_hat, *on._betas(0), indices=idx)
        _, _, ref = recon_parts(f32.module, y_hat, *f32._betas(0), indices=idx)
    e_off, e_on = _per_image_mean(img_off, ref), _per_image_mean(img_on, ref)
    apart = _per_image_mean(img_on, img_off)
    print(f"bf16 reconstructions of one y_hat and one set of codeword indices, batch "
          f"{y_hat.shape[0]}, mean absolute distance per image on the [-1, 1] scale: kernels "
          f"off to the f32 model's {[round(float(v), 5) for v in e_off]}, kernels on to the "
          f"f32 model's {[round(float(v), 5) for v in e_on]}, on to off "
          f"{[round(float(v), 5) for v in apart]}; the largest ratio on / off is "
          f"{float((e_on / e_off).max()):.3f} (allowed {BF16_NOISE_RATIO:g}); "
          f"{int((own != idx).sum())} of {idx.numel()} estimator indices differ between the "
          f"two bf16 models")
    if not torch.isfinite(img_on).all() or bool((e_on > BF16_NOISE_RATIO * e_off).any()):
        raise AssertionError("the bf16 reconstruction with the kernels on is further from the "
                             "f32 model's than rounding explains")
    return (logits, idx, img_off), ref


TILED_SIZE = (2048, 1365)   # a CLIC-2020 professional photograph; pads to 2048 x 1408


def tile_chunks(codec, H, W):
    """(encode tiles, reconstruction tiles, encode chunks, reconstruction
    chunks) of one H x W image on the split paths."""
    from dc_vic_tpu_torch.codec.tiling import (DEC_STRIDE_Y, DEC_WINDOW_Y, ENC_STRIDE,
                                               ENC_WINDOW, tile_starts)
    pH, pW = -(-H // 64) * 64, -(-W // 64) * 64
    n_enc = len(tile_starts(pH, ENC_WINDOW, ENC_STRIDE)) * len(tile_starts(pW, ENC_WINDOW,
                                                                           ENC_STRIDE))
    n_dec = len(tile_starts(pH // 16, DEC_WINDOW_Y, DEC_STRIDE_Y)) * len(
        tile_starts(pW // 16, DEC_WINDOW_Y, DEC_STRIDE_Y))
    c = codec._TILE_CHUNK
    return n_enc, n_dec, -(-n_enc // c), -(-n_dec // c)


def tiled_round_trip(codec, images, ops, label):
    """The main path on an image over 1024 px, counted as counted_round_trip
    counts (counters set to 0 just before, read just after, held against
    the shape rules for the modules that ran), with the tpu format's decode
    chain under torch.cuda.set_sync_debug_mode("error"). Then: latents
    bit-exact, the decoded image equal to _split_reconstruct of the
    encoder's y_hat (the consumed words were checked by the fetch). Returns
    (results, decoded images, launches, launch shapes, y_hat on the card)."""
    import torch
    want, shapes, handles = expected_launch_recorder(codec.module)
    tpu = codec.stream_format == "tpu"
    want["rans_encode_pack"] = 2 if tpu and codec.encode_backend == "device" else 0
    want["rans_decode_section"] = 1 + codec.num_slices if tpu else 0
    pipeline = codec._decode_pipeline

    def no_sync(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return pipeline(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    codec._decode_pipeline = no_sync
    reset_counters(*ops)
    try:
        res, out, _, _ = drive(codec, images)
    finally:
        codec._decode_pipeline = pipeline
        for h in handles:
            h.remove()
    launches = counters(*ops)
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, the shape rules give {want}")
    B, H, W = images.shape[:3]
    if out.shape != (B, H, W, 3) or not codec.verify_roundtrip(
            res, [r["string_list"] for r in res], (H, W)):
        raise AssertionError(f"{label}: decoded {out.shape}, or the decoder's latents differ "
                             f"from the encoder's")
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2))).to(codec.device)
    with torch.no_grad():
        recon = codec._split_reconstruct(y_hat, *codec._betas(0))
    if not np.array_equal(out, recon[:, :, :H, :W].permute(0, 2, 3, 1).cpu().numpy()):
        raise AssertionError(f"{label}: decoded images differ from _split_reconstruct(y_hat)")
    print(f"{label}: launches {launches}; y_hat and z_hat round trip bit-exact, decoded image "
          f"equals _split_reconstruct(y_hat), consumed words checked"
          f"{', decode chain under set_sync_debug_mode(error)' if tpu else ''}")
    return res, out, launches, shapes, y_hat


def timed_round_trip(codec, images):
    """One warm round trip on the host clock: (encode s, decode s, peak
    memory GiB, bpp)."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, _, enc, dec = drive(codec, images)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return enc, dec, peak, float(np.mean([r["bpp"] for r in res]))


def check_cpu_decoder(opt, sd, codec, images):
    """A compressai stream encoded on the card with the entropy chain on the
    CPU (params_backend "cpu") decodes to the encoder's latents on a model
    built on the CPU from the same weights, at another thread count; the
    latents of the card's decoder as 4, 2 x 2 and 4 x 1 are printed."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model
    B, H, W = images.shape[:3]
    res = codec.compress(images, 0, debug=True)
    strings = [r["string_list"] for r in res]
    cpu_spec = build_comp_model(opt, device="cpu")
    cpu_spec.module.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
    cpu_codec = Codec(cpu_spec, stream_format="compressai")
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2 - 1))
    try:
        t0 = time.perf_counter()
        same = cpu_codec.verify_roundtrip(res, strings, (H, W))
        cpu_s = time.perf_counter() - t0
        cpu_threads = torch.get_num_threads()
    finally:
        torch.set_num_threads(threads)
    if not same:
        raise AssertionError("a card-encoded params_backend='cpu' stream did not decode to the "
                             "encoder's latents on a CPU-built model")
    groups = {}
    for name, size in (("4", 4), ("2 x 2", 2), ("4 x 1", 1)):
        groups[name] = all(codec.verify_roundtrip(res[lo:lo + size], strings[lo:lo + size],
                                                  (H, W)) for lo in range(0, B, size))
    if not groups["4"]:
        raise AssertionError("the card's decoder with the CPU chain disagrees with its encoder")
    print(f"params_backend cpu, compressai, batch {B} {H}x{W} encoded on the card: a model "
          f"built on the CPU decodes y_hat and z_hat bitwise equal to the encoder's "
          f"({cpu_threads} threads against the encoder's {threads}; {cpu_s:.2f} s for the "
          f"latents on the CPU); the card's decoder as 4, 2 x 2, 4 x 1 gives the encoder's "
          f"latents: {groups}")
    return groups


def check_betas(codec, images):
    """Quality 2's betas given as betas write quality 2's z and y strings
    with quality 0 in the header; decompress_raw with those betas gives
    quality 2's pixels."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    H, W = images.shape[1:3]
    br, bv = codec.spec.quality_betas(2)
    by_q = codec.compress(images, 2)
    by_b = codec.compress(images, beta_rate=br, beta_vq=bv)
    heads = [HeaderHandler.decode(r["string_list"][0]) for r in by_b]
    if any(q["string_list"][1:] != b["string_list"][1:] for q, b in zip(by_q, by_b)) or any(
            h["quality_ind"] != 0 for h in heads) or any(
            HeaderHandler.decode(r["string_list"][0])["quality_ind"] != 2 for r in by_q):
        raise AssertionError("betas given as betas wrote other strings or headers than the "
                             "quality level they equal")
    raw = codec.decompress_raw(
        [r["string_list"][1] for r in by_b], [r["string_list"][2] for r in by_b], (H, W), br, bv,
        stream_format=heads[0]["stream_format"], lanes=heads[0]["lanes"],
        esc_dense=any(h["esc_dense"] for h in heads), t2free=all(h["t2free"] for h in heads),
        escfree=all(h["escfree"] for h in heads))
    if not np.array_equal(raw, codec.decompress([r["string_list"] for r in by_q])):
        raise AssertionError("decompress_raw at quality 2's betas gave other pixels")
    print(f"custom betas ({br}, {bv}) = quality 2: the same z and y strings, quality 0 in the "
          f"header; decompress_raw with them gives quality 2's pixels")


def check_cli(images):
    """The compress CLI's body (tools/compress.py: compress_arrays, with
    selfcheck and decompress) on the flagship built as the CLI builds it,
    into a temporary directory."""
    import tempfile
    from dc_vic_tpu_torch.codec.container import load_byte_strings
    from dc_vic_tpu_torch.tools import compress as cli
    codec = cli.build_codec(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    named = [(f"photo{i}.png", a) for i, a in enumerate(images)]
    with tempfile.TemporaryDirectory() as tmp:
        rows, decoded = cli.compress_arrays(codec, named, 0, tmp, batch_size=2, selfcheck=True,
                                            decompress=True)
        files = sorted(os.listdir(tmp))
        again = codec.decompress([load_byte_strings(os.path.join(tmp, f"photo{i}.bin"))
                                  for i in range(len(images))])
    if (files != ["_avg_bitrate.json", "_bitrates.csv"] + [f"photo{i}.bin"
                                                           for i in range(len(images))]
            or [r["img_name"] for r in rows] != [n for n, _ in named]
            or not np.array_equal(np.stack([decoded[n] for n, _ in named]), again)):
        raise AssertionError(f"the CLI's outputs: {files}, {rows}")
    print(f"CLI compress_arrays, 2 images {images.shape[1]}x{images.shape[2]}, batch 2, tpu "
          f"format, portable, selfcheck and decompress: files {files}; "
          f"{[round(r['real_bpp'], 4) for r in rows]} bpp, pred "
          f"{[round(r['pred_bpp'], 4) for r in rows]}")


def check_codec_scope(codec, images):
    """A Codec leaves the process's backend settings as it found them, at
    construction and around its calls, and its round trip stays bit-exact
    whatever they are (the opposite of its own, here). The check's own
    reference reconstruction runs with the codec's settings: under the
    caller's TF32 it would be another computation."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    before, theirs = flags(), (True, True, False, True)
    try:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = theirs
        c = Codec(codec.spec, stream_format="compressai", params_backend="accel")
        after_init = flags()
        trip = drive(c, images)
        if (after_init, flags()) != (theirs, theirs):
            raise AssertionError(f"Codec changed the backend settings: {theirs} -> "
                                 f"{after_init} -> {flags()}")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = before
    verify(c, images, *trip, "compressai format, driven with the caller's TF32 and cuDNN "
           "benchmark on, batch 1 500x740")
    print("Codec: construction and calls leave TF32 and the cuDNN flags as the caller set "
          "them; the round trip stays bit-exact with the caller's TF32 on")


def check_predicates(attention, vq, dev, gen):
    """Outside their rules K1 and K2 take the plain versions on the card
    and do not raise: attention with C = 64, and with bf16 operands; a VQ
    of D = 8."""
    import torch
    before = (attention.launches, vq.launches)
    q, k, v = (torch.randn(2, 300, 64, generator=gen, device=dev) for _ in range(3))
    cases = [("attention C=64", attention.flash_attention(q, k, v),
              attention.attention_plain(q, k, v)),
             ("attention bf16", attention.flash_attention(q.bfloat16(), k.bfloat16(),
                                                          v.bfloat16()),
              attention.attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16()))]
    z, cb = torch.randn(1000, 8, generator=gen, device=dev), torch.randn(256, 8, generator=gen,
                                                                        device=dev)
    cases.append(("vq D=8", vq.vq_argmin(z, cb), vq.vq_argmin_plain(z, cb)))
    for name, got, want in cases:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not the plain version")
    if (attention.launches, vq.launches) != before:
        raise AssertionError("a shape outside the kernels' rules launched a kernel")
    print("K1/K2 outside their rules on the card: attention with C = 64 and with bf16 "
          "operands, VQ with D = 8 take the plain versions (equal bits, no launch)")


def check_tiled(opt, sd, ops, smi, dev, gen):
    """Item 12 of the module docstring. ``sd``: the f32 weights of the
    workload. Returns the launches of the tiled round trip with the
    reconstruction kernels on."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn, vq
    from dc_vic_tpu_torch.tools.workload import smooth_images
    t_phase = time.perf_counter()
    H, W = TILED_SIZE
    image = smooth_images(1, H, W)
    spec = build_comp_model(opt)
    spec.module.load_state_dict(sd, strict=True)
    tpu = Codec(spec, encode_backend="device", lanes=512)
    n_enc, n_dec, c_enc, c_dec = tile_chunks(tpu, H, W)
    vqm = spec.module.vq_model
    per_enc = sum(isinstance(m, VQAttnBlock) for m in vqm.encoder.modules())
    per_dec = sum(isinstance(m, VQAttnBlock) for m in vqm.decoder.modules())
    want_k2 = c_enc * per_enc + c_dec * per_dec
    print(f"tiled path, 1 image {H}x{W}: {n_enc} encode tiles in {c_enc} chunks, {n_dec} "
          f"reconstruction tiles in {c_dec} chunks of {tpu._TILE_CHUNK}; K2 launches "
          f"{c_enc} x {per_enc} + {c_dec} x {per_dec} = {want_k2}")
    times = {}
    for fmt, codec in (("tpu", tpu), ("compressai", Codec(spec, stream_format="compressai"))):
        label = (f"tiled {H}x{W}, f32, {fmt} format"
                 + (", device backend, lanes 512" if fmt == "tpu" else
                    f", params_backend {codec.params_backend}"))
        res, out, got, _, y_hat = tiled_round_trip(codec, image, ops, label)
        if (got["vq_argmin"], got["flash_attention"]) != (1, want_k2):
            raise AssertionError(f"{label}: K1 {got['vq_argmin']}, K2 {got['flash_attention']}")
        times[fmt] = timed_round_trip(codec, image)
        print(f"{label}: warm encode {times[fmt][0]:.4f} s, decode {times[fmt][1]:.4f} s (host "
              f"clock, one run), peak memory {times[fmt][2]:.2f} GiB, {times[fmt][3]:.4f} bpp; "
              f"{smi}")
        if fmt == "tpu":
            kept = (out, y_hat)
            reader = Codec(spec, stream_format="compressai")
            if not reader.verify_roundtrip(res, [r["string_list"] for r in res], (H, W)):
                raise AssertionError(f"{label}: a compressai Codec (params_backend "
                                     f"{reader.params_backend}) decodes other latents")
            print(f"{label}: a compressai Codec (params_backend {reader.params_backend}) "
                  f"decodes the stream's latents bit-exactly")
            del reader
        del res, out, codec
    torch.cuda.empty_cache()

    spec_k = build_comp_model(opt, recon_kernels=RECON_KERNELS)
    spec_k.module.load_state_dict(sd, strict=True)
    tpu_k = Codec(spec_k, encode_backend="device", lanes=512)
    label = f"tiled {H}x{W}, f32, tpu format, reconstruction kernels on"
    _, out_k, launches_k, shapes_k, _ = tiled_round_trip(tpu_k, image, ops, label)
    if any(launches_k[k] < 1 for k in (*gn.launches, *conv3x3.launches)) or (
            launches_k["vq_argmin"], launches_k["flash_attention"]) != (1, want_k2):
        raise AssertionError(f"{label}: launches {launches_k}")
    enc, dec, peak, _ = timed_round_trip(tpu_k, image)
    print(f"{label}: warm encode {enc:.4f} s, decode {dec:.4f} s, peak memory {peak:.2f} GiB")
    print(json.dumps({"tiled_launch_shapes": {
        name: [{"shape": list(shape), "launches": n} for shape, n in sorted(table.items())]
        for name, table in shapes_k.items()}}))
    check_path_shapes(gn, conv3x3, shapes_k, dev, gen, "float32")
    out, y_hat = kept
    from dc_vic_tpu_torch.codec.tiling import DEC_WINDOW_Y as w
    first = torch.cat([y_hat[:, :, t:t + w, l:l + w] for t, l in
                       ((0, 0), (0, 16), (16, 0), (16, 16))])
    compare_recon(tpu, tpu_k, first)
    diff = np.abs(out_k.astype(np.int16) - out.astype(np.int16))
    print(f"tiled decode, kernels on against off: {float((diff > 1).mean()):.4f} of the pixels "
          f"more than one step apart, mean {float(diff.mean()):.3f} steps (estimator argmax "
          f"flips included; the float reconstructions of four tiles fed one set of indices are "
          f"held above)")
    del spec_k, tpu_k, out_k, kept, out, y_hat, first
    torch.cuda.empty_cache()

    images = smooth_images(4, 768, 512)
    check_cpu_decoder(opt, sd, Codec(spec, stream_format="compressai"), images)
    check_betas(tpu, images)
    del tpu, spec
    torch.cuda.empty_cache()
    check_cli(images[:2])
    check_predicates(attention, vq, dev, gen)
    print(f"item 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches_k, times


def report_ptxas(log):
    """One line per kernel from the compiler's -Xptxas -v output: its name
    with the template arguments as mangled, registers, spills."""
    import re
    name = None
    facts = []
    for line in log.splitlines() + ["Compiling entry function ''"]:
        if "Compiling entry function" in line:
            if name:
                print(f"  ptxas: {name}: {'; '.join(facts)}")
            name = None
            for found in re.finditer(r"(?=(\d\d)([a-z][a-z0-9_]*?_kernel)(.*?)E(v|PK))", line):
                if int(found.group(1)) == len(found.group(2)):     # <length><name>
                    name = found.group(2) + found.group(3)
            facts = []
        elif "spill" in line:
            facts.append(line.strip())
        elif "registers" in line:
            facts.append(line.split(":", 1)[1].strip())


def check_deployment(deployment_sd, ops):
    """Items 8 to 10 of the module docstring. ``deployment_sd``: the f32
    weights of the workload (seed 0, encoder scaled). Returns the launch
    counts of the bf16 round trip with the reconstruction kernels on, and
    the shapes its reconstruction kernels were launched with."""
    import torch
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.ops import conv3x3, gn
    from dc_vic_tpu_torch.tools.workload import (DEPLOYMENT, deployment_config,
                                                 deployment_images)
    from dc_vic_tpu_torch.utils.config import load_config
    recon_names = (*gn.launches, *conv3x3.launches)
    opt = load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    images16 = deployment_images()
    B16, lanes = DEPLOYMENT["batch"], DEPLOYMENT["lanes"]
    opt16 = deployment_config(opt)
    kept = {}
    for dtype_name, o in (("bfloat16", opt16), ("float32", opt)):
        for names in ((), RECON_KERNELS):
            label = (f"{dtype_name}, entropy_precision {o.get('entropy_precision', 'high')}, "
                     f"recon_kernels {'on' if names else 'off'}, tpu format, device backend, "
                     f"lanes {lanes}, batch {B16} 768x512")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            spec_c = build_comp_model(o, recon_kernels=names)
            spec_c.module.load_state_dict(deployment_sd, strict=True)
            codec_c = Codec(spec_c, encode_backend="device", lanes=lanes)
            y_hat, got, shapes = counted_round_trip(codec_c, images16, label, ops)
            if (got["vq_argmin"], got["flash_attention"], got["rans_encode_pack"],
                    got["rans_decode_section"]) != (1, 7, 2, 7):
                raise AssertionError(f"{label}: launches {got}")
            if names == RECON_KERNELS and any(got[k] < 1 for k in recon_names):
                raise AssertionError(f"{label}: a reconstruction kernel never launched: {got}")
            res, _, enc, dec = drive(codec_c, images16)
            strings16 = [r["string_list"] for r in res]
            bpp = float(np.mean([r["bpp"] for r in res]))
            if not bpp > 0.03:
                raise AssertionError(f"{label}: {bpp} bpp: a near-empty stream idles the coder")
            h = HeaderHandler.decode(strings16[0][0])
            want = dict(stream_format="tpu", lanes=lanes, encode_batch=B16, portable=False,
                        fast_entropy=dtype_name == "bfloat16", bf16=dtype_name == "bfloat16")
            if any(h[k] != v for k, v in want.items()):
                raise AssertionError(f"{label}: header {h}")
            cycle = codec_c.bench_device_cycle(images16, 0, iters=3 if dtype_name == "bfloat16"
                                               else 2)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"{label}: warm encode {enc:.4f} s, decode {dec:.4f} s (host clock, one "
                  f"run); bench_device_cycle encode chain {cycle['enc_s']:.4f} s, decode chain "
                  f"{cycle['dec_s']:.4f} s; {bpp:.4f} bpp"
                  f"{' (over the 0.8 the reference workload stays under)' if bpp > 0.8 else ''}"
                  f"; peak memory {peak:.2f} GiB; header {h}")
            if dtype_name == "bfloat16" or not names:
                kept[dtype_name, bool(names)] = (spec_c, codec_c, strings16, got, shapes, y_hat)
            del spec_c, codec_c, y_hat
    _, codec16k, _, launches16, shapes16, _ = kept["bfloat16", True]
    spec16, codec16, strings16, _, _, y_hat = kept["bfloat16", False]
    parts16, ref = bf16_against_f32(kept.pop(("float32", False))[1], codec16, codec16k, y_hat)
    del y_hat
    torch.cuda.empty_cache()
    fast_ms, high_ms = entropy_chain_ms(codec16, images16)
    print(f"entropy chain of one batch-{B16} encode (hyper_decode, slice parameters, six "
          f"decode steps): {fast_ms:.3f} ms with entropy_precision default (TF32 allowed in "
          f"its convs), {high_ms:.3f} ms with high")
    for on in (False, True):
        cycles = pipelined_cycle(kept["bfloat16", on][1], images16)
        print(f"pipelined cycle, recon_kernels {'on' if on else 'off'}, 3 batches of {B16}: "
              f"{', '.join(f'{c:.4f}' for c in cycles)} s per cycle (the first waits for no "
              f"decode and the last also drains, so the middle one is the steady state: "
              f"{B16 / cycles[1]:.2f} images/s; all three batches {sum(cycles):.4f} s, "
              f"{3 * B16 / sum(cycles):.2f} images/s)")
    fresh_spec = build_comp_model(opt16)
    fresh_spec.module.load_state_dict(deployment_sd, strict=True)
    pcodec, pbpp = check_portable(spec16, fresh_spec, codec16, strings16, images16, parts16,
                                  ref)
    del fresh_spec, parts16, ref
    torch.cuda.reset_peak_memory_stats()
    pcycle = pcodec.bench_device_cycle(images16, 0)
    cycle = codec16.bench_device_cycle(images16, 0)
    print(f"bench_device_cycle, bf16 recon_kernels off, batch {B16}: portable encode chain "
          f"{pcycle['enc_s']:.4f} s, decode chain {pcycle['dec_s']:.4f} s; non-portable "
          f"{cycle['enc_s']:.4f} s / {cycle['dec_s']:.4f} s (same run, in turn); portable "
          f"{pbpp:.4f} bpp; peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del kept, pcodec, codec16, codec16k, spec16
    torch.cuda.empty_cache()
    return launches16, shapes16


# ------------------------------------------------------------------ training

TRAIN_BATCH, TRAIN_CROP = 6, 256     # config/_base_/dataset: batch 6 of 256x256 crops
GRAD_TOL = 1e-3                      # relative L2 per parameter tensor (+1e-7 absolute)
TRAIN_STEPS = 4                      # timed steps per setting; the first is not warm


def _training_images(root):
    """Twelve 384x320 training images and two 768x512 evaluation images
    (smooth content plus noise, seed 0), as .npy uint8 files."""
    from dc_vic_tpu_torch.tools.workload import smooth_images
    imgs = smooth_images(14, 768, 512)
    os.makedirs(os.path.join(root, "train_0"))
    os.makedirs(os.path.join(root, "kodak"))
    for i in range(12):
        np.save(os.path.join(root, "train_0", f"img{i:02d}.npy"),
                imgs[i, 24 * i:24 * i + 384, 8 * i:8 * i + 320])
    for j in range(2):
        np.save(os.path.join(root, "kodak", f"kodim{j:02d}.npy"), imgs[12 + j])


def training_opt(stage, root, load=None):
    """config/exp1_stage{stage}.yaml on the synthetic images, checkpoints
    under ``root``, the reconstruction kernels on."""
    from dc_vic_tpu_torch.models import RECON_KERNELS
    from dc_vic_tpu_torch.utils.config import load_config
    opt = load_config(os.path.join(ROOT, "config", f"exp1_stage{stage}.yaml"), is_train=True)
    data = opt["dataset"]
    data["batch_size"] = TRAIN_BATCH
    data["train_dataset"].update(root_dir=root, subset_list=[0], image_size=TRAIN_CROP)
    data["eval_dataset"]["root_dir"] = os.path.join(root, "kodak")
    opt["ckpt_root"] = os.path.join(root, "ckpt")
    opt["recon_kernels"] = list(RECON_KERNELS)
    opt["load_checkpoint"] = load
    return opt


class _KernelSwitch:
    """Every kernel of the training path that has a plain route, off or on:
    K3 to K6 through ``set_recon_kernels``, K2 through its shape rule (the
    plain attention is differentiated by autograd). K1 has no gradient."""

    def __init__(self, attention):
        self.attention, self.rule = attention, attention.use_kernel

    def __call__(self, module, on):
        from dc_vic_tpu_torch.models import RECON_KERNELS, set_recon_kernels
        set_recon_kernels(module, RECON_KERNELS if on else ())
        self.attention.use_kernel = self.rule if on else (lambda shape, dtype: False)


def backward_recorder(module):
    """Forward hooks counting, by the shape rules, the kernel launches whose
    output carries a gradient: the Function backwards the step runs."""
    import torch
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock, VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import Conv2d, GroupNorm
    from dc_vic_tpu_torch.ops import attention
    want = {"flash_attention": 0, "gn_channel_sums": 0, "gn_apply": 0, "conv3x3_same": 0,
            "conv3x3_gn_swish": 0}

    def hook(m, args):
        x = args[0]
        if not (torch.is_grad_enabled() and x.requires_grad):
            return
        if isinstance(m, VQAttnBlock):
            B, C, H, W = x.shape
            want["flash_attention"] += attention.use_kernel((B, H * W, C), torch.float32)
        elif isinstance(m, GroupNorm) and m.takes_kernel(x.shape):
            want["gn_channel_sums"] += 1
            want["gn_apply"] += 1
        elif isinstance(m, Conv2d) and m.takes_kernel(x.shape):
            want["conv3x3_same"] += 1
        elif isinstance(m, VQResnetBlock) and m.takes_fused(x.shape):
            want["conv3x3_gn_swish"] += 2

    kinds = (VQAttnBlock, GroupNorm, Conv2d, VQResnetBlock)
    return want, [m.register_forward_pre_hook(hook) for m in module.modules()
                  if isinstance(m, kinds)]


def backwards(attention, gn, conv3x3):
    return {"flash_attention": attention.backwards, **gn.backwards, **conv3x3.backwards}


def reset_backwards(attention, gn, conv3x3):
    attention.backwards = 0
    for table in (gn.backwards, conv3x3.backwards):
        for name in table:
            table[name] = 0


def _rel_l2(got, want):
    import torch
    err = float(torch.linalg.vector_norm((got - want).double()))
    return err, err / max(float(torch.linalg.vector_norm(want.double())), 1e-30)


def recorded_step(module, ops, run):
    """``run()`` with every launch counter and Function backward counter
    set to 0 just before it and read just after, held against what the
    shape rules give for the modules that ran. Returns (run's result,
    {"forward": launches, "backward": backwards}, the conv and GroupNorm
    kernels' launch shapes)."""
    import torch
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn
    want, shapes, handles = expected_launch_recorder(module)
    want_bwd, more = backward_recorder(module)
    want.update(rans_encode_pack=0, rans_decode_section=0)
    reset_counters(*ops)
    reset_backwards(attention, gn, conv3x3)
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        for h in handles + more:
            h.remove()
    got = dict(forward=counters(*ops), backward=backwards(attention, gn, conv3x3))
    if got != dict(forward=want, backward=want_bwd):
        raise AssertionError(f"launches {got}, the shape rules give {want} / {want_bwd}")
    return result, got, shapes


def compare_training_gradients(tr, batch, switch, ops):
    """Item 13.1: one RD step's gradients with every kernel off and on, the
    same betas, noise and VQ targets. Returns the worst relative error."""
    import torch
    from dc_vic_tpu_torch.codec.ops import Noise
    from dc_vic_tpu_torch.train.steps import rd_losses
    from dc_vic_tpu_torch.train.trainer import _FLAGS as _TRAIN_FLAGS
    from dc_vic_tpu_torch.utils.backends import backend_flags
    model = tr.model
    beta_rate, beta_vq = tr.policy.sample(tr.state.generator, batch.shape[0])
    with torch.no_grad():
        codes = model.vq_encode(batch)
    # the frozen VQGAN's targets, pinned: a near-tie in the argmin between
    # the two routes' latents would change the targets, not test a gradient
    model.vq_encode = lambda x: codes
    grads = {}

    def run():
        with backend_flags(**_TRAIN_FLAGS):
            total, _, _ = rd_losses(model, tr.losses, batch, beta_rate, beta_vq, tr.policy,
                                    Noise(torch.Generator(batch.device).manual_seed(1)))
            (total + model.aux_loss()).backward()
        return total

    try:
        for on in (False, True):
            switch(model, on)
            for p in model.parameters():
                p.grad = None
            total, launched, _ = recorded_step(model, ops, run)
            grads[on] = {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}
            print(f"RD step gradients, kernels {'on' if on else 'off'}: loss "
                  f"{float(total.detach()):.6f}; launches {launched['forward']}; Function "
                  f"backwards {launched['backward']}")
    finally:
        del model.vq_encode
        switch(model, True)
    trained = [n for n, m in tr.main_mask.items() if m] + [n for n, m in tr.aux_mask.items() if m]
    for on in (False, True):
        missing = [n for n in trained if n not in grads[on]]
        bad = [n for n in trained if n in grads[on] and not torch.isfinite(grads[on][n]).all()]
        if missing or bad:
            raise AssertionError(f"kernels {'on' if on else 'off'}: trained parameters without "
                                 f"a gradient {missing[:5]}, non-finite {bad[:5]}")
    frozen = [n for n in grads[True] if n not in trained]
    if frozen:
        raise AssertionError(f"frozen parameters got gradients: {frozen[:5]}")
    worst, worst_name = 0.0, None
    for name, want in grads[False].items():
        err, rel = _rel_l2(grads[True][name], want)
        if not err <= GRAD_TOL * float(torch.linalg.vector_norm(want.double())) + 1e-7:
            raise AssertionError(f"RD step gradients, kernels on vs off: {name} relative L2 "
                                 f"error {rel:.3e} over {GRAD_TOL}")
        if rel > worst:
            worst, worst_name = rel, name
    print(f"RD step gradients, kernels on vs off: {len(trained)} trained tensors, every one "
          f"with a finite gradient, no frozen one with any; worst relative L2 error "
          f"{worst:.3e} ({worst_name}; tolerance {GRAD_TOL})")
    return worst


def timed_steps(tr, loader, switch, ops, on, n=TRAIN_STEPS):
    """n steps of the trainer's stage with the kernels off or on: (host
    seconds of each step, ending in a synchronize; the last step's launches
    and Function backwards, held against the shape rules; its launch
    shapes)."""
    import torch
    switch(tr.model, on)
    secs = []
    for i in range(n):
        batch = tr._to_device(next(loader)["real_images"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i < n - 1:
            terms = tr.step(batch)
            torch.cuda.synchronize()
        else:
            terms, launched, shapes = recorded_step(tr.model, ops, lambda: tr.step(batch))
        secs.append(time.perf_counter() - t)
        if not all(np.isfinite(float(v)) for v in terms.values()) or float(terms["skipped"]):
            raise AssertionError(f"a training step gave {terms}")
    return secs, launched, shapes


def time_backward_kernels(shapes, dev, gen):
    """Item 13.3: each kernel Function of the training path at the path's
    largest shape: the output carries a grad_fn, its gradients are held to
    autograd of the plain version, and forward and backward are timed with
    CUDA events. Returns {kernel: the training keys of its entry}."""
    import torch
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn
    rows = {}

    def run(name, shape, kernel, plain, inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = kernel(*leaves)
        if out.grad_fn is None:
            raise AssertionError(f"{name}: the kernel's output has no grad_fn")
        g = torch.randn(out.shape, generator=gen, device=dev)
        got = torch.autograd.grad(out, leaves, g)
        ref = [t.detach().requires_grad_(True) for t in inputs]
        want = torch.autograd.grad(plain(*ref), ref, g)
        worst = max(_rel_l2(a, b)[1] for a, b in zip(got, want))
        if worst > GRAD_TOL:
            raise AssertionError(f"{name} backward at {list(shape)}: relative L2 {worst:.3e}")
        with torch.no_grad():
            fwd = _time_ms(kernel, *inputs)
        # one backward alone: the forward and backward, less the forward
        bwd = _time_ms(lambda: torch.autograd.grad(kernel(*leaves), leaves, g)) \
            - _time_ms(kernel, *leaves)
        plain_bwd = _time_ms(lambda: torch.autograd.grad(plain(*ref), ref, g)) \
            - _time_ms(plain, *ref)
        rows[name] = dict(train_shape=list(shape), train_fwd_ms=fwd, train_bwd_ms=bwd,
                          train_plain_bwd_ms=plain_bwd, train_bwd_max_rel_l2=worst)
        print(f"{name} at {list(shape)}, f32: the output has a grad_fn; forward kernel "
              f"{fwd:.3f} ms, Function backward {bwd:.3f} ms (autograd of the plain version "
              f"{plain_bwd:.3f} ms), gradients within {worst:.2e} of the plain version's")

    B = TRAIN_BATCH
    q, k, v = (torch.randn(B, 1024, 512, generator=gen, device=dev) * s for s in (0.05, 1, 1))
    run("flash_attention", (B, 1024, 512), attention.flash_attention,
        attention.attention_plain, (q, k, v))
    gshape = max(shapes["gn"], key=lambda s: int(np.prod(s)))
    x = torch.randn(gshape, generator=gen, device=dev)
    run("gn_channel_sums", gshape, gn.channel_sums, gn.channel_sums_plain, (x,))
    scale = torch.rand(gshape[:2], generator=gen, device=dev) + 0.5
    bias = torch.randn(gshape[:2], generator=gen, device=dev)
    run("gn_apply", gshape, lambda x, s, b: gn.apply_affine(x, s, b, "swish"),
        lambda x, s, b: gn.apply_affine_plain(x, s, b, "swish"), (x, scale, bias))
    for name in ("conv3x3_same", "conv3x3_gn_swish"):
        Bc, C, Cout, H, W = max(shapes[name], key=lambda s: int(np.prod(s)))
        x = torch.randn(Bc, C, H, W, generator=gen, device=dev)
        w = torch.randn(Cout, C, 3, 3, generator=gen, device=dev) / (3 * C ** 0.5)
        if name == "conv3x3_same":
            run(name, (Bc, C, Cout, H, W), conv3x3.conv3x3_same, conv3x3.conv3x3_same_plain,
                (x, w))
            continue
        s = torch.rand(Bc, C, generator=gen, device=dev) + 0.5
        b = torch.randn(Bc, C, generator=gen, device=dev) * 0.1
        cb = torch.randn(Cout, generator=gen, device=dev)
        res = torch.randn(Bc, Cout, H, W, generator=gen, device=dev)
        run(name, (Bc, C, Cout, H, W), conv3x3.conv3x3_gn_swish,
            conv3x3.conv3x3_gn_swish_plain, (x, w, s, b, cb, res))
    return rows


def check_training(ops, smi, dev, gen):
    """Item 13 of the module docstring. Returns {kernel name: the training
    keys of its entry in the kernels line}."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.ops import attention
    from dc_vic_tpu_torch.tools.workload import scale_encoder
    from dc_vic_tpu_torch.train.trainer import build_trainer
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_train_")
    switch = _KernelSwitch(attention)
    loaders = []
    try:
        _training_images(root)
        torch.cuda.empty_cache()
        # stage 1_2: gradients off against on, then steps off and on
        t = time.perf_counter()
        tr = build_trainer(training_opt("1_2", root))
        tr.model.load_state_dict(scale_encoder(tr.model.state_dict()))
        print(f"stage 1_2 trainer (flagship, f32, random weights from seed 0, encoder x 0.55): "
              f"built in {time.perf_counter() - t:.1f} s")
        frozen0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                   if n.startswith("vq_model.")}
        loaders.append(tr.train_loader.infinite())
        loader = loaders[-1]
        worst = compare_training_gradients(tr, tr._to_device(next(loader)["real_images"]),
                                           switch, ops)
        enc0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                if n.startswith("encoder.")}
        rd_off, _, _ = timed_steps(tr, loader, switch, ops, False)
        torch.cuda.reset_peak_memory_stats()
        rd_on, rd_launched, shapes = timed_steps(tr, loader, switch, ops, True)
        rd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if all(torch.equal(enc0[n], p) for n, p in tr.model.named_parameters() if n in enc0):
            raise AssertionError("stage 1_2: the encoder did not move")
        n12 = tr.state.step
        tr.save(n12)
        del tr
        torch.cuda.empty_cache()

        # stage 1_3 boots from 1_2's checkpoint (the shipped knobs)
        tr = build_trainer(training_opt("1_3", root, dict(
            exp="exp1_stage1_2", iter=n12, load_optimizer=False, strict=False)))
        loaders.append(tr.train_loader.infinite())
        loader = loaders[-1]
        before = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                  if n.startswith(("encoder.", "decoder."))}
        gan_off, _, _ = timed_steps(tr, loader, switch, ops, False)
        torch.cuda.reset_peak_memory_stats()
        gan_on, gan_launched, _ = timed_steps(tr, loader, switch, ops, True)
        gan_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params = dict(tr.model.named_parameters())
        if not all(torch.equal(before[n], params[n]) for n in before if n.startswith("encoder.")):
            raise AssertionError("stage 1_3 moved the encoder, which the GAN stages freeze")
        if all(torch.equal(before[n], params[n]) for n in before if n.startswith("decoder.")):
            raise AssertionError("stage 1_3: the decoder did not move")
        n13 = tr.state.step
        tr.save(n13)
        d_sd = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
        del tr, params, before
        torch.cuda.empty_cache()

        # stage 3 boots from 1_3's, optimizer and discriminator included
        tr = build_trainer(training_opt("3", root, dict(
            exp="exp1_stage1_3", iter=n13, load_optimizer=True, load_scheduler=False,
            strict=True)))
        g_opt = tr.state.g_opt
        if (int(g_opt.sched_count), int(g_opt.count)) != (0, n13):
            raise AssertionError(f"stage 3 boot: schedule count {int(g_opt.sched_count)}, Adam "
                                 f"count {int(g_opt.count)}; expected 0 and {n13}")
        if any(not torch.equal(v, tr.state.disc.state_dict()[k]) for k, v in d_sd.items()):
            raise AssertionError("stage 3 boot: the discriminator is not 1_3's")
        loaders.append(tr.train_loader.infinite())
        s3, _, _ = timed_steps(tr, loaders[-1], switch, ops, True, n=2)
        moved = [n for n, p in tr.model.named_parameters()
                 if n in frozen0 and not torch.equal(frozen0[n], p)]
        if moved:
            raise AssertionError(f"the frozen VQGAN prior moved: {moved[:5]}")
        t = time.perf_counter()
        val = tr.validate(tr.state.step, max_samples=2)
        val_s = time.perf_counter() - t
        if not (val and all(np.isfinite(v) for v in val.values()) and val["ms_ssim"] > 0):
            raise AssertionError(f"validation gave {val}")
        del tr
        torch.cuda.empty_cache()
    finally:
        for it in loaders:
            it.close()
        shutil.rmtree(root, ignore_errors=True)
        switch(torch.nn.Module(), True)

    rows = time_backward_kernels(shapes, dev, gen)
    warm = lambda secs: float(np.median(secs[1:]))
    print(f"training steps, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, f32 (host clock "
          f"around the step, ending in torch.cuda.synchronize(); medians of {TRAIN_STEPS - 1} "
          f"warm steps; {smi}): RD (stage 1_2) kernels off {warm(rd_off):.4f} s, on "
          f"{warm(rd_on):.4f} s ({TRAIN_BATCH / warm(rd_on):.2f} images/s); GAN (stage 1_3) "
          f"off {warm(gan_off):.4f} s, on {warm(gan_on):.4f} s "
          f"({TRAIN_BATCH / warm(gan_on):.2f} images/s); stage 3 "
          f"{', '.join(f'{x:.4f}' for x in s3)} s")
    print(f"peak device memory with the kernels on: RD step {rd_peak:.2f} GiB, GAN step "
          f"{gan_peak:.2f} GiB (model, optimizer states and activations)")
    print(f"launches per RD step {rd_launched['forward']}, Function backwards "
          f"{rd_launched['backward']}; per GAN step {gan_launched['forward']}, backwards "
          f"{gan_launched['backward']}")
    print(f"stage 1_2 -> 1_3 -> 3: checkpoints at {n12} and {n13} steps booted, the frozen "
          f"prior bit-identical, validation on two 768x512 images at four beta corners "
          f"{val_s:.1f} s ({val}); worst gradient error {worst:.3e}; training phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    out = {}
    for name in ("vq_argmin", "flash_attention", "gn_channel_sums", "gn_apply", "conv3x3_same",
                 "conv3x3_gn_swish"):
        out[name] = dict(rows.get(name, {}),
                         train_launches_rd_step=rd_launched["forward"][name],
                         train_backwards_rd_step=rd_launched["backward"].get(name, 0),
                         train_launches_gan_step=gan_launched["forward"][name],
                         train_backwards_gan_step=gan_launched["backward"].get(name, 0))
    return dict(kernels=out, rd_s=(warm(rd_off), warm(rd_on)),
                gan_s=(warm(gan_off), warm(gan_on)), peak_gib=(rd_peak, gan_peak),
                worst_grad_rel_l2=worst)


# ------------------------------------------------------- evaluation (item 14)

EVAL_IMAGES = 50          # FID's minimum (metrics/fid.py MIN_IMAGES)
EVAL_SIZE = (768, 512)
EVAL_BATCH = 16
HOST_PAIRS = 2            # reals and reconstructions the host CPU recomputes
CALIB_IMAGES = 18         # crops the rate search runs over: one batch of 16 and a remainder
CALIB_BATCH = 16
BETA_VQS = (1.0, 3.0)     # the rate search's cut sweep
# bpp inside the range the random-weight model spans at both beta_vq (about
# 0.254 to 0.260 over beta_rate 0 to 3 at 18 crops: random weights leave the
# rate nearly flat in beta_rate)
TARGET_RATES = (0.256, 0.258)
METRIC_TOL = 1e-4         # LPIPS and DISTS, card against host CPU
POOL3_RTOL, POOL3_ATOL = 1e-3, 1e-5    # Inception pool3 features, card against host CPU
RD_STEPS = 4              # RD steps with LPIPS; the first is not warm


def counted_run(module, ops, run, rans=(0, 0)):
    """``run()`` with every launch counter set to 0 just before it and read
    just after, held against the shape rules for the modules that ran, with
    ``rans`` = (R1, R2) launches expected. Returns (run's result,
    launches)."""
    import torch
    want, _, handles = expected_launch_recorder(module)
    want.update(rans_encode_pack=rans[0], rans_decode_section=rans[1])
    reset_counters(*ops)
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    got = counters(*ops)
    if got != want:
        raise AssertionError(f"launches {got}, the shape rules give {want}")
    return result, got


def check_metric_nets(paths, reals, fakes, smi, dev):
    """The evaluation networks loaded through their loaders on the card and
    on the host CPU: LPIPS and DISTS on the first HOST_PAIRS pairs within
    METRIC_TOL, Inception's pool3 features of their patches within
    POOL3_RTOL; timed on the card. Returns (the card's networks, times)."""
    import torch
    from dc_vic_tpu_torch.metrics.feature_nets import load_dists, load_lpips
    from dc_vic_tpu_torch.metrics.fid import collect_patches
    from dc_vic_tpu_torch.metrics.inception import load_inception
    from dc_vic_tpu_torch.tools.calc_metrics import to_pm1
    card = dict(lpips=load_lpips(paths["lpips_alex"], "alex", dev),
                dists=load_dists(paths["dists"], dev),
                inception=load_inception(paths["inception"], dev))
    host = dict(lpips=load_lpips(paths["lpips_alex"], "alex", device="cpu"),
                dists=load_dists(paths["dists"], device="cpu"),
                inception=load_inception(paths["inception"], device="cpu"))
    nchw = lambda a, dev: torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(dev)
    worst = {}
    with torch.no_grad():
        for name, scale in (("lpips", to_pm1), ("dists", lambda u8: u8 / np.float32(255))):
            got = [float(card[name](nchw(scale(r)[None], dev), nchw(scale(f)[None], dev)))
                   for r, f in zip(reals[:HOST_PAIRS], fakes[:HOST_PAIRS])]
            want = [float(host[name](nchw(scale(r)[None], "cpu"), nchw(scale(f)[None], "cpu")))
                    for r, f in zip(reals[:HOST_PAIRS], fakes[:HOST_PAIRS])]
            worst[name] = float(np.max(np.abs(np.subtract(got, want))))
            if not np.all(np.isfinite(got)) or worst[name] > METRIC_TOL:
                raise AssertionError(f"{name} on the card {got}, on the host {want}")
    patches = np.stack(collect_patches(list(reals[:HOST_PAIRS])))
    got, want = card["inception"](patches), host["inception"](patches)
    # each feature within POOL3_RTOL of the host's, plus POOL3_ATOL for those
    # near 0: the worst share of that allowance used
    worst["pool3"] = float(np.max(np.abs(got - want) / (POOL3_ATOL + POOL3_RTOL * np.abs(want))))
    if got.shape != (len(patches), 2048) or worst["pool3"] > 1.0:
        raise AssertionError(f"pool3 features on the card differ from the host's: "
                             f"{worst['pool3']:.3f} of the allowance")
    # Inception as FID calls it: uint8 patches from the host, features back
    batch = np.stack(collect_patches(list(reals[:4]))[:32])
    card["inception"](batch)
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        card["inception"](batch)
        secs.append(time.perf_counter() - t)
    with torch.no_grad():
        a = nchw(to_pm1(reals[0])[None], dev)
        b = nchw(to_pm1(fakes[0])[None], dev)
        lpips_ms = _time_ms(card["lpips"], a, b)
        dists_ms = _time_ms(card["dists"], (a + 1) / 2, (b + 1) / 2)
    times = dict(inception_patches_per_s=len(batch) / float(np.median(secs)),
                 lpips_ms_per_image=lpips_ms, dists_ms_per_image=dists_ms)
    print(f"metric networks on the card against the host CPU ({HOST_PAIRS} pairs of "
          f"{reals[0].shape[0]}x{reals[0].shape[1]}, {len(patches)} patches): worst LPIPS "
          f"{worst['lpips']:.2e}, DISTS {worst['dists']:.2e} (atol {METRIC_TOL}), pool3 "
          f"{worst['pool3']:.3f} of its allowance (rtol {POOL3_RTOL}, atol {POOL3_ATOL}); "
          f"Inception "
          f"{times['inception_patches_per_s']:.1f} patches/s at batch 32 (host clock, "
          f"uint8 in, features out), LPIPS(alex) {lpips_ms:.3f} ms and DISTS "
          f"{dists_ms:.3f} ms per {reals[0].shape[0]}x{reals[0].shape[1]} image (CUDA "
          f"events; {smi})")
    return card, dict(times, **{f"worst_{k}": v for k, v in worst.items()})


def check_evaluation(opt, sd, ops, smi, dev):
    """Item 14 of the module docstring. Returns {kernel name: its launches
    in this phase}, and the phase's figures."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.metrics.fid import MIN_IMAGES
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.tools import beta_selection, binary_rate_search
    from dc_vic_tpu_torch.tools import compress as cli
    from dc_vic_tpu_torch.tools.build_val_dataset import crop_and_tokenize
    from dc_vic_tpu_torch.tools.calc_metrics import calc_metrics_arrays, to_pm1
    from dc_vic_tpu_torch.tools.workload import metric_state_dicts, smooth_images
    from dc_vic_tpu_torch.train.trainer import build_trainer
    from dc_vic_tpu_torch.utils.backends import backend_flags
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_eval_")
    figures, launches = {}, {}
    try:
        paths = {}
        for name, state in metric_state_dicts(0).items():
            paths[name] = os.path.join(root, f"{name}.pth")
            torch.save({k: torch.from_numpy(v) for k, v in state.items()}, paths[name])
        spec = build_comp_model(opt, dev, recon_kernels=RECON_KERNELS)
        spec.module.load_state_dict(sd, strict=True)
        module = spec.module.eval()
        codec = Codec(spec, encode_backend="device", lanes=512)

        # (1) the compress CLI's body over fifty 768x512 images
        reals = smooth_images(EVAL_IMAGES, *EVAL_SIZE)
        named = [(f"img{i:02d}.png", a) for i, a in enumerate(reals)]
        chunks = -(-EVAL_IMAGES // EVAL_BATCH)
        t = time.perf_counter()
        (rows, decoded), launches["compress_50"] = counted_run(
            module, ops, lambda: cli.compress_arrays(
                codec, named, 0, os.path.join(root, "out"), batch_size=EVAL_BATCH,
                selfcheck=True, decompress=True),
            rans=(2 * chunks, 2 * chunks * (1 + codec.num_slices)))
        compress_s = time.perf_counter() - t
        fakes = np.stack([decoded[n] for n, _ in named])
        if fakes.shape != reals.shape or fakes.dtype != np.uint8:
            raise AssertionError(f"decoded {fakes.shape} {fakes.dtype}")
        missing = [k for k, n in launches["compress_50"].items() if n < 1]
        if missing:
            raise AssertionError(f"the evaluation's compress never launched {missing}")
        with open(os.path.join(root, "out", "_avg_bitrate.json")) as f:
            bitrate = json.load(f)["avg_bpp"]
        print(f"compress_arrays, {EVAL_IMAGES} images {EVAL_SIZE[0]}x{EVAL_SIZE[1]}, tpu "
              f"format, device backend, lanes 512, reconstruction kernels on, batch "
              f"{EVAL_BATCH} ({chunks} chunks), "
              f"selfcheck and decompress: {compress_s:.2f} s, {bitrate:.4f} bpp; launches "
              f"{launches['compress_50']}")

        # (2) the metrics: the networks on the card held to the host CPU,
        # then calc_metrics over the fifty pairs
        nets, times = check_metric_nets(paths, reals, fakes, smi, dev)
        figures.update(times)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = calc_metrics_arrays(list(reals), list(fakes), nets["lpips"], nets["dists"],
                                      nets["inception"], bitrate)
        figures["calc_metrics_s"] = time.perf_counter() - t
        if (metrics["skipped"] or metrics["num_images"] != EVAL_IMAGES
                or not all(np.isfinite(metrics[k]) for k in ("psnr", "ms_ssim", "fid",
                                                              "lpips", "dists"))):
            raise AssertionError(f"calc_metrics gave {metrics}")
        print(f"calc_metrics over {EVAL_IMAGES} pairs (random network weights, seed 0): "
              f"{metrics}; {figures['calc_metrics_s']:.2f} s (host clock)")

        # (3) the validation set and the rate search on both paths
        t = time.perf_counter()
        names, crops, maps = crop_and_tokenize(module, list(reals), np.random.default_rng(0),
                                               num_images=EVAL_IMAGES, crop=256,
                                               batch_size=EVAL_BATCH)
        if crops.shape != (EVAL_IMAGES, 256, 256, 3) or maps.shape != (EVAL_IMAGES, 32, 32) \
                or maps.dtype != np.uint8:
            raise AssertionError(f"validation set {crops.shape}, token maps {maps.shape} "
                                 f"{maps.dtype}")
        print(f"build_val_dataset: {len(names)} crops 256x256 and uint8 token maps "
              f"{maps.shape[1:]} in {time.perf_counter() - t:.2f} s")
        imgs = to_pm1(crops)
        sub = slice(0, CALIB_IMAGES)
        avg = {"token maps": binary_rate_search.make_avg_bpp(module, imgs[sub], CALIB_BATCH,
                                                             maps[sub]),
               "forward": binary_rate_search.make_avg_bpp(module, imgs[sub], CALIB_BATCH)}
        rem = CALIB_IMAGES % CALIB_BATCH
        for label, fn in avg.items():
            _, launches[f"probe_{label}"] = counted_run(module, ops, lambda: fn(1.5, 2.0))
        curve = {bv: [(br, round(avg["token maps"](br, bv), 5))
                      for br in (0.0, 0.75, 1.5, 2.25, spec.max_beta_rate)] for bv in BETA_VQS}
        print(f"estimated bpp of {CALIB_IMAGES} crops by beta_rate, for beta_vq {BETA_VQS}: "
              f"{curve}")
        results, secs, probes = {}, {}, {}
        for label, fn in avg.items():
            calls = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            results[label] = binary_rate_search.search(
                lambda br, bv, fn=fn, calls=calls: calls.append(br) or fn(br, bv), BETA_VQS,
                TARGET_RATES, spec.max_beta_rate)
            secs[label], probes[label] = time.perf_counter() - t, len(calls)
        for a, b in zip(results["token maps"], results["forward"]):
            if (a["beta_rate"] != b["beta_rate"]
                    or not np.isclose(a["achieved_bpp"], b["achieved_bpp"], rtol=1e-5, atol=0)):
                raise AssertionError(f"the search's paths disagree: {a} against {b}")
            if abs(a["achieved_bpp"] - a["target_rate"]) > binary_rate_search.TOL:
                raise AssertionError(f"the search missed its target: {a}")
        figures.update(rate_search_s=secs, rate_search_probes=probes)
        print(f"binary_rate_search over {CALIB_IMAGES} crops (batch {CALIB_BATCH} and a "
              f"remainder of {rem}), beta_vq {BETA_VQS}, targets {TARGET_RATES}: "
              f"{results['forward']}; the token-map path agrees to rtol 1e-5; probes "
              f"{probes}, seconds {secs} (host clock)")

        # (4) beta selection on two of the search's candidates, with FID
        cands = [results["forward"][0], results["forward"][len(TARGET_RATES)]]
        feats = nets["inception"]
        t = time.perf_counter()
        chosen = beta_selection.score_candidates(
            cands, imgs, beta_selection.make_reconstruct(module, imgs, EVAL_BATCH), feats)
        figures["beta_selection_s"] = time.perf_counter() - t
        if (len(imgs) < MIN_IMAGES or not all(r["fid_in_score"] and np.isfinite(r["score"])
                                              for r in chosen)
                or sum(r["selected"] for r in chosen) != 1):
            raise AssertionError(f"beta_selection gave {chosen}")
        print(f"beta_selection of {len(cands)} candidates over {len(imgs)} crops with FID: "
              f"{chosen}; {figures['beta_selection_s']:.2f} s (host clock)")
        del codec, module, spec, nets
        torch.cuda.empty_cache()

        # (5) RD steps with the real (random) LPIPS, and the LPIPS loss's
        # forward and backward alone on the same batch
        _training_images(os.path.join(root, "train"))
        train_opt = training_opt("1_2", os.path.join(root, "train"))
        train_opt["lpips_weights"] = paths["lpips_alex"]
        tr = build_trainer(train_opt, dev)
        if tr.lpips_fn is None:
            raise AssertionError("the trainer did not load the LPIPS weights")
        loader = tr.train_loader.infinite()
        try:
            batch = tr._to_device(next(loader)["real_images"])
            secs = []
            for _ in range(RD_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                terms = tr.step(batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                if not all(np.isfinite(float(v)) for v in terms.values()):
                    raise AssertionError(f"an RD step with LPIPS gave {terms}")
        finally:
            loader.close()
        fake = (batch + 0.05 * torch.randn_like(batch)).requires_grad_(True)
        # the backend settings the trainer's steps run with
        with backend_flags(allow_tf32=False, deterministic=False, benchmark=True):
            lpips_ms = _time_ms(lambda: tr.lpips_fn(batch, fake).mean().backward())
        step_s = float(np.median(secs[1:]))
        figures.update(rd_step_s=step_s, lpips_fwd_bwd_ms=lpips_ms)
        print(f"RD step (stage 1_2, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, kernels "
              f"on, LPIPS(alex) as lpips_weights) {step_s:.4f} s (host clock, median of "
              f"{RD_STEPS - 1} warm steps); LPIPS forward + backward on that batch "
              f"{lpips_ms:.3f} ms (CUDA events), {lpips_ms / 10 / step_s:.2f}% of the step "
              f"({smi})")
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    figures["phase_s"] = time.perf_counter() - t_phase
    print(f"evaluation and calibration phase {figures['phase_s']:.1f} s")
    return launches, figures


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on a GPU")
    sys.path.insert(0, ROOT)
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model, init_weights
    from dc_vic_tpu_torch.ops import (attention, conv3x3, gn, native, rans_device, rans_host,
                                      vq)
    from dc_vic_tpu_torch.tools.workload import scale_encoder
    from dc_vic_tpu_torch.utils.config import load_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    t = time.perf_counter()
    native.kernels()
    native.rans()
    print(f"build: {time.perf_counter() - t:.1f} s (kernels + host rANS coder)")
    report_ptxas(native.build_logs.get("libdcvic_kernels.so", ""))

    # the numerics the codec runs with: f32 convolutions and products without
    # TF32, deterministic cuDNN algorithms (Codec sets the same)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = check_vq(vq, dev, gen)
    k1["launch_floor_ms"] = launch_floor_ms(native)
    k1["bound_with_launch_ms"] = max(k1["bound_ms"], k1["launch_floor_ms"])
    k2 = check_attention(attention, dev, gen)
    print(f"K1 at M=24576: kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms, "
          f"bound {k1['bound_ms']:.5f} ms ({k1['bound_by']}); an empty kernel takes "
          f"{k1['launch_floor_ms']:.4f} ms from launch to finish, so the larger of the two "
          f"is {k1['bound_with_launch_ms']:.4f} ms")
    print(f"K2 at [4,6144,512]: kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, "
          f"bound {k2['bound_ms']:.3f} ms ({k2['bound_by']}, 3xTF32; "
          f"{k2['bound_ffma_ms']:.3f} ms at the f32 rate), "
          f"F.scaled_dot_product_attention {k2['library_ms']:.3f} ms")
    k3, k4 = check_gn(gn, dev, gen)
    k5, k6 = check_conv(conv3x3, dev, gen)
    torch.cuda.empty_cache()
    r1, r2 = check_rans(rans_device, rans_host, Codec, dev)
    for r in (r1, r2):
        print(f"{r['name']} at lanes 128: kernel {r['ms']:.4f} ms ({r['ms_lanes512']:.4f} ms "
              f"at lanes 512), plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), dependent chain {r['chain_ms']:.4f} ms")
    torch.cuda.empty_cache()
    ops = (vq, attention, gn, conv3x3, rans_device)
    recon_names = (*gn.launches, *conv3x3.launches)

    t = time.perf_counter()
    opt = load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    spec = build_comp_model(opt)
    init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
    codec = Codec(spec, stream_format="compressai", params_backend="accel")
    print(f"flagship model: {sum(p.numel() for p in spec.module.parameters())} "
          f"parameters, built in {time.perf_counter() - t:.1f} s")

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 768, 512, 3), dtype=np.uint8)
    y_hat, default_launches, _ = counted_round_trip(
        codec, images, "compressai format, default path, batch 4 768x512", ops)
    if any(default_launches[k] for k in recon_names):
        raise AssertionError("the default path launched a reconstruction kernel")
    if default_launches["vq_argmin"] != 1 or default_launches["flash_attention"] < 1:
        raise AssertionError(f"the default path's launches: {default_launches}")

    img1 = rng.integers(0, 256, (1, 500, 740, 3), dtype=np.uint8)
    verify(codec, img1, *drive(codec, img1), "compressai format, default path, batch 1 500x740")
    check_codec_scope(codec, img1)

    # the tpu stream format on the same model: host and device encode backends
    tpu = {(backend, lanes): Codec(spec, encode_backend=backend, lanes=lanes)
           for backend, lanes in (("host", 128), ("device", 128), ("device", 512))}
    strings = {}
    for (backend, lanes), c in tpu.items():
        label = f"tpu format, {backend} backend, lanes {lanes}, batch 4 768x512"
        _, got, _ = counted_round_trip(c, images, label, ops)
        for k in ("vq_argmin", "flash_attention", *recon_names):
            if got[k] != default_launches[k]:
                raise AssertionError(f"{label}: {k} launched {got[k]} times, "
                                     f"{default_launches[k]} in the compressai format")
        res = c.compress(images, 0)
        strings[backend, lanes] = [r["string_list"] for r in res]
        for r in res:
            h = HeaderHandler.decode(r["string_list"][0])
            want = dict(stream_format="tpu", lanes=lanes, encode_batch=4, portable=False,
                        fast_entropy=False, bf16=False, t2free=True, img_size=(768, 512),
                        quality_ind=0)
            if len(r["string_list"][0]) != 9 or any(h[k] != v for k, v in want.items()):
                raise AssertionError(f"{label}: header {h}")
        print(f"{label}: header {HeaderHandler.decode(res[0]['string_list'][0])}; "
              f"pred_y_bpp {res[0]['pred_y_bpp']:.4f}, pred_z_bpp {res[0]['pred_z_bpp']:.4f}")
    if strings["host", 128] != strings["device", 128]:
        raise AssertionError("the host and device encode backends wrote different streams")
    print("tpu format: the host and device encode backends wrote identical strings")
    try:
        tpu["device", 128].decompress(strings["device", 128][:2])
    except ValueError as e:
        print(f"a batch-4 stream decoded as batch 2 raises: {str(e)[:90]}...")
    else:
        raise AssertionError("a batch-4 stream decoded as batch 2 did not raise")
    # the decode chain must not wait for the card: PyTorch raises on any
    # synchronising call while the debug mode is "error"
    c = tpu["device", 128]
    pipeline = c._decode_pipeline

    def no_sync(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return pipeline(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    probe = torch.ones(1, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        probe.cpu()
    except RuntimeError:
        pass                                   # the mode does see a fetch
    else:
        raise AssertionError("the sync debug mode let a device-to-host copy through")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    c._decode_pipeline = no_sync
    out_tpu = c.decompress(strings["device", 128])
    c._decode_pipeline = pipeline
    print("tpu format: the decode chain ran with torch.cuda.set_sync_debug_mode('error'): "
          "no host synchronisation between the upload and the final fetch")
    pending = tpu["device", 128].decompress(strings["host", 128], defer_fetch=True)
    if not np.array_equal(pending.fetch(), out_tpu):
        raise AssertionError("defer_fetch returned other images")

    # one warm round trip of each format, this run, this card
    codecs = {"compressai": codec, **{f"tpu/{b}/lanes {n}": c for (b, n), c in tpu.items()}}
    for name, c in codecs.items():
        res, _, enc, dec = drive(c, images)
        bpp = float(np.mean([r["bpp"] for r in res]))
        print(f"warm round trip, {name}: encode {enc:.4f} s, decode {dec:.4f} s "
              f"(one run), {bpp:.4f} bpp")
    for (backend, lanes), c in tpu.items():
        if backend == "device":
            cycle = c.bench_device_cycle(images, 0)
            print(f"bench_device_cycle, lanes {lanes}: encode chain {cycle['enc_s']:.4f} s, "
                  f"decode chain {cycle['dec_s']:.4f} s (device only, inputs on the card)")
    del tpu, codecs, pending
    torch.cuda.empty_cache()

    # the same model with every reconstruction kernel on, in both formats
    spec_k = build_comp_model(opt, recon_kernels=RECON_KERNELS)
    spec_k.module.load_state_dict(spec.module.state_dict(), strict=True)
    codec_k = Codec(spec_k, stream_format="compressai", params_backend="accel")
    _, launches_c, conv_shapes = counted_round_trip(
        codec_k, images, "compressai format, reconstruction kernels on, batch 4 768x512", ops)
    codec_kt = Codec(spec_k, encode_backend="device")
    _, launches, _ = counted_round_trip(
        codec_kt, images, "tpu format, device backend, reconstruction kernels on, "
        "batch 4 768x512", ops)
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for k in ("vq_argmin", "flash_attention", *recon_names):
        want = default_launches[k] if k in ("vq_argmin", "flash_attention") else launches_c[k]
        if launches[k] != want or launches_c[k] < 1:
            raise AssertionError(f"{k}: {launches[k]} launches in the tpu format with the "
                                 f"reconstruction kernels on, expected {want}")
    compare_models(codec, codec_k, images, y_hat)
    # the deployment workload's weights: the same seed, encoder scaled
    deployment_sd = scale_encoder(spec.module.state_dict())
    del codec, codec_k, codec_kt, spec, spec_k
    torch.cuda.empty_cache()

    print(json.dumps({"conv_launch_shapes": {
        name: [{"shape": list(shape), "launches": n} for shape, n in sorted(table.items())]
        for name, table in conv_shapes.items()}}))
    time_conv_shapes(conv3x3, conv_shapes["conv3x3_same"], dev, gen)

    bf16_kernels = check_bf16_kernels(gn, conv3x3, dev, gen)
    torch.cuda.empty_cache()

    launches16, shapes16 = check_deployment(deployment_sd, ops)
    path_rows = check_path_shapes(gn, conv3x3, shapes16, dev, gen)
    torch.cuda.empty_cache()

    launches_tiled, _ = check_tiled(opt, deployment_sd, ops, smi, dev, gen)
    torch.cuda.empty_cache()

    training = check_training(ops, smi, dev, gen)
    torch.cuda.empty_cache()

    launches_eval, _ = check_evaluation(opt, deployment_sd, ops, smi, dev)
    del deployment_sd
    torch.cuda.empty_cache()

    kernels = [k1, k2, k3, k4, k5, k6, r1, r2]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_bf16_batch16"] = launches16[k["name"]]
        k["launches_tiled_2048x1365"] = launches_tiled[k["name"]]
        k.update(training["kernels"].get(k["name"], {}))
        for phase, table in launches_eval.items():
            k[f"launches_eval_{phase.replace(' ', '_')}"] = table[k["name"]]
    for k in bf16_kernels:
        k["launches"] = launches16[k["name"][:-len("_bf16")]]
        k["path_shapes"] = [r for r in path_rows if r["name"] == k["name"]]
    kernels += bf16_kernels
    for k in kernels:
        if k["ms"] < k["bound_ms"]:
            raise AssertionError(f"{k['name']}: {k['ms']:.4f} ms is under its bound of "
                                 f"{k['bound_ms']:.4f} ms: the bound or the timing is wrong")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

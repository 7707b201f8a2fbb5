"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the environment, builds the CUDA kernels and the host rANS coder.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1 vq_argmin, K2 flash attention) and times both.
3. Drives the codec of the flagship model (config/dc_vic_patchgan.yaml,
   full width, random weights from a seed): a batch of four 768x512 images
   through Codec.compress -> bitstreams -> Codec.decompress, then one
   500x740 image. It checks that the decoder's y_hat equals the encoder's
   bitwise, that the decoded images equal the reconstruction of the
   encoder's y_hat, and that the path launched both kernels.

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


def check_vq(vq, dev, gen):
    """K1 against its plain version: random rows at the main-path M, a
    ragged M and exact-tie rows. Returns (max distance gap, ms, plain ms)."""
    import torch
    worst = 0.0
    near_ties = 0
    cb = torch.randn(256, 4, generator=gen, device=dev) * 0.05
    dup = cb.clone()
    dup[100], dup[255] = dup[7], dup[0]
    cases = [(torch.randn(4 * 96 * 64, 4, generator=gen, device=dev) * 0.05, cb),
             (torch.randn(1037, 4, generator=gen, device=dev) * 0.05, cb),
             (dup.repeat_interleave(8, 0), dup)]
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
    return worst, _time_ms(vq.vq_argmin, z, cb), _time_ms(vq.vq_argmin_plain, z, cb)


def check_attention(attention, dev, gen):
    """K2 against its plain version (atol = rtol = 1e-4: the summation
    order differs), first at the main path's shape [4, 6144, 512], where it
    is also timed. Returns (max abs error, ms, plain ms)."""
    import torch
    worst = 0.0
    timed = None
    for (B, N, C), scale in (((4, 6144, 512), 1.0), ((2, 6144, 512), 1.0),
                             ((1, 1000, 512), 1.0), ((1, 1024, 128), 3.0)):
        pre = C ** -0.5 if scale == 1.0 else scale
        q = torch.randn(B, N, C, generator=gen, device=dev) * pre
        k = torch.randn(B, N, C, generator=gen, device=dev) * scale
        v = torch.randn(B, N, C, generator=gen, device=dev)
        got = attention.flash_attention(q, k, v)
        want = attention.attention_plain(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention gave non-finite values at {(B, N, C)}")
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        print(f"K2 flash_attention [{B},{N},{C}] scores x{scale}: max abs err {err:.3e}")
        worst = max(worst, err)
        if timed is None:
            timed = (_time_ms(attention.flash_attention, q, k, v),
                     _time_ms(attention.attention_plain, q, k, v))
    return (worst, *timed)


def round_trip(codec, images, label):
    """compress -> decompress; checks the bitwise y_hat round trip and that
    the decoded images are the reconstruction of the encoder's y_hat."""
    import torch
    B, H, W = images.shape[:3]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codec.compress(images, 0, debug=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    strings = [r["string_list"] for r in res]
    out = codec.decompress(strings)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if out.shape != (B, H, W, 3) or out.dtype != np.uint8:
        raise AssertionError(f"{label}: decoded {out.shape} {out.dtype}")
    y_hat = np.stack([r["y_hat"] for r in res])
    if not np.isfinite(y_hat).all():
        raise AssertionError(f"{label}: non-finite y_hat")
    return res, strings, out, t1 - t0, t2 - t1


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on a GPU")
    sys.path.insert(0, ROOT)
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    from dc_vic_tpu_torch.ops import attention, native, vq
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
    for line in native.build_logs.get("libdcvic_kernels.so", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    vq_err, vq_ms, vq_plain_ms = check_vq(vq, dev, gen)
    at_err, at_ms, at_plain_ms = check_attention(attention, dev, gen)
    print(f"K1 at M=24576: kernel {vq_ms:.4f} ms, plain {vq_plain_ms:.4f} ms")
    print(f"K2 at [4,6144,512]: kernel {at_ms:.3f} ms, plain {at_plain_ms:.3f} ms")

    t = time.perf_counter()
    spec = build_comp_model(load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml")),
                            device=dev)
    init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
    codec = Codec(spec)
    print(f"flagship model: {sum(p.numel() for p in spec.module.parameters())} "
          f"parameters, built in {time.perf_counter() - t:.1f} s")

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 768, 512, 3), dtype=np.uint8)
    vq.launches = 0
    attention.launches = 0
    res, strings, out, enc_s, dec_s = round_trip(codec, images, "batch 4 768x512")
    launches = {"vq_argmin": vq.launches, "flash_attention": attention.launches}
    if not codec.verify_roundtrip(res, strings, (768, 512)):
        raise AssertionError("batch 4: decode-side y_hat differs from the encoder's")
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2))).to(dev)
    b1, b2 = codec._betas(0)
    with torch.no_grad():
        recon = codec.module.reconstruct_uint8(y_hat, b1, b2).permute(0, 2, 3, 1).cpu().numpy()
    if not np.array_equal(out, recon):
        raise AssertionError("batch 4: decoded images differ from reconstruct_uint8(y_hat)")
    bpp = float(np.mean([r["bpp"] for r in res]))
    print(f"batch 4 768x512: y_hat round trip bit-exact, {bpp:.4f} bpp, "
          f"encode {enc_s:.3f} s, decode {dec_s:.3f} s, launches {launches}")
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock
    expected = {"vq_argmin": 1, "flash_attention": sum(
        isinstance(m, VQAttnBlock) for m in spec.module.vq_model.modules())}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    img1 = rng.integers(0, 256, (1, 500, 740, 3), dtype=np.uint8)
    res1, strings1, _, enc1, dec1 = round_trip(codec, img1, "batch 1 500x740")
    if not codec.verify_roundtrip(res1, strings1, (500, 740)):
        raise AssertionError("batch 1: decode-side y_hat differs from the encoder's")
    print(f"batch 1 500x740: y_hat round trip bit-exact, {res1[0]['bpp']:.4f} bpp, "
          f"encode {enc1:.3f} s, decode {dec1:.3f} s")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "vq_argmin", "route": "cuda",
         "source": "dc_vic_tpu_torch/csrc/vq_argmin.cu",
         "replaces": "dc_vic_tpu/ops/vq.py:21", "launches": launches["vq_argmin"],
         "max_abs_err": vq_err, "ms": vq_ms, "plain_ms": vq_plain_ms},
        {"name": "flash_attention", "route": "cuda",
         "source": "dc_vic_tpu_torch/csrc/flash_attn_f32.cu",
         "replaces": "dc_vic_tpu/ops/attention.py:25",
         "launches": launches["flash_attention"],
         "max_abs_err": at_err, "ms": at_ms, "plain_ms": at_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

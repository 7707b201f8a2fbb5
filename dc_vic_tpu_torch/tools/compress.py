"""Compress (and optionally decompress) a directory of PNGs with the port:
the counterpart of ``scripts/compress.py``, with its flags and its outputs
(per-image ``.bin`` and, with ``--decompress``, ``.png``; ``_bitrates.csv``;
``_avg_bitrate.json``).

    python3 -m dc_vic_tpu_torch.tools.compress --config_path config/dc_vic_patchgan.yaml \\
        --img_dir photos/ --save_dir out/ -q 2 [--model_path ckpt.pth.tar] \\
        [--decompress] [--selfcheck] [--batch_size 4] [--device cuda]

Images are grouped into buckets of one raw resolution and batched per
bucket (``plan_buckets``). ``--model_path`` reads a released ``.pth.tar``
(its ``comp_model`` entry, ``module.`` prefixes stripped); without it the
weights are ``init_weights`` from seed 0. Pillow is needed only to read and
write the PNGs: ``compress_arrays`` is the whole codec run over images in
memory.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict
from glob import glob
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..codec.container import load_byte_strings, save_byte_strings
from ..codec.driver import Codec
from ..models import build_comp_model, init_weights
from ..models.convert import load_reference_state_dict
from ..utils.config import load_config

CSV_FIELDS = ("img_name", "header_bit", "z_bit", "y_bit", "real_bit", "real_bpp",
              "pred_bpp", "num_pixel")
# buffers a released compressai-style checkpoint carries beside the weights;
# the codec builds its tables itself
_TABLE_BUFFERS = ("_quantized_cdf", "_offset", "_cdf_length", "scale_table", "target")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None,
                   help="released checkpoint (.pth.tar, its 'comp_model' entry)")
    p.add_argument("--img_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("-q", "--quality", type=int, required=True)
    p.add_argument("--decompress", action="store_true")
    p.add_argument("--selfcheck", action="store_true",
                   help="verify that the decoder's latents equal the encoder's bit-exactly")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--portable", action=argparse.BooleanOptionalAction, default=True,
                   help="write streams that decode bit-exactly in any batch grouping "
                        "(default; --no-portable couples a stream to its encode batch)")
    p.add_argument("--stream_format", type=str, default="tpu", choices=["tpu", "compressai"],
                   help="tpu: device-coded streams; compressai: the reference's byte "
                        "format, coded on the host")
    p.add_argument("--params_backend", type=str, default=None, choices=["cpu", "accel"],
                   help="where the entropy parameters are derived (default: cpu for "
                        "compressai, so a stream decodes on any machine; accel for tpu)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    return p.parse_args(argv)


def plan_buckets(sizes, batch_size: int, stride: int = 64):
    """Group images into batched compression chunks, as
    ``scripts/compress.py`` does (``tests/test_torch_cli.py`` holds the two
    equal).

    sizes: list of (path, (width, height)) as PIL reports them. Images of one
    raw resolution are batched together (a compress() batch must share the
    exact raw shape), biggest first; chunks never exceed batch_size.

    Returns (chunks, n_buckets): chunks is a list of lists of paths, each
    chunk of one raw resolution; n_buckets counts the distinct padded shapes
    (the codec reflect-pads to a multiple of ``stride``)."""
    pad = lambda v: -(-v // stride) * stride
    by_raw = defaultdict(list)
    for p, (w, h) in sizes:
        by_raw[(h, w)].append(p)
    padded = {(pad(h), pad(w)) for h, w in by_raw}
    chunks = []
    bs = max(1, batch_size)
    # deterministic order: biggest buckets first (compile the expensive
    # graphs up front), then path order within
    for (h, w) in sorted(by_raw, key=lambda s: (-s[0] * s[1], s)):
        paths = sorted(by_raw[(h, w)])
        chunks.extend(paths[i:i + bs] for i in range(0, len(paths), bs))
    return chunks, len(padded)


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(path)


def load_checkpoint(module: torch.nn.Module, path: str) -> None:
    """Load a released ``.pth.tar`` into ``module``: its ``comp_model``
    entry if there is one, ``module.`` prefixes stripped, the entropy
    coders' table buffers dropped, everything else loaded strictly under
    the reference's names."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("comp_model", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    own = module.state_dict()
    sd = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in sd.items() if k in own or not k.endswith(_TABLE_BUFFERS)}
    load_reference_state_dict(module, sd)


def build_codec(config_path: str, model_path=None, device="cuda", stream_format="tpu",
                portable=True, params_backend=None) -> Codec:
    """The flags' codec: the config's model on ``device`` with the
    checkpoint's weights, or seed 0's."""
    spec = build_comp_model(load_config(config_path), device=device)
    if model_path:
        load_checkpoint(spec.module, model_path)
    else:
        init_weights(spec.module, torch.Generator(device=device).manual_seed(0))
    return Codec(spec, stream_format=stream_format, portable=portable,
                 params_backend=params_backend)


def compress_arrays(codec: Codec, images: Sequence[Tuple[str, np.ndarray]], quality: int,
                    save_dir: str, batch_size: int = 1, selfcheck: bool = False,
                    decompress: bool = False) -> Tuple[List[Dict], Dict[str, np.ndarray]]:
    """The CLI's run over named [H, W, 3] uint8 images in memory: bucket,
    compress, write each stream to ``save_dir/<name>.bin`` and the
    ``_bitrates.csv`` and ``_avg_bitrate.json`` of ``scripts/compress.py``;
    with ``selfcheck`` hold every batch's decoded latents to the encoder's
    (read back from the files), with ``decompress`` decode the files.
    Returns (the CSV rows, {name: decoded image} when ``decompress``)."""
    os.makedirs(save_dir, exist_ok=True)
    by_name = dict(images)
    chunks, n_buckets = plan_buckets(
        [(name, (a.shape[1], a.shape[0])) for name, a in images], batch_size)
    print(f"{len(images)} images -> {len(chunks)} chunks, {n_buckets} padded-shape buckets")
    rows, decoded = [], {}
    for chunk in chunks:
        imgs = np.stack([by_name[name] for name in chunk])
        H, W = imgs.shape[1:3]
        results = codec.compress(imgs, quality_ind=quality, debug=selfcheck)
        bin_paths = []
        for name, r in zip(chunk, results):
            bin_path = os.path.join(save_dir, os.path.splitext(name)[0] + ".bin")
            save_byte_strings(bin_path, r["string_list"])
            bin_paths.append(bin_path)
            nbytes = os.path.getsize(bin_path)
            sl = r["string_list"]
            rows.append({"img_name": name, "header_bit": len(sl[0]) * 8,
                         "z_bit": len(sl[1]) * 8, "y_bit": len(sl[2]) * 8,
                         "real_bit": nbytes * 8, "real_bpp": nbytes * 8 / (H * W),
                         "pred_bpp": r["pred_y_bpp"] + r["pred_z_bpp"], "num_pixel": H * W})
            print(f"{name}: {nbytes * 8 / (H * W):.5f} bpp")
        strings = [load_byte_strings(p) for p in bin_paths] if selfcheck or decompress else []
        if selfcheck:
            if not codec.verify_roundtrip(results, strings, (H, W)):
                raise RuntimeError("SELFCHECK FAILED: the decoder's latents differ from the "
                                   "encoder's")
            print(f"selfcheck ok ({len(chunk)} images)")
        if decompress:
            decoded.update(zip(chunk, codec.decompress(strings)))
    with open(os.path.join(save_dir, "_bitrates.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(CSV_FIELDS))
        w.writeheader()
        w.writerows(rows)
    avg_bpp = float(np.mean([r["real_bpp"] for r in rows]))
    with open(os.path.join(save_dir, "_avg_bitrate.json"), "w") as f:
        json.dump({"avg_bpp": avg_bpp}, f)
    print(f"avg_bpp: {avg_bpp:.5f}")
    return rows, decoded


def main(argv=None):
    args = parse_args(argv)
    paths = sorted(glob(os.path.join(args.img_dir, "*.png")))
    if not paths:
        raise SystemExit(f"no .png files in {args.img_dir}")
    codec = build_codec(args.config_path, args.model_path, args.device, args.stream_format,
                        args.portable, args.params_backend)
    _, decoded = compress_arrays(
        codec, [(os.path.basename(p), load_image(p)) for p in paths], args.quality,
        args.save_dir, args.batch_size, args.selfcheck, args.decompress)
    for name, img in decoded.items():
        save_image(os.path.join(args.save_dir, name), img)


if __name__ == "__main__":
    main()

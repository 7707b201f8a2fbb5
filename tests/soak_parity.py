"""The soak's RD stage through the JAX trainer and the port's, on the CPU,
from one seed: does the port train like the reference, and what do the
training images' JPEG files change?

    JAX_PLATFORMS=cpu python tests/soak_parity.py --iters 600 --eval_step 100 --out DIR

Runs of the small RD configuration of ``tests/test_torch_soak.py``
(``docs/artifacts/soak_stage1_1_config.yaml`` with the VQGAN, hyperprior,
context model and estimator narrowed; 64x64 images at batch 2), each
trainer built from the same options and seed (``--seed``: the weights'
initial draws, the batches and the noise; the images are always seed 0's):

* ``{jax,port}_jpeg``: the training images ``scripts/soak.py`` writes, JPEG
  at quality 92 (the TPU soak's data);
* ``{jax,port}_lossless``: the same pixels before JPEG, the port soak's
  ``.npy`` arrays written as PNG so that both trainers read the same files;
* ``portjaxinit_{jpeg,lossless}``: the port's trainer started from the JAX
  trainer's initial weights (``export_state_dict`` of its seeded init),
  which separates the two packages' initial draws from their training.

Every run evaluates on the script's PNGs (the port soak's eval arrays are
the same pixels). ``DIR`` receives each run's eval and loss CSVs (``<run>_s<seed>_*.csv``) and
``summary.json`` (runs of other invocations into the same ``DIR`` are
kept): J = W_RATE * bpp + W_DIST * mse_01 at every eval point,
PSNR and bpp, the last logged losses and the seconds of each run; with
``--init_stats`` (``--runs ''`` for that alone) the spread of the port's
initial weights against the JAX trainer's (``init_spread``).
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]
SIZE = 64      # the images' side: the small config's VQGAN resolution
THREADS = 4    # PyTorch's CPU threads a run, so that runs can share the CPU


def _script():
    spec = importlib.util.spec_from_file_location("tpu_soak_script",
                                                  os.path.join(ROOT, "scripts", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lossless(npy_root: str, out: str) -> str:
    """The port soak's training arrays as PNG files, same names."""
    from PIL import Image
    src = os.path.join(npy_root, "train_0")
    dst = os.path.join(out, "train_0")
    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        Image.fromarray(np.load(os.path.join(src, name))).save(
            os.path.join(dst, name[:-4] + ".png"))
    return out


def _opt(load_config, cfg: str, exp: str, work: str, train_root: str, eval_root: str,
         iters: int, eval_step: int, seed: int):
    opt = load_config(cfg, is_train=True)
    opt.update(exp=exp, ckpt_root=os.path.join(work, "checkpoint"), total_iter=iters,
               eval_step=eval_step, save_step=iters, keep_step=[iters],
               log_step=min(25, max(1, iters // 4)), seed=seed)
    opt["dataset"]["train_dataset"]["root_dir"] = train_root
    opt["dataset"]["eval_dataset"]["root_dir"] = eval_root
    return opt


def _jax_init(opt) -> dict:
    """The JAX trainer's initial weights for ``opt`` (its seed) as numpy
    arrays under the port's names."""
    import jax
    from dc_vic_tpu.models.convert import export_state_dict
    from dc_vic_tpu.train.trainer import build_trainer
    opt = copy.deepcopy(opt)
    opt["exp"] += "_jax_init"
    return export_state_dict(jax.device_get(build_trainer(opt).state.params))


def run(side: str, data: str, cfg: str, work: str, roots, eval_root: str, iters: int,
        eval_step: int, seed: int, out: str):
    """One trainer's run; its CSVs copied to ``out``; its summary."""
    if side == "jax":
        from dc_vic_tpu.train.trainer import build_trainer
        from dc_vic_tpu.utils.config import load_config
        from dc_vic_tpu.utils.paths import PathHandler
        build = build_trainer
    else:
        from dc_vic_tpu_torch.models.convert import load_reference_state_dict
        from dc_vic_tpu_torch.train.trainer import build_trainer
        from dc_vic_tpu_torch.utils.config import load_config
        from dc_vic_tpu_torch.utils.paths import PathHandler

        def build(opt):
            init = _jax_init(opt) if side == "portjaxinit" else None
            tr = build_trainer(opt, device="cpu")
            if init is not None:
                load_reference_state_dict(tr.model, init)
            return tr
    from dc_vic_tpu_torch.tools import soak
    exp = f"{side}_{data}_s{seed}"
    opt = _opt(load_config, cfg, exp, work, roots[data], eval_root, iters, eval_step, seed)
    paths = PathHandler(opt["ckpt_root"], exp)
    paths.make_job_dir()
    t = time.perf_counter()
    build(opt).train_loop()
    secs = time.perf_counter() - t
    for kind, path in (("eval", paths.eval_csv_path), ("loss", paths.loss_csv_path)):
        shutil.copy(path, os.path.join(out, f"{exp}_{kind}.csv"))
    ev, loss = soak.read_csv(paths.eval_csv_path), soak.read_csv(paths.loss_csv_path)
    return {"iters": [int(r["iter"]) for r in ev],
            "J": [soak.rd_objective(float(r["bpp"]), float(r["psnr"])) for r in ev],
            "psnr": [float(r["psnr"]) for r in ev], "bpp": [float(r["bpp"]) for r in ev],
            "last_loss": {k: float(v) for k, v in loss[-1].items() if v not in ("", None)},
            "seconds": secs}


def init_spread(cfg: str, work: str, roots, eval_root: str, seed: int) -> dict:
    """The port's initial weights against the JAX trainer's for one seed
    (different draws of what should be the same distributions): over the
    tensors of at least 256 values, the range of the ratio of their
    standard deviations and the largest offset of their means, in units of
    the JAX tensor's standard deviation."""
    from dc_vic_tpu_torch.train.trainer import build_trainer
    from dc_vic_tpu_torch.utils.config import load_config
    opt = _opt(load_config, cfg, f"init_s{seed}", work, roots["jpeg"], eval_root, 1, 1, seed)
    want = _jax_init(opt)
    got = {k: v.numpy() for k, v in build_trainer(opt, device="cpu").model.state_dict().items()}
    ratios, offsets = {}, {}
    for k, v in got.items():
        ref = np.asarray(want[k], np.float64).reshape(v.shape)
        if v.size >= 256 and ref.std() > 0:
            ratios[k] = float(v.std() / ref.std())
            offsets[k] = float(abs(v.mean() - ref.mean()) / ref.std())
    lo, hi = min(ratios, key=ratios.get), max(ratios, key=ratios.get)
    far = max(offsets, key=offsets.get)
    return {"tensors": len(got), "compared": len(ratios),
            "std_ratio_min": [lo, ratios[lo]], "std_ratio_max": [hi, ratios[hi]],
            "mean_offset_max": [far, offsets[far]]}


def _merge(path: str, runs: dict) -> None:
    """Add ``runs`` to the summary at ``path`` (runs of other processes kept)."""
    held = {}
    if os.path.exists(path):
        with open(path) as f:
            held = json.load(f)
    held.update(runs)
    with open(path, "w") as f:
        json.dump(held, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=600)
    p.add_argument("--eval_step", type=int, default=100)
    p.add_argument("--out", required=True)
    p.add_argument("--runs", default="jax_jpeg,jax_lossless,port_jpeg,port_lossless",
                   help="which runs, comma-separated (portjaxinit_{jpeg,lossless} too)")
    p.add_argument("--init_stats", action="store_true",
                   help="also compare the two packages' initial weights (init_spread)")
    p.add_argument("--seed", type=int, default=0,
                   help="the trainers' seed (init, batches, noise); the data's stays 0")
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(THREADS)
    from dc_vic_tpu_torch.tools import soak
    from test_torch_soak import _small_configs

    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="soak_parity_")
    summary_path = os.path.join(args.out, "summary.json")
    summary = {}
    try:
        jpeg_root, eval_root = _script().make_synthetic_dataset(
            os.path.join(work, "tpu"), size=SIZE)
        npy_root, _ = soak.make_synthetic_dataset(os.path.join(work, "port"), size=SIZE)
        roots = {"jpeg": jpeg_root, "lossless": _lossless(npy_root, os.path.join(work, "png"))}
        cfg = _small_configs(work)["rd"]
        if args.init_stats:
            summary[f"init_s{args.seed}"] = init_spread(cfg, work, roots, eval_root, args.seed)
            print(json.dumps(summary[f"init_s{args.seed}"]), flush=True)
            _merge(summary_path, {f"init_s{args.seed}": summary[f"init_s{args.seed}"]})
        for run_name in filter(None, args.runs.split(",")):
            side, data = run_name.split("_")
            name = f"{run_name}_s{args.seed}"
            summary[name] = run(side, data, cfg, work, roots, eval_root, args.iters,
                                args.eval_step, args.seed, args.out)
            summary[name].update(size=SIZE, eval_step=args.eval_step, seed=args.seed)
            print(name, json.dumps({k: summary[name][k] for k in ("J", "psnr", "bpp",
                                                                   "seconds")}), flush=True)
            _merge(summary_path, {name: summary[name]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return summary


if __name__ == "__main__":
    main()

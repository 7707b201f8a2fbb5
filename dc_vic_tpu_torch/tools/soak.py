"""Training soak with quality gates (port of ``scripts/soak.py``).

    python3 -m dc_vic_tpu_torch.tools.soak [--gan | --curriculum] --iters N --eval_step E \\
        [--work DIR] [--keep_work] [--config YAML] [--no_artifacts] [--device cuda|cpu] \\
        [--artifacts DIR] [--trace_dir DIR]

It writes a synthetic OpenImages-layout dataset from a seed and trains on
it, then gates on quality, not on the absence of NaNs alone:

* the RD soak (default): ``docs/artifacts/soak_stage1_1_config.yaml``, a
  mid-size stage 1_1-style model, with an eval every ``--eval_step``. The
  eval RD objective J = W_RATE * bpp + W_DIST * mse_01 (mse_01 from the eval
  PSNR) must improve from the first eval point to the last and must not rise
  (with J_SLACK) over at least MONOTONE_FRAC of the steps between eval
  points; fewer than MIN_EVAL_POINTS points raise.
* ``--gan``: ``docs/artifacts/soak_gan_config.yaml`` in two phases, the
  dual-beta RD stage, then a stage 1_3-style GAN fine-tune booted from it
  strictly with a fresh discriminator. Gates: no NaN skip in phase 2, its
  last d_loss inside D_LOSS_RANGE, eval PSNR at the (max, max) beta corner
  at most PSNR_DROP_GAN dB under phase 1's and bpp there within BPP_DRIFT.
* ``--curriculum``: the four stages chained with the real hand-off knobs:
  s1 stage 1_1-style (HyperpriorCharmVicModel), s2 dual-beta booted from s1
  with ``strict: false``, s3 the GAN stage booted strictly from s2 with a
  fresh discriminator, s4 stage 3-style (the selected beta pairs) booted
  strictly from s3 with its optimizer, learning rates 5e-5 and its warm
  discriminator. Ten gates, as the script's.

Every threshold is the script's. The gates are plain functions of the
CSV rows the trainer writes (``rd_gates``, ``gan_gates``,
``curriculum_gates``); the run functions return their verdicts and ``main``
exits non-zero when a gate fails. Each stage also records the median warm
seconds a step (host clock, each step ended by a wait for the card), the
peak device memory, the NaN skips counted step by step, and each kernel's
launches and Function backwards a step; ``--trace_dir`` adds, for each
RD stage, one warm step under ``utils/profiling.py::device_trace`` (device
time by kernel, and the card's idle share against an unprofiled step).
Curves and verdicts land in ``--artifacts`` (default
``dc_vic_tpu_torch/artifacts/soak_h100/{rd,gan,curriculum}/``).

Departures from the script: its training images were JPEG files at
quality 92 and its eval images PNGs; here both are ``.npy`` uint8 arrays of
the same pixels before any JPEG (the same generator and draws), since the
card machine has no image library. The script booted s4 with ``path``
alone, so the JAX trainer found neither the training state nor the
discriminator (``dc_vic_tpu/train/trainer.py:328-330``) and s4 started with
a fresh optimizer and discriminator; here s4 gets both paths and loads
them, as the script's ``load_optimizer``/``load_discriminator`` ask.
Every stage runs with all of ``RECON_KERNELS`` on, so each kernel whose
shape rule holds fires.
"""
from __future__ import annotations

import argparse
import copy
import csv
import json
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import RECON_KERNELS
from ..ops import counts
from ..train.trainer import build_trainer
from ..utils.config import load_config
from ..utils.logger import get_root_logger
from ..utils.paths import PathHandler
from ..utils.profiling import device_trace, kernel_report, kernel_times, sync

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(REPO, "dc_vic_tpu_torch", "artifacts", "soak_h100")
RD_CONFIG = os.path.join(REPO, "docs", "artifacts", "soak_stage1_1_config.yaml")
GAN_CONFIG = os.path.join(REPO, "docs", "artifacts", "soak_gan_config.yaml")

W_RATE, W_DIST = 0.04, 50.0  # stage1_1 training weights (exp1_stage1_1)
MIN_EVAL_POINTS = 6          # the RD soak's eval points
MONOTONE_FRAC = 0.7          # share of eval steps over which J may not rise
J_SLACK = 1e-4               # a step "does not rise" if J_next <= J + J_SLACK
D_LOSS_RANGE = (0.05, 3.0)   # vanilla-GAN equilibrium 2 ln 2; ~0 collapse, large divergence
PSNR_DROP_GAN = 1.5          # dB the GAN phase may lose at the (max, max) corner
PSNR_DROP_S4 = 1.0           # dB s4 may lose against s3
BPP_DRIFT = 0.10             # relative bpp move at the corner (entropy path frozen)
CORNER_ORDER_SLACK = 1.05    # s2: the high-beta corner emits at most 5% more bits
SELECTED_BETA_RATE = [2.29, 1.51, 1.12, 0.62, 0.16]
SELECTED_BETA_VQ = [3.00, 2.25, 2.00, 1.50, 1.00]
NEW_LR = 5e-5                # s4's new generator and discriminator learning rate
WARM_FROM = 5                # steps before the first warm one
# the package's own kernels (K1-K6, R1/R2) by device kernel name
OWN_KERNELS = ("vq_argmin", "flash_attn", "gn_channel_sums", "gn_apply", "conv3x3", "rans_")
# s1's transforms (scripts/soak.py:254-266): the dual-beta ones' widths, no betas
S1_ENCODER = {"type": "ElicVqCatScEncoder", "in_ch": 3, "out_ch": 96, "main_ch": 64,
              "block_mid_ch": 32, "input_feat_ch": 260, "proj_init": False}
S1_DECODER = {"type": "ElicFeatFusionDecoder", "in_ch": 96, "out_ch": 3, "main_ch": 64,
              "block_mid_ch": 32, "use_tanh": False, "feat_layer_name": "block1",
              "fusion_layer_dict": {"block1": "block_1_8", "block2": "block_1_4",
                                    "block3": "block_1_2"}}


def make_synthetic_dataset(root: str, n_train: int = 192, n_eval: int = 12,
                           size: int = 256, seed: int = 0):
    """OpenImages-layout synthetic data: smooth multi-scale content plus
    noise, every training image and then every eval image from one
    ``default_rng(seed)``, as ``scripts/soak.py`` draws them. Written as
    ``.npy`` uint8 HWC: ``openimage/train_0/img%04d.npy`` and
    ``kodak/kodim%02d.npy`` (the script saved the same pixels as JPEG at
    quality 92 and as PNG). Returns (training root, eval root)."""
    rng = np.random.default_rng(seed)

    def img(h, w):
        yy, xx = np.meshgrid(np.linspace(0, 4, h), np.linspace(0, 4, w), indexing="ij")
        f1, f2, p = rng.uniform(0.5, 2.5, 3)
        base = (np.stack([np.sin(yy * f1 + p * k) * np.cos(xx * f2 + k)
                          for k in range(3)], -1) + 1) * 110
        return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)

    tr = os.path.join(root, "openimage", "train_0")
    ev = os.path.join(root, "kodak")
    os.makedirs(tr, exist_ok=True)
    os.makedirs(ev, exist_ok=True)
    for i in range(n_train):
        np.save(os.path.join(tr, f"img{i:04d}.npy"), img(size, size))
    for i in range(n_eval):
        np.save(os.path.join(ev, f"kodim{i:02d}.npy"), img(size, size))
    return os.path.join(root, "openimage"), ev


def rd_objective(bpp: float, psnr: float) -> float:
    mse_01 = 10.0 ** (-psnr / 10.0)  # PSNR on [0,1]-range images
    return W_RATE * bpp + W_DIST * mse_01


# ------------------------------------------------------------------ gates
def read_csv(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f))


def corner(rows: List[Dict], which: str = "max") -> List[Dict]:
    """The rows at the (max, max) (or (min, min)) beta corner; rows without
    betas pass through."""
    if not rows or not rows[0].get("beta_rate"):
        return rows
    betas = sorted({(float(r["beta_rate"]), float(r["beta_vq"])) for r in rows})
    pick = betas[-1] if which == "max" else betas[0]
    return [r for r in rows if (float(r["beta_rate"]), float(r["beta_vq"])) == pick]


def _skips(loss_rows: List[Dict]) -> float:
    """The script's NaN-skip count: the sum of the logged window means."""
    return sum(float(r.get("skipped") or 0) for r in loss_rows)


def _d_loss_sane(d: float) -> bool:
    return bool(np.isfinite(d) and D_LOSS_RANGE[0] < d < D_LOSS_RANGE[1])


def rd_gates(eval_rows: List[Dict]) -> Dict:
    """The RD soak's gate on its eval rows: J improves from the first point
    to the last, and does not rise over at least MONOTONE_FRAC of the steps.
    Raises with fewer than MIN_EVAL_POINTS points."""
    if len(eval_rows) < MIN_EVAL_POINTS:
        raise ValueError(f"need >= {MIN_EVAL_POINTS} eval points, got {len(eval_rows)}")
    js = [rd_objective(float(r["bpp"]), float(r["psnr"])) for r in eval_rows]
    steps_down = sum(b <= a + J_SLACK for a, b in zip(js, js[1:]))
    frac = steps_down / (len(js) - 1)
    improved = bool(js[-1] < js[0])
    return {"J": [round(j, 4) for j in js], "improved": improved, "monotone_frac": frac,
            "gates": {"improved": improved, "monotone": bool(frac >= MONOTONE_FRAC)}}


def gan_gates(p1_psnr: float, p1_bpp: float, eval_rows: List[Dict],
              loss_rows: List[Dict]) -> Dict:
    """The GAN soak's four gates: phase 2's eval and loss rows against
    phase 1's PSNR and bpp at the (max, max) corner."""
    skipped = _skips(loss_rows)
    d_last = float(loss_rows[-1]["d_loss"])
    p2 = corner(eval_rows)[-1]
    psnr, bpp = float(p2["psnr"]), float(p2["bpp"])
    return {"phase1": {"psnr": p1_psnr, "bpp": p1_bpp},
            "phase2": {"psnr": psnr, "bpp": bpp, "d_loss": d_last, "skipped": skipped},
            "gates": {"zero_nan_skips": skipped == 0,
                      "d_loss_sane": _d_loss_sane(d_last),
                      "psnr_holds": psnr >= p1_psnr - PSNR_DROP_GAN,
                      "bpp_frozen": abs(bpp - p1_bpp) <= BPP_DRIFT * max(p1_bpp, 1e-6)}}


def curriculum_gates(e1, e2, e3, l3, e4, l4) -> Dict:
    """The curriculum's ten gates from its stages' eval rows (e*) and the
    GAN stages' loss rows (l3, l4): {"stages": values, "gates": bools}."""
    stages, gates = {}, {}
    j1 = [rd_objective(float(r["bpp"]), float(r["psnr"])) for r in e1]
    stages["s1"] = {"J": [round(j, 4) for j in j1]}
    gates["s1_J_improves"] = bool(j1[-1] < j1[0])

    cmax, cmin = corner(e2, "max"), corner(e2, "min")
    j2 = [rd_objective(float(r["bpp"]), float(r["psnr"])) for r in cmax]
    bpp_hi, bpp_lo = float(cmax[-1]["bpp"]), float(cmin[-1]["bpp"])
    s2_psnr, s2_bpp = float(cmax[-1]["psnr"]), bpp_hi
    stages["s2"] = {"corner_J": [round(j, 4) for j in j2], "bpp_maxbeta": bpp_hi,
                    "bpp_minbeta": bpp_lo}
    gates["s2_corner_J_improves"] = bool(j2[-1] < j2[0])
    # exp(beta_rate) rate weighting: the high-beta corner must emit fewer bits
    gates["s2_beta_corners_ordered"] = bool(bpp_hi <= bpp_lo * CORNER_ORDER_SLACK)

    c3 = corner(e3)
    s3_skip, s3_d = _skips(l3), float(l3[-1]["d_loss"])
    s3_psnr, s3_bpp = float(c3[-1]["psnr"]), float(c3[-1]["bpp"])
    stages["s3"] = {"d_loss": s3_d, "skipped": s3_skip, "psnr": s3_psnr, "bpp": s3_bpp}
    gates.update(
        s3_zero_nan_skips=bool(s3_skip == 0),
        s3_d_loss_sane=_d_loss_sane(s3_d),
        s3_psnr_holds=bool(s3_psnr >= s2_psnr - PSNR_DROP_GAN),
        s3_bpp_frozen=bool(abs(s3_bpp - s2_bpp) <= BPP_DRIFT * max(s2_bpp, 1e-6)))

    s4_skip, s4_d = _skips(l4), float(l4[-1]["d_loss"])
    s4_psnr = float(corner(e4)[-1]["psnr"])
    stages["s4"] = {"d_loss": s4_d, "skipped": s4_skip, "psnr": s4_psnr}
    gates.update(
        s4_zero_nan_skips=bool(s4_skip == 0),
        s4_d_loss_sane=_d_loss_sane(s4_d),
        s4_psnr_holds=bool(s4_psnr >= s3_psnr - PSNR_DROP_S4))
    return {"stages": stages, "gates": gates}


# ------------------------------------------------------------------ runs
@dataclass
class StageRun:
    """One stage's trainer run: its options, paths, CSV rows and
    measurements."""
    opt: Dict
    paths: PathHandler
    eval_rows: List[Dict[str, str]]
    loss_rows: List[Dict[str, str]]
    stats: Dict

    def checkpoint(self, label: str, itr: int) -> str:
        return self.paths.checkpoint_path(label, itr)


def kernel_counts() -> Dict[str, int]:
    """Every kernel's launches, and its Function's backwards
    (``<name>_backward``), from the wrappers' counters (``ops/counts.py``:
    launches on the card only)."""
    return {**counts.launches(),
            **{f"{k}_backward": n for k, n in counts.backwards().items()}}


def _instrument(trainer, record: Dict) -> None:
    """Wrap ``trainer.step``: each step's host seconds ending in a wait for
    the card, its skip, and each kernel's launches and backwards in it."""
    step = trainer.step

    def timed(batch):
        before = kernel_counts()
        t = time.perf_counter()
        terms = step(batch)
        sync(batch)
        record["secs"].append(time.perf_counter() - t)
        record["skips"] += int(float(terms["skipped"]) > 0)
        record["launches"].append({k: n - before[k] for k, n in kernel_counts().items()})
        return terms

    trainer.step = timed


def _per_step(steps: List[Dict[str, int]]) -> Dict[str, object]:
    """Each kernel's count a step: the one value every step gave, else the
    list of distinct values."""
    out = {}
    for k in steps[0]:
        distinct = sorted({s[k] for s in steps})
        out[k] = distinct[0] if len(distinct) == 1 else distinct
    return out


def _handoff(trainer) -> Optional[Dict]:
    """What the stage's boot took (``Trainer.restored``): the tensors
    carried out of the model's, the keys left at their initialisation, and
    whether the optimizer states and the discriminator came along."""
    r = trainer.restored
    if r is None:
        return None
    carried = set(r["carried"])
    return {"strict": r["strict"], "carried": len(carried), "total": r["total"],
            "kept_init": sorted(k for k in trainer.model.state_dict() if k not in carried),
            "optimizer": r["optimizer"], "discriminator": r["discriminator"]}


def profile_step(trainer, trace_dir: str) -> Dict:
    """One warm step of ``trainer``'s stage unprofiled (host clock, ended by
    a wait for the card), then one under ``device_trace``: the device time by
    kernel and the card's idle share against the unprofiled step."""
    data = trainer.train_loader.infinite()
    try:
        batch = trainer._to_device(next(data)["real_images"])
        secs = []
        for _ in range(3):
            sync(batch)
            t = time.perf_counter()
            trainer.step(batch)
            sync(batch)
            secs.append(time.perf_counter() - t)
        with device_trace(trace_dir) as prof:
            trainer.step(batch)
            sync(batch)
    finally:
        data.close()
    times = kernel_times(prof)
    device_ms = sum(us for us, _ in times.values()) / 1e3
    step_s = float(np.median(secs[1:]))
    own = {name: (us / 1e3, n) for name, (us, n) in times.items()
           if any(k in name for k in OWN_KERNELS)}
    return {"step_s": step_s, "device_ms": device_ms,
            "launches": sum(n for _, n in times.values()),
            "idle_share": 1.0 - device_ms / 1e3 / step_s if step_s > 0 else None,
            "own_kernels_ms": {k: v[0] for k, v in own.items()},
            "report": kernel_report(times, top=15)}


def base_opt(cfg_path: str, exp: str, args, train_root: str, eval_root: str):
    """The soak's overrides of a stage config: its experiment, checkpoints
    under the work directory, the iteration cadence, the synthetic data and
    every reconstruction kernel on."""
    opt = load_config(cfg_path, is_train=True)
    iters = args.iters
    opt["exp"] = exp
    opt["ckpt_root"] = os.path.join(args.work, "checkpoint")
    opt["total_iter"] = iters
    opt["eval_step"] = args.eval_step
    opt["save_step"] = iters
    opt["keep_step"] = [iters]
    opt["log_step"] = min(25, max(1, iters // 4))
    opt["dataset"]["train_dataset"]["root_dir"] = train_root
    opt["dataset"]["eval_dataset"]["root_dir"] = eval_root
    opt["recon_kernels"] = list(RECON_KERNELS)
    return opt


def run_stage(opt, args) -> StageRun:
    """Build the stage's trainer on ``args.device``, run its loop, copy its
    curves to the artifacts."""
    paths = PathHandler(opt["ckpt_root"], opt["exp"])
    paths.make_job_dir()
    get_root_logger(paths.log_path)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = build_trainer(copy.deepcopy(opt), device=args.device)
    record = {"secs": [], "skips": 0, "launches": []}
    _instrument(trainer, record)
    trainer.train_loop()
    secs = record["secs"]
    warm = secs[WARM_FROM:] if len(secs) > WARM_FROM else secs[1:] or secs
    stats = {"steps": len(secs), "median_warm_s_per_it": float(np.median(warm)),
             "warm_s_per_it_quartiles": [float(q) for q in np.percentile(warm, (25, 75))],
             "wall_s": time.perf_counter() - t0, "nan_skips": record["skips"],
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None,
             "launches_per_step": _per_step(record["launches"]),
             "handoff": _handoff(trainer)}
    if args.trace_dir and not trainer.gan:
        stats["profile"] = profile_step(trainer, os.path.join(args.trace_dir, opt["exp"]))
    del trainer.step   # the wrappers hold the trainer: let it go with the last reference
    del trainer
    if cuda:
        torch.cuda.empty_cache()
    run = StageRun(opt, paths, read_csv(paths.eval_csv_path), read_csv(paths.loss_csv_path),
                   stats)
    if not args.no_artifacts:
        os.makedirs(args.out, exist_ok=True)
        shutil.copy(paths.eval_csv_path, os.path.join(args.out, f"{opt['exp']}_eval.csv"))
        shutil.copy(paths.loss_csv_path, os.path.join(args.out, f"{opt['exp']}_loss.csv"))
    fired = {k: n for k, n in stats["launches_per_step"].items() if n}
    print(f"{opt['exp']}: {stats['steps']} steps, median warm "
          f"{stats['median_warm_s_per_it']:.4f} s/it, NaN skips {stats['nan_skips']}, "
          f"launches a step {fired}"
          + ("" if stats["peak_gib"] is None else f", peak {stats['peak_gib']:.2f} GiB"),
          flush=True)
    return run


def _gan_overrides(opt, load: Dict) -> None:
    """Phase 2 / s3: the GAN stage's trainer, the loss without the rate term
    plus the vanilla GAN loss at 0.01, booted by ``load``."""
    opt["trainer"] = {"type": "DualBetaCondGanDistortionVqCodeTrainer"}
    loss = {k: v for k, v in dict(opt["loss"]).items() if k != "rate_loss"}
    loss["gan_loss"] = {"type": "VanillaGANLoss", "loss_weight": 0.01}
    opt["loss"] = loss
    opt["load_checkpoint"] = load


def _strict_fresh_d(run: StageRun, iters: int) -> Dict:
    return {"path": run.checkpoint("comp_model", iters), "load_optimizer": False,
            "load_scheduler": False, "load_discriminator": False, "strict": True}


def run_rd_soak(args, train_root: str, eval_root: str) -> Tuple[Dict, Dict[str, StageRun]]:
    """The stage 1_1-style RD soak and its J gate: (verdict, {exp: run})."""
    run = run_stage(base_opt(args.config or RD_CONFIG, "soak_r3", args, train_root, eval_root),
                    args)
    verdict = {"mode": "rd", "iters": args.iters, "eval_step": args.eval_step,
               **rd_gates(run.eval_rows), "runs": {"soak_r3": run.stats}}
    print(f"eval RD objective J (w_rate*bpp + w_dist*mse01): {verdict['J']}")
    print(f"J improved first->last: {verdict['improved']}; non-increasing steps: "
          f"{verdict['monotone_frac']:.0%}", flush=True)
    return verdict, {"soak_r3": run}


def run_gan_soak(args, train_root: str, eval_root: str) -> Tuple[Dict, Dict[str, StageRun]]:
    """Phase 1, the dual-beta RD stage of ``soak_gan_config.yaml``; phase 2,
    the GAN fine-tune booted strictly from it with a fresh discriminator;
    the four gates: (verdict, {exp: run})."""
    cfg = args.config or GAN_CONFIG
    iters = args.iters
    p1 = run_stage(base_opt(cfg, "soak_gan_p1", args, train_root, eval_root), args)
    h = corner(p1.eval_rows)[-1]
    p1_psnr, p1_bpp = float(h["psnr"]), float(h["bpp"])
    print(f"phase 1 handoff (max-beta corner): psnr={p1_psnr:.2f} bpp={p1_bpp:.4f}")

    o2 = base_opt(cfg, "soak_gan_p2", args, train_root, eval_root)
    _gan_overrides(o2, _strict_fresh_d(p1, iters))
    p2 = run_stage(o2, args)
    verdict = {"mode": "gan", "iters": iters, "eval_step": args.eval_step,
               **gan_gates(p1_psnr, p1_bpp, p2.eval_rows, p2.loss_rows),
               "runs": {"soak_gan_p1": p1.stats, "soak_gan_p2": p2.stats}}
    print(f"phase 2 end: {verdict['phase2']} (phase 1 {verdict['phase1']})")
    print("gates:", verdict["gates"], flush=True)
    return verdict, {"soak_gan_p1": p1, "soak_gan_p2": p2}


def run_curriculum(args, train_root: str, eval_root: str) -> Tuple[Dict, Dict[str, StageRun]]:
    """The four stages chained with their hand-off knobs, and the ten gates:
    (verdict, {"s1": run, ..., "s4": run})."""
    cfg = args.config or GAN_CONFIG
    iters = args.iters
    runs = {}

    o1 = base_opt(cfg, "cur_s1", args, train_root, eval_root)
    o1["trainer"] = {"type": "RateDistortionVqCodeTrainer"}
    o1["model"] = {"type": "HyperpriorCharmVicModel", "enc_vq_input": "onehot_indices"}
    o1["subnet"]["encoder"] = dict(S1_ENCODER)
    o1["subnet"]["decoder"] = dict(S1_DECODER)
    runs["s1"] = run_stage(o1, args)

    o2 = base_opt(cfg, "cur_s2", args, train_root, eval_root)
    o2["load_checkpoint"] = {"path": runs["s1"].checkpoint("comp_model", iters),
                             "load_optimizer": False, "load_scheduler": False,
                             "strict": False}  # cross-architecture partial restore
    runs["s2"] = run_stage(o2, args)

    o3 = base_opt(cfg, "cur_s3", args, train_root, eval_root)
    _gan_overrides(o3, _strict_fresh_d(runs["s2"], iters))
    runs["s3"] = run_stage(o3, args)

    o4 = base_opt(cfg, "cur_s4", args, train_root, eval_root)
    _gan_overrides(o4, {
        "path": runs["s3"].checkpoint("comp_model", iters),
        "training_state_path": runs["s3"].checkpoint("training_state", iters),
        "discriminator_path": runs["s3"].checkpoint("discriminator", iters),
        "load_optimizer": True, "load_scheduler": False, "load_discriminator": True,
        "new_g_lr": NEW_LR, "new_d_lr": NEW_LR, "strict": True})
    o4["model"]["use_selected_beta_pairs"] = True
    o4["model"]["selected_beta_rate"] = list(SELECTED_BETA_RATE)
    o4["model"]["selected_beta_vq"] = list(SELECTED_BETA_VQ)
    runs["s4"] = run_stage(o4, args)

    verdict = {"mode": "curriculum", "iters_per_stage": iters, "eval_step": args.eval_step,
               **curriculum_gates(runs["s1"].eval_rows, runs["s2"].eval_rows,
                                  runs["s3"].eval_rows, runs["s3"].loss_rows,
                                  runs["s4"].eval_rows, runs["s4"].loss_rows),
               "runs": {k: r.stats for k, r in runs.items()}}
    print("curriculum stages:", verdict["stages"])
    print("curriculum gates:", verdict["gates"], flush=True)
    return verdict, runs


def card_name() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the card, or None."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--eval_step", type=int, default=500)
    p.add_argument("--work", type=str, default=None,
                   help="work directory for data and checkpoints (default: a new "
                        "temporary directory)")
    p.add_argument("--keep_work", action="store_true")
    p.add_argument("--gan", action="store_true",
                   help="the two-phase RD -> GAN soak (docs/artifacts/soak_gan_config.yaml)")
    p.add_argument("--curriculum", action="store_true",
                   help="the four-stage curriculum (s1 RD -> s2 dual-beta -> s3 GAN -> s4 "
                        "selected-pairs GAN) with its hand-off knobs")
    p.add_argument("--config", type=str, default=None,
                   help="another soak config (default: the committed one of the mode)")
    p.add_argument("--no_artifacts", action="store_true",
                   help="write no curves or verdict (plumbing runs)")
    p.add_argument("--artifacts", type=str, default=ARTIFACTS,
                   help="where curves and verdicts land, in a folder per mode")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="profile one warm step of each RD stage, traces under this folder")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("soak: CUDA is not available; pass --device cpu to run on the CPU")
    if args.gan and args.curriculum:
        p.error("--gan and --curriculum exclude each other")
    mode = "curriculum" if args.curriculum else "gan" if args.gan else "rd"
    args.out = os.path.join(args.artifacts, mode)
    if args.work is None:
        args.work = tempfile.mkdtemp(prefix="dcvic_soak_")

    try:
        t0 = time.perf_counter()
        train_root, eval_root = make_synthetic_dataset(os.path.join(args.work, "datasets"))
        run = {"rd": run_rd_soak, "gan": run_gan_soak, "curriculum": run_curriculum}[mode]
        verdict, _ = run(args, train_root, eval_root)
        verdict["passed"] = all(verdict["gates"].values())
        verdict["seconds"] = time.perf_counter() - t0
        verdict["device"] = (card_name() or torch.cuda.get_device_name(0)
                             if torch.device(args.device).type == "cuda" else args.device)
        if not args.no_artifacts:
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, "verdict.json"), "w") as f:
                json.dump(verdict, f, indent=1)
    finally:
        if not args.keep_work:
            shutil.rmtree(args.work, ignore_errors=True)
    print(json.dumps({"passed": verdict["passed"], "gates": verdict["gates"]}))
    if not verdict["passed"]:
        raise SystemExit(f"{mode.upper()} SOAK GATES FAILED: {verdict['gates']}")
    print(f"{mode} soak gates passed")
    return verdict


if __name__ == "__main__":
    main()

"""Stage trainers (port of dc_vic_tpu/train/trainer.py, the dual-beta
stages of the curriculum on one card):

  DualBetaCondRateDistortionVqCodeTrainer  stage 1_2 (rd_step)
  DualBetaCondGanDistortionVqCodeTrainer   stages 1_3 and 3 (gan_step)

The loop keeps the reference's cadence: log every ``log_step``, validate
every ``eval_step``, save every ``save_step``; the skip of a non-finite step
happens on the device. A stage boots from the previous stage's checkpoint
through ``load_checkpoint`` (``exp``/``iter`` or ``path``, ``strict``,
``load_optimizer``, ``load_scheduler``, ``load_discriminator``,
``new_g_lr``/``new_d_lr``).

Numerics: the steps and the validation run inside ``backend_flags`` with
TF32 off (the stage configs train in f32) and cuDNN free to benchmark its
algorithms (``_FLAGS``); the process's settings are left as they were.
``recon_kernels`` in the config chooses the reconstruction kernels
(``build_comp_model``).
"""
from __future__ import annotations

import importlib
import importlib.util
import os
from typing import Dict

import numpy as np
import torch

from ..data.datasets import build_dataset
from ..data.loader import HostDataLoader
from ..metrics.feature_nets import load_lpips
from ..metrics.image import calc_ms_ssim, calc_psnr
from ..models import build_comp_model, init_weights
from ..models.dc_vic import pad_image
from ..models.discriminators import build_discriminator, init_discriminator
from ..utils.backends import backend_flags
from ..utils.logger import AvgMeter, CSVLogger, bolded_log, get_root_logger
from ..utils.paths import PathHandler
from ..utils.registry import TRAINER_REGISTRY
from ..utils.timer import Timer
from .losses import build_loss
from .optim import (aux_mask, build_optimizer, main_mask, masked_params,
                    reset_schedule_counts)
from .saver import Saver
from .steps import BetaPolicy, TrainState, gan_step, rd_step

# the backend settings of the trainer's calls: f32 products without TF32;
# the step's shapes repeat, so cuDNN may pick its algorithms by timing them
_FLAGS = dict(allow_tf32=False, deterministic=False, benchmark=True)


class Trainer:
    """One stage of the curriculum; ``gan`` selects the GAN step."""

    def __init__(self, opt, gan: bool = False, device="cuda"):
        self.opt = opt
        self.gan = gan
        self.device = torch.device(device)
        self.logger = get_root_logger()
        self.paths = PathHandler(opt.get("ckpt_root", "./checkpoint"), opt.get("exp", "exp"))
        self.paths.make_job_dir()

        self.spec = build_comp_model(opt, self.device,
                                     recon_kernels=tuple(opt.get("recon_kernels") or ()))
        self.model = self.spec.module.train()
        self.losses = {k: build_loss(v) for k, v in dict(opt.get("loss") or {}).items()
                       if isinstance(v, dict) and v.get("type")}
        self._set_lpips()
        self._set_data()
        self._set_state()
        self._set_loggers()

    # ------------------------------------------------------------------
    def _set_data(self):
        dcfg = self.opt["dataset"]
        self.batch_size = dcfg.get("batch_size", 6)
        self.train_loader = HostDataLoader(
            build_dataset(dcfg["train_dataset"], is_train=True), self.batch_size,
            num_workers=8, seed=self.opt.get("seed", 0))
        self.eval_loader = HostDataLoader(
            build_dataset(dcfg["eval_dataset"], is_train=False), 1, num_workers=1)

    def _set_lpips(self):
        """LPIPS on the trainer's device when the perceptual loss is
        configured with weights (``loss.perceptual_loss.weights_path`` or a
        top-level ``lpips_weights``); without them the loss takes its
        gradient-L1 proxy, as the JAX package's does, and says so."""
        self.lpips_fn = None
        if "perceptual_loss" not in self.losses:
            return
        pl_cfg = dict((self.opt.get("loss") or {}).get("perceptual_loss") or {})
        self.lpips_fn = load_lpips(pl_cfg.get("weights_path") or self.opt.get("lpips_weights"),
                                   net=pl_cfg.get("net", "alex"), device=self.device)
        calibrated = self.lpips_fn is not None
        log = self.logger.info if calibrated else self.logger.warning
        log(f"perceptual_loss calibrated={calibrated}"
            + ("" if calibrated else " — LPIPS weights missing, using gradient-L1 proxy"))

    def _set_state(self):
        opt = self.opt
        optim = opt.get("optim") or {}
        load_cfg = dict(opt.get("load_checkpoint") or {})
        g_opt_cfg = dict(optim.get("g_optimizer", {"lr": 1e-4}))
        d_opt_cfg = dict(optim.get("d_optimizer", optim.get("g_optimizer", {})))
        if load_cfg.get("load_optimizer", True):
            if load_cfg.get("new_g_lr") is not None:
                g_opt_cfg["lr"] = float(load_cfg["new_g_lr"])
            if load_cfg.get("new_d_lr") is not None:
                d_opt_cfg["lr"] = float(load_cfg["new_d_lr"])
        clip = optim.get("clip_max_norm")

        gen = torch.Generator(device=self.device).manual_seed(int(opt.get("seed", 0)))
        init_weights(self.model, gen)
        names = [n for n, _ in self.model.named_parameters()]
        self.main_mask = main_mask(names, gan_stage=self.gan)
        self.aux_mask = aux_mask(names)
        for n, p in self.model.named_parameters():
            p.requires_grad_(self.main_mask[n] or (self.aux_mask[n] and not self.gan))
        g_opt = build_optimizer(masked_params(self.model, self.main_mask), g_opt_cfg,
                                optim.get("g_scheduler"), clip)
        aux_opt = build_optimizer(masked_params(self.model, self.aux_mask),
                                  optim.get("aux_optimizer", {"lr": 1e-3}))

        model_cfg = dict(opt.get("model") or {})
        trainer_cfg = dict(opt.get("trainer") or {})
        enc_cfg = dict(opt["subnet"]["encoder"])
        self.policy = BetaPolicy(
            use_beta=True,
            use_selected_pairs=model_cfg.get("use_selected_beta_pairs", False),
            selected_beta_rate=tuple(model_cfg.get("selected_beta_rate") or ()),
            selected_beta_vq=tuple(model_cfg.get("selected_beta_vq") or ()),
            max_beta_rate=enc_cfg.get("max_beta_1") or 3.0,
            max_beta_vq=enc_cfg.get("max_beta_2") or 3.5,
            num_levels=model_cfg.get("num_beta_levels", 100),
            sample_batch_beta=(trainer_cfg.get("sample_beta_batch")
                               or model_cfg.get("sample_batch_beta", False)),
            # the reference's default is 'linear' with offset 1.0; the shipped
            # configs set exp
            weight_type=(trainer_cfg.get("beta_policy")
                         or model_cfg.get("beta_weight_type", "linear")),
            weight_offset=trainer_cfg.get("beta_offset", 1.0))
        self.mc_sampling = trainer_cfg.get("mc_sampling", False)
        self.y_hat_cond = trainer_cfg.get("y_hat_cond", False)

        disc = d_opt = None
        if self.gan:
            disc = build_discriminator(dict(opt["discriminator"]), self.device)
            init_discriminator(disc, gen)
            if opt["discriminator"].get("norm_type") == "actnorm":
                # ActNorm takes its loc and scale from the first real batch
                real = self._to_device(next(self.train_loader.infinite())["real_images"])
                beta = torch.zeros(1, device=self.device)
                with torch.no_grad():
                    disc(real, beta, beta)
            d_opt = build_optimizer(dict(disc.named_parameters()), d_opt_cfg,
                                    optim.get("d_scheduler"), clip)
        self.state = TrainState(model=self.model, g_opt=g_opt, generator=gen,
                                aux_opt=aux_opt, disc=disc, d_opt=d_opt)

        if opt.get("load_checkpoint"):
            self._load_checkpoint(load_cfg)
        elif opt.get("start_iter", 0) > 0:
            self._resume_same_exp(int(opt["start_iter"]))
        self.saver = Saver(self.paths.model_dir, opt.get("keep_step") or ())

    def _set_loggers(self):
        fields = ["iter", "total", "bpp", "distortion", "skipped"]
        if self.gan:
            fields += ["adv", "d_loss"]
        self.loss_csv = CSVLogger(self.paths.loss_csv_path, fields)
        self.eval_csv = CSVLogger(self.paths.eval_csv_path,
                                  ["iter", "beta_rate", "beta_vq", "bpp", "psnr", "ms_ssim",
                                   "vq_acc"])
        self.meter = AvgMeter()
        # the optional wandb sink: used where the package is installed
        self._wandb = None
        if self.opt.get("use_wandb"):
            if importlib.util.find_spec("wandb") is None:
                self.logger.warning("use_wandb set but wandb is not installed")
            else:
                self._wandb = importlib.import_module("wandb")
                self._wandb.init(project=self.opt.get("project_name", "dc_vic"),
                                 name=self.opt.get("exp"), config=self.opt.to_plain())

    def _to_device(self, images: np.ndarray) -> torch.Tensor:
        """NHWC float32 host images -> NCHW on the device (pinned and
        non-blocking on a card)."""
        t = torch.from_numpy(np.ascontiguousarray(images)).permute(0, 3, 1, 2).contiguous()
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------------------------
    def step(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One training step of this stage on a device batch (NCHW)."""
        with backend_flags(**_FLAGS):
            if self.gan:
                return gan_step(self.state, batch, self.losses, self.policy,
                                self.mc_sampling, self.y_hat_cond, self.lpips_fn)
            return rd_step(self.state, batch, self.losses, self.policy, self.lpips_fn)

    @staticmethod
    def _partial_restore(target: Dict, raw: Dict, logger, label: str) -> Dict:
        """``load_state_dict(strict=False)`` with shape checks: the keys
        present in both with equal shapes come from ``raw``, the others keep
        the target's values; missing and unexpected keys are logged."""
        merged, loaded = {}, 0
        for k, v in target.items():
            r = raw.get(k)
            if r is not None and tuple(r.shape) == tuple(v.shape):
                merged[k] = r
                loaded += 1
            else:
                merged[k] = v
        missing = [k for k in target if k not in raw]
        unexpected = [k for k in raw if k not in target]
        if missing:
            logger.warning(f"{label}: {len(missing)} missing keys (kept init), e.g. {missing[0]}")
        if unexpected:
            logger.warning(f"{label}: {len(unexpected)} unexpected checkpoint keys ignored, "
                           f"e.g. {unexpected[0]}")
        logger.info(f"{label}: loaded {loaded}/{len(target)} tensors")
        return merged

    def _load_checkpoint(self, cfg: Dict):
        """Boot from another experiment's checkpoint (module docstring)."""
        exp, itr = cfg.get("exp"), cfg.get("iter")
        if exp is not None:
            ph = PathHandler(self.opt.get("ckpt_root", "./checkpoint"), exp)
            model_path = ph.checkpoint_path("comp_model", int(itr))
            optim_path = ph.checkpoint_path("training_state", int(itr))
            disc_path = ph.checkpoint_path("discriminator", int(itr))
        else:
            model_path = cfg.get("path") or cfg.get("load_path")
            optim_path = cfg.get("training_state_path")
            disc_path = cfg.get("discriminator_path")
        load_optimizer = cfg.get("load_optimizer", True)
        load_scheduler = cfg.get("load_scheduler", True)
        if not model_path or not os.path.exists(model_path):
            self.logger.warning(f"load_checkpoint path missing: {model_path}")
            return
        raw = Saver.load(model_path)
        if cfg.get("strict", True):
            self.model.load_state_dict(raw, strict=True)
        else:
            self.model.load_state_dict(
                self._partial_restore(self.model.state_dict(), raw, self.logger, "comp_model"))
        self.logger.info(f"loaded comp_model weights from {model_path}")

        ts = None
        if load_optimizer and optim_path and os.path.exists(optim_path):
            ts = Saver.load(optim_path)
            g = ts["g_opt"] if load_scheduler else reset_schedule_counts(ts["g_opt"])
            self.state.g_opt.load_state_dict(g)
            self.state.aux_opt.load_state_dict(ts["aux_opt"])
            self.logger.info(f"loaded optimizer state from {optim_path}"
                             + ("" if load_scheduler else " (scheduler reset)"))
        elif load_optimizer:
            self.logger.warning(f"load_optimizer set but missing {optim_path}")
        else:
            self.logger.warning("optimizer/scheduler NOT loaded")

        if self.gan and cfg.get("load_discriminator", True):
            if disc_path and os.path.exists(disc_path):
                self.state.disc.load_state_dict(Saver.load(disc_path))
                self.logger.info(f"loaded discriminator from {disc_path}")
                if ts is not None and "d_opt" in ts:
                    d = ts["d_opt"] if load_scheduler else reset_schedule_counts(ts["d_opt"])
                    self.state.d_opt.load_state_dict(d)
            else:
                self.logger.warning(f"load_discriminator set but missing {disc_path}")
        elif self.gan:
            self.logger.warning("discriminator NOT loaded")

    def _resume_same_exp(self, start_iter: int):
        """Resume this experiment from its own checkpoints at start_iter."""
        mp = self.paths.checkpoint_path("comp_model", start_iter)
        if not os.path.exists(mp):
            self.logger.warning(f"resume requested but missing {mp}")
            return
        self.model.load_state_dict(Saver.load(mp))
        tp = self.paths.checkpoint_path("training_state", start_iter)
        if os.path.exists(tp):
            ts = Saver.load(tp)
            self.state.g_opt.load_state_dict(ts["g_opt"])
            self.state.aux_opt.load_state_dict(ts["aux_opt"])
            if self.gan and "d_opt" in ts:
                self.state.d_opt.load_state_dict(ts["d_opt"])
        dp = self.paths.checkpoint_path("discriminator", start_iter)
        if self.gan and os.path.exists(dp):
            self.state.disc.load_state_dict(Saver.load(dp))
        self.state.step = start_iter
        self.logger.info(f"resumed {self.opt.get('exp')} at iter {start_iter}")

    # ------------------------------------------------------------------
    def train_loop(self):
        opt = self.opt
        total_iter = opt.get("total_iter", 500000)
        start_iter = opt.get("start_iter", 0)
        log_step = opt.get("log_step", 100)
        eval_step = opt.get("eval_step", 10000)
        save_step = opt.get("save_step", 5000)
        timer = Timer(start_iter, total_iter)
        data_iter = self.train_loader.infinite()
        bolded_log(f"training {opt.get('exp')} [{start_iter}..{total_iter}]")
        for itr in range(start_iter + 1, total_iter + 1):
            batch = self._to_device(next(data_iter)["real_images"])
            self.meter.update(self.step(batch))
            if itr % log_step == 0:
                avg = self.meter.pop()
                stat = timer.get_time_stat(itr)
                self.logger.info(
                    f"iter {itr} " + " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items()))
                    + f" ({stat['time_per_iter']:.3f}s/it eta {stat['eta_hours']:.1f}h)")
                self.loss_csv.write({"iter": itr, **avg})
                if self._wandb is not None:
                    self._wandb.log({f"loss/{k}": v for k, v in avg.items()}, step=itr)
            if itr % eval_step == 0:
                self.validate(itr)
            if itr % save_step == 0:
                self.save(itr)

    def _beta_eval_grid(self):
        """The beta corners the validation runs at."""
        br, bv = self.policy.max_beta_rate, self.policy.max_beta_vq
        return [(0.0, 0.0), (0.0, bv), (br, 0.0), (br, bv)]

    @torch.no_grad()
    def validate(self, itr: int, max_samples: int = 24) -> Dict[str, float]:
        """bpp (of the hard-rounded codes), PSNR, MS-SSIM and VQ accuracy on
        the eval images, one CSV row per beta corner. Returns the last
        corner's averages."""
        avg = {}
        with backend_flags(**_FLAGS):
            for b1, b2 in self._beta_eval_grid():
                rows = []
                for i, batch in enumerate(self.eval_loader.eval_batches()):
                    if i >= max_samples:
                        break
                    real = self._to_device(batch["real_images"])
                    H, W = real.shape[2:]
                    betas = [torch.full((1,), b, device=self.device) for b in (b1, b2)]
                    out = self.model(pad_image(real), *betas, is_train=False)
                    fake = out["fake_images"][:, :, :H, :W]
                    rows.append(dict(bpp=float(out["qbpp"]), psnr=calc_psnr(real, fake),
                                     ms_ssim=calc_ms_ssim(real, fake),
                                     vq_acc=float(out["vq_accuracy"])))
                avg = ({k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
                       if rows else {})
                self.logger.info(f"[eval iter {itr}] beta=({b1},{b2}) "
                                 + " ".join(f"{k}={v:.4f}" for k, v in avg.items()))
                self.eval_csv.write({"iter": itr, "beta_rate": b1, "beta_vq": b2, **avg})
                if self._wandb is not None:
                    self._wandb.log({f"eval/b{b1:g}_{b2:g}/{k}": v for k, v in avg.items()},
                                    step=itr)
        return avg

    def save(self, itr: int):
        """comp_model, training_state (optimizers and step) and, in the GAN
        stages, the discriminator and its optimizer."""
        training_state = {"g_opt": self.state.g_opt.state_dict(),
                          "aux_opt": self.state.aux_opt.state_dict(), "step": self.state.step}
        payloads = {"comp_model": self.model.state_dict(), "training_state": training_state}
        if self.gan:
            payloads["discriminator"] = self.state.disc.state_dict()
            training_state["d_opt"] = self.state.d_opt.state_dict()
        paths = self.saver.save(payloads, itr)
        self.logger.info(f"saved checkpoint at iter {itr}: {paths[0]}")
        return paths


def _not_ported(name: str):
    def build(opt, device="cuda"):
        raise NotImplementedError(
            f"trainer {name} is not ported to dc_vic_tpu_torch (ROADMAP.md queue 1, item 5: "
            "the single-beta and OASIS stages)")
    TRAINER_REGISTRY.register(build, name)


@TRAINER_REGISTRY.register()
def DualBetaCondRateDistortionVqCodeTrainer(opt, device="cuda"):
    return Trainer(opt, gan=False, device=device)


@TRAINER_REGISTRY.register()
def DualBetaCondGanDistortionVqCodeTrainer(opt, device="cuda"):
    return Trainer(opt, gan=True, device=device)


_not_ported("RateDistortionVqCodeTrainer")
_not_ported("DualBetaCondOasisGanDistortionVqFusionTrainer")


def build_trainer(opt, device="cuda") -> Trainer:
    """The trainer of ``opt.trainer.type`` on ``device`` (the card unless
    the caller asks for the CPU; without CUDA the default raises)."""
    return TRAINER_REGISTRY.get(opt["trainer"]["type"])(opt, device=device)

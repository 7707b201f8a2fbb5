"""Train one stage of the curriculum with the port: the counterpart of
``scripts/train.py``.

    python3 -m dc_vic_tpu_torch.tools.train --config_path config/exp1_stage1_2.yaml \\
        [--device cuda] [key.subkey=value ...]

The stages of the curriculum run (``exp1_stage1_1``, ``exp1_stage1_2``,
``exp1_stage1_3``, ``exp1_stage3``); each after the first boots from the
previous stage's checkpoint as its ``load_checkpoint`` says. ``recon_kernels=[gn,conv3x3,fused_resblock]``
routes the reconstruction stacks through kernels K3-K6; ``dry_run=true``
builds the trainer and exits.
"""
from __future__ import annotations

import argparse

from ..train.trainer import build_trainer
from ..utils.config import dump_config, load_config
from ..utils.logger import get_root_logger
from ..utils.paths import PathHandler


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    p.add_argument("overrides", nargs="*", help="key.subkey=value overrides")
    args = p.parse_args(argv)

    opt = load_config(args.config_path, overrides=args.overrides, is_train=True)
    paths = PathHandler(opt.get("ckpt_root", "./checkpoint"), opt["exp"])
    paths.make_job_dir()
    dump_config(opt, f"{paths.job_dir}/config.yaml")
    logger = get_root_logger(paths.log_path)
    logger.info(f"experiment: {opt['exp']}")
    trainer = build_trainer(opt, device=args.device)
    if opt.get("dry_run"):
        logger.info("dry_run: trainer built, exiting")
        return trainer
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()

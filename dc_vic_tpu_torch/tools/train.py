"""Train one stage of the curriculum with the port: the counterpart of
``scripts/train.py``.

    python3 -m dc_vic_tpu_torch.tools.train --config_path config/exp1_stage1_2.yaml \\
        [--device cuda] [--nproc N] [key.subkey=value ...]

The stages of the curriculum run (``exp1_stage1_1``, ``exp1_stage1_2``,
``exp1_stage1_3``, ``exp1_stage3``); each after the first boots from the
previous stage's checkpoint as its ``load_checkpoint`` says. ``recon_kernels=[gn,conv3x3,fused_resblock]``
routes the reconstruction stacks through kernels K3-K6; ``dry_run=true``
builds the trainer and exits.

Data parallelism, as the JAX trainer runs it on every chip that divides the
batch: ``--nproc`` ranks (default: the most cards that divide the global
batch, or half of it with ``mc_sampling``; 1 on the CPU), spawned here, rank
r on ``cuda:r`` (or the CPU), joined through a file store by ``nccl`` on
cards and ``gloo`` on the CPU. At ``--nproc 1`` the
trainer runs in this process, without a process group. ``fsdp: true`` in
the config trains the ranks fully sharded (``parallel/fsdp.py``), as the
JAX trainer shards its state on a mesh of more than one device; one rank
ignores it.
"""
from __future__ import annotations

import argparse
import logging
import os
import shutil
import tempfile

import torch

from ..parallel.mesh import best_mesh_size, init_distributed, teardown
from ..train.trainer import build_trainer
from ..utils.config import dump_config, load_config
from ..utils.logger import get_root_logger
from ..utils.paths import PathHandler


def default_nproc(opt, device: str) -> int:
    """The ranks a run takes unless told: every card that divides the
    global batch (its halves with ``mc_sampling``), one on the CPU."""
    if torch.device(device).type != "cuda":
        return 1
    batch = int(opt["dataset"].get("batch_size", 6))
    if dict(opt.get("trainer") or {}).get("mc_sampling", False):
        batch //= 2
    return best_mesh_size(batch, torch.cuda.device_count())


def _run(opt, device: str, dp=None):
    """Build the trainer (rank 0 writes the config and the log) and train,
    or stop after the build with ``dry_run``."""
    paths = PathHandler(opt.get("ckpt_root", "./checkpoint"), opt["exp"])
    paths.make_job_dir()
    main = dp is None or dp.is_main
    if main:
        dump_config(opt, f"{paths.job_dir}/config.yaml")
        logger = get_root_logger(paths.log_path)
    else:
        logger = get_root_logger(level=logging.WARNING)
    logger.info(f"experiment: {opt['exp']}" + ("" if dp is None else f" ({dp.world} ranks)"))
    trainer = build_trainer(opt, device=device, dp=dp)
    if opt.get("dry_run"):
        logger.info("dry_run: trainer built, exiting")
        return trainer
    trainer.train_loop()
    return trainer


def _rank(rank: int, world: int, backend: str, store: str, opt, device: str, threads: int):
    """One rank of a data-parallel run (the entry of each spawned process)."""
    if torch.device(device).type == "cuda":
        device = f"cuda:{rank}"
        torch.cuda.set_device(rank)
    else:
        # CPU ranks share the launcher's threads: each its share, or their
        # thread pools spin against each other
        torch.set_num_threads(threads)
    dp = init_distributed(rank, world, backend, f"file://{store}")
    try:
        _run(opt, device, dp)
    finally:
        teardown()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    p.add_argument("--nproc", type=int, default=None,
                   help="data-parallel ranks (default: every card that divides the batch)")
    p.add_argument("overrides", nargs="*", help="key.subkey=value overrides")
    args = p.parse_args(argv)

    opt = load_config(args.config_path, overrides=args.overrides, is_train=True)
    nproc = args.nproc or default_nproc(opt, args.device)
    if nproc == 1:
        return _run(opt, args.device)
    cuda = torch.device(args.device).type == "cuda"
    if cuda and nproc > torch.cuda.device_count():
        raise RuntimeError(f"--nproc {nproc}: {torch.cuda.device_count()} cards visible, "
                           "one rank a card")
    backend = "nccl" if cuda else "gloo"
    store_dir = tempfile.mkdtemp(prefix="dcvic_store_")
    try:
        torch.multiprocessing.spawn(
            _rank, args=(nproc, backend, os.path.join(store_dir, "store"), opt, args.device,
                         max(1, torch.get_num_threads() // nproc)),
            nprocs=nproc, join=True)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return None


if __name__ == "__main__":
    main()

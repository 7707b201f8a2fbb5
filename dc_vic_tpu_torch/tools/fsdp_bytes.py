"""What fully sharded training (``fsdp: true``) keeps and moves a rank, counted
from the shapes alone: the stage's model (and discriminator) are built on
PyTorch's meta device, which allocates nothing, and ``fsdp_plan`` is read
as the trainer reads it.

    python3 -m dc_vic_tpu_torch.tools.fsdp_bytes [--world 2] \\
        [--config_path config/exp1_stage1_2.yaml ...]

For each config: the tensors sharded (and, of those, trained), the bytes of
parameters plus Adam moments a rank holds between steps with and without
FSDP, and the bytes one step all-gathers (the sharded parameters, whole),
reduce-scatters (the trained sharded gradients, whole) and all-reduces (the
other trained gradients).
"""
from __future__ import annotations

import argparse
from typing import Dict

from ..models import build_comp_model
from ..models.discriminators import build_discriminator
from ..parallel import fsdp_plan
from ..train.optim import aux_mask, main_mask
from ..utils.config import load_config


def count(opt, world: int) -> Dict[str, int]:
    """The counts of a training config (``load_config(..., is_train=True)``)
    at ``world`` ranks: tensors, sharded tensors, sharded tensors a step
    trains, bytes of parameters and moments a rank holds with and without
    FSDP, and the bytes a step moves through each collective."""
    gan = "Gan" in opt["trainer"]["type"]          # the GAN stages' trainers (train/trainer.py)
    model = dict(build_comp_model(opt, device="meta").module.named_parameters())
    names = list(model)
    trained = {n for n, t in main_mask(names, gan_stage=gan).items() if t}
    aux = {n for n, t in aux_mask(names).items() if t}
    # the aux optimizer holds its moments in every stage and steps outside the GAN stages
    modules = [(model, trained | aux, trained if gan else trained | aux)]
    if gan:
        disc = dict(build_discriminator(dict(opt["discriminator"]), "meta").named_parameters())
        modules.append((disc, set(disc), set(disc)))
    out = dict(tensors=0, sharded=0, sharded_trained=0, resident_dp=0, resident_fsdp=0,
               all_gather=0, reduce_scatter=0, all_reduce=0)
    for named, moments, stepped in modules:
        plan = fsdp_plan(named, world)
        for n, p in named.items():
            size = p.numel() * p.element_size()
            sharded = plan[n] is not None
            copies = 3 if n in moments else 1       # the parameter, and Adam's mu and nu
            out["tensors"] += 1
            out["sharded"] += sharded
            out["resident_dp"] += copies * size
            out["resident_fsdp"] += copies * (size // world if sharded else size)
            if sharded:
                out["all_gather"] += size
            if n in stepped:
                out["sharded_trained"] += sharded
                out["reduce_scatter" if sharded else "all_reduce"] += size
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--config_path", nargs="+",
                   default=["config/exp1_stage1_2.yaml", "config/exp1_stage1_3.yaml"])
    args = p.parse_args(argv)
    for path in args.config_path:
        c = count(load_config(path, is_train=True), args.world)
        print(f"{path}, world {args.world}: {c['sharded']} of {c['tensors']} tensors sharded "
              f"({c['sharded_trained']} trained); parameters and moments a rank holds "
              f"{c['resident_dp']} B data parallel, {c['resident_fsdp']} B FSDP "
              f"({c['resident_fsdp'] / c['resident_dp']:.4f}); a step all-gathers "
              f"{c['all_gather']} B, reduce-scatters {c['reduce_scatter']} B, all-reduces "
              f"{c['all_reduce']} B")


if __name__ == "__main__":
    main()

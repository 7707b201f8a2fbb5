"""The rank processes of tests/test_torch_train_dp.py and
tests/test_torch_fsdp.py. They are spawned with ``torch.multiprocessing``,
so this module imports neither jax nor the JAX package: it reaches the port
alone."""
import functools
import os
import time

import numpy as np
import torch

from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.parallel import fsdp
from dc_vic_tpu_torch.parallel.mesh import init_distributed, shard_batch, teardown
from dc_vic_tpu_torch.train import steps
from dc_vic_tpu_torch.train import trainer as trainer_module
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import aux_mask, build_optimizer, main_mask, masked_params
from dc_vic_tpu_torch.train.trainer import build_trainer
from dc_vic_tpu_torch.utils.config import Config, load_config


def spawn(fn, world, *args):
    """``fn(rank, world, *args)`` in ``world`` fresh processes, started and
    not waited for: returns the context whose ``join()`` does that."""
    return torch.multiprocessing.spawn(fn, args=(world, *args), nprocs=world, join=False)


def wait_for(path, timeout=600.0):
    """Until ``path`` exists; raises if ``path + ".failed"`` appears first
    (the parent could not write it)."""
    t = time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(path + ".failed") or time.monotonic() - t > timeout:
            raise RuntimeError(f"{path} was not written")
        time.sleep(0.1)


def first_batch(tr):
    """The trainer's first batch (a rank's rows of the first global batch)."""
    return tr._to_device(next(tr.train_loader.epoch_batches(0))["real_images"])


def taken(tr, terms):
    """A step's terms, the gradients its optimizers used, the parameters
    and buffers, and the optimizer states after it."""
    opts = {k: getattr(tr.state, k) for k in ("g_opt", "aux_opt", "d_opt")
            if getattr(tr.state, k) is not None}
    out = dict(terms={k: float(v) for k, v in terms.items()},
               grads={n: p.grad.clone() for n, p in tr.model.named_parameters()
                      if p.grad is not None},
               model={k: v.clone() for k, v in tr.model.state_dict().items()},
               opts={k: o.state_dict() for k, o in opts.items()}, restored=tr.restored)
    if tr.state.disc is not None:
        out["disc"] = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
        out["disc_grads"] = {n: p.grad.clone() for n, p in tr.state.disc.named_parameters()
                             if p.grad is not None}
    return out


def replayed_rd_step(dp, case, fsdp_min_size=None):
    """One stage 1_1 RD step of this rank on the weights and the global
    noise draws the JAX data-parallel step ran with (``case``: a file);
    with ``fsdp_min_size`` fully sharded by ``fsdp.shard_state`` at that
    size."""
    data = torch.load(case, weights_only=False)
    model = build_comp_model(Config._wrap(data["cfg"]), device="cpu").module
    load_reference_state_dict(model, data["start"])
    names = [n for n, _ in model.named_parameters()]
    train, aux = main_mask(names), aux_mask(names)
    for n, p in model.named_parameters():
        p.requires_grad_(train[n] or aux[n])
    state = steps.TrainState(
        model=model, generator=torch.Generator().manual_seed(0),
        g_opt=build_optimizer(masked_params(model, train), data["g_opt"], None, data["clip"]),
        aux_opt=build_optimizer(masked_params(model, aux), data["aux_opt"]))
    if fsdp_min_size is not None:
        state.fsdp = fsdp.shard_state(dp, (model,), (state.g_opt, state.aux_opt),
                                      min_size=fsdp_min_size)
    losses = {k: build_loss(v) for k, v in data["losses"].items()}
    x = shard_batch(torch.from_numpy(data["batch"]).permute(0, 3, 1, 2), dp.rank, dp.world)
    noise = steps.Noise
    steps.Noise = lambda generator, shard=None: Noise(draws=data["draws"], shard=shard)
    try:
        terms = steps.rd_step(state, x.contiguous(), losses, steps.BetaPolicy(use_beta=False),
                              dp=dp)
    finally:
        steps.Noise = noise
    if state.fsdp is not None:
        state.fsdp.gather()
    out = dict(terms={k: float(v) for k, v in terms.items()},
               params={n: p.detach().clone() for n, p in model.named_parameters()},
               opts={"g_opt": state.g_opt.state_dict(), "aux_opt": state.aux_opt.state_dict()})
    if state.fsdp is not None:
        state.fsdp.release()
    return out


def trainer_ranks(rank, world, store, yamls, jax_case, out, threads):
    """Rank ``rank``: stage 1_2's RD step and stage 1_3's GAN step through
    the trainers of ``yamls`` on the rank's share of the first global
    batch, a second RD step with a non-finite image on rank 1 only, and the
    replayed JAX case once its file is there; the results go to
    ``out/rank{rank}.pt``."""
    torch.set_num_threads(threads)
    dp = init_distributed(rank, world, "gloo", f"file://{store}")
    try:
        res = {}
        for name in ("rd", "gan"):
            tr = build_trainer(load_config(yamls[name], is_train=True), device="cpu", dp=dp)
            res[name] = taken(tr, tr.step(first_batch(tr)))
            if name == "rd":
                batch = first_batch(tr)
                if rank == 1:
                    batch[0, :, 0, 0] = float("nan")
                res["skip"] = taken(tr, tr.step(batch))
        wait_for(jax_case)
        res["jax"] = replayed_rd_step(dp, jax_case)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        teardown()


def snapshot(tr, terms=None):
    """A copy of what the trainer would save (``Trainer.payloads``: the
    model, the optimizer states and the discriminator, whole; gathered on
    every rank under FSDP) and the step's terms."""
    clone = lambda t: ({k: clone(v) for k, v in t.items()} if isinstance(t, dict)
                       else t.clone() if isinstance(t, torch.Tensor) else t)
    out = clone(tr._whole(tr.payloads))
    out["terms"] = None if terms is None else {k: float(v) for k, v in terms.items()}
    return out


def at_rest(tr):
    """Between steps, for each module parameter and optimizer moment under
    FSDP: (elements the rank holds, the whole tensor's shape, the plan's
    shard dimension)."""
    held = {}
    for lay, prefix in zip(tr.fsdp.layouts, ("model.", "disc.")):
        for n, p in lay.params.items():
            held[prefix + n] = (p.numel() + (lay.shards[n].numel() if n in lay.shards else 0),
                                lay.shapes[n], lay.plan[n])
        for key in ("g_opt", "aux_opt", "d_opt"):
            opt = getattr(tr.state, key)
            if opt is None or opt.layout is not lay:
                continue
            for moment in ("mu", "nu"):
                for n, t in zip(opt.names, getattr(opt, moment)):
                    held[f"{key}.{moment}.{n}"] = (t.numel(), lay.shapes[n], lay.plan[n])
    return held


def fsdp_ranks(rank, world, store, yamls, jax_case, out, threads, min_size):
    """Rank ``rank`` of tests/test_torch_fsdp.py: first, on rank 0, one
    process's stage 1_2 step and save (``yamls["one"]``: the checkpoint the
    others boot from); then for stage 1_2's RD step and stage 1_3's GAN
    step, the data-parallel trainer's step and the fully sharded one's
    (``fsdp: true``, shards of ``min_size`` elements and up) from the same
    start; under FSDP also the state it booted, its storage between steps,
    a second RD step with a non-finite image on rank 1 only, a validation
    and a save; then the replayed JAX FSDP case. The results go to
    ``out/rank{rank}.pt``."""
    torch.set_num_threads(threads)
    trainer_module.shard_state = functools.partial(fsdp.shard_state, min_size=min_size)
    dp = init_distributed(rank, world, "gloo", f"file://{store}")
    try:
        res = {}
        if rank == 0:
            one = build_trainer(load_config(yamls["one"], is_train=True), device="cpu")
            one.step(first_batch(one))
            res["one"] = one.save(1)
            del one
        dp.barrier()
        for name in ("rd", "gan"):
            for mode in ("dp", "fsdp"):
                tr = build_trainer(load_config(yamls[name, mode], is_train=True), device="cpu",
                                   dp=dp)
                if mode == "fsdp":
                    res[name, "boot"] = snapshot(tr)
                res[name, mode] = snapshot(tr, tr.step(first_batch(tr)))
                if mode == "dp":
                    res[name, "grad_norm"] = float(torch.linalg.vector_norm(torch.stack(
                        [p.grad.norm() for p in tr.state.g_opt.params if p.grad is not None])))
                    continue
                res[name, "rest"] = at_rest(tr)
                if name == "rd":
                    batch = first_batch(tr)
                    if rank == 1:
                        batch[0, :, 0, 0] = float("nan")
                    res["skip"] = snapshot(tr, tr.step(batch))
                    res["skip", "rest"] = at_rest(tr)
                    res["validate"] = tr.validate(2)
                    res["saved"] = tr.save(2)
        wait_for(jax_case)
        res["jax"] = replayed_rd_step(dp, jax_case, fsdp_min_size=min_size)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        teardown()


def write_images(root, n, size, seed):
    """``n`` uint8 HWC images of ``size`` as .npy files under ``root``."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.save(os.path.join(root, f"img{i}.npy"),
                rng.integers(0, 256, (*size, 3), dtype=np.uint8))

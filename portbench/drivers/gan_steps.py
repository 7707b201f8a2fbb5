"""GAN training steps back to back (stages 1_3 and 3): ``Trainer.step`` ->
``gan_step`` fed by the trainer's own loader through
``Trainer._to_device``, as ``Trainer.train_loop`` feeds it, without its
logging, validation and saves.

Set-up is the RD driver's (``train_steps``: seeded data set and LPIPS under
``TMPDIR``, the trainer built by ``build_trainer`` from the configuration's
trainer type, the benchmark's weights loaded); the discriminator's tensors
are drawn here from the seed by the published initialisation
(``disc_weights``) and loaded into the trainer's discriminator by name,
the same tensors handed to the reference.
Then ``checked_steps`` steps with their draws fixed by reseeding the
trainer's generator: the generator's total and the discriminator's loss of
each, the first step's gradients of both optimizers (from their moments)
and the change of every leaf either trains over all of them are kept for
the reference (``reference/gan.py``), with each step's discrete choices
(the frozen branch's VQ token map and y_hat, the estimator's token map),
which the reference reads and ``compare`` holds. The same trainer then
runs the window, at most ``in_flight`` steps queued ahead of the host.

``train_images_per_s``: images in the steps of the window over the time
from its start to the card finishing its last step. With ``--trace 1`` a
third profiled pass, recording the host and the card, gives the device
time under the program spans ``train.d_step`` (everything launched inside
it) and ``nn.discriminator`` (``utils/profiling.py::span_times``); a
program without them leaves those readings out.

The limits' readings:

    python3 -m portbench.drivers.gan_steps --calibrate --workload <name> \
        --seeds 1,2,... --control-seeds 7,8,9 [--seconds 3] [--out FILE]

runs the cell once per sound seed, and per control seed follows the
reference in float32 beside four copies in the program's place: TF32 on,
the discriminator's update skipped, the fakes not detached in the
discriminator's loss, the estimator's logits perturbed before the argmax
that the VQGAN decoder reads. One JSON line per reading, then the summary (the
lower readings the sound runs' largest, the upper each control's
smallest). The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import collections
import copy
import json
import math
import os
import tempfile
import time

import numpy as np
import torch
from torch import nn

from portbench import codec_cell, harness, roofline, trace, weights
from portbench.drivers import train_steps
from portbench.images import image_pool
from portbench.reference import dcvic
from portbench.reference.codec_judge import DECIDED
from portbench.reference.gan import GANStep, PatchDisc

# the planted estimator fault's noise on the logits (their median lead of
# the best over the next is 1-3 with random weights)
TOKEN_NOISE = 0.5


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup: harness.SetupClock, hooks=None) -> harness.Outcome:
    from dc_vic_tpu_torch.train.trainer import build_trainer
    cfg, tr = cell.config, cell.traffic
    dep = cfg["deployment"]
    work = os.path.join(tempfile.gettempdir(), "portbench", cell.name)
    train_steps.write_data(os.path.join(work, "data"), dep["train_images"],
                           dep["train_image_hw"], harness.torch_seed(seed, 2), device)
    lp = train_steps.lpips_weights(harness.torch_seed(seed, 9), device)
    torch.save(lp, os.path.join(work, "lpips_alex.pt"))
    opt = copy.deepcopy(cfg["model_config"])
    ds = opt["dataset"]
    ds["train_dataset"]["root_dir"] = os.path.join(work, "data")
    ds["eval_dataset"]["root_dir"] = os.path.join(work, "data", "eval")
    opt.update(ckpt_root=os.path.join(work, "ckpt"), exp=cell.name,
               lpips_weights=os.path.join(work, "lpips_alex.pt"),
               seed=harness.torch_seed(seed, 8) % (1 << 31))
    trainer = build_trainer(opt, device)
    with torch.device("meta"):
        shape = dcvic.DCVIC(cfg["model_config"])
    w = weights.make_weights(shape, harness.torch_seed(seed, 1), device,
                             dep.get("rate_scale", 1.0))
    trainer.model.load_state_dict(w)
    state = trainer.state
    disc0 = disc_weights(opt["discriminator"], harness.torch_seed(seed, 11), device)
    d_names = port_disc_names(opt["discriminator"]["n_layers"])
    state.disc.load_state_dict({d_names[k]: v for k, v in disc0.items()})
    if hooks:
        hooks(trainer)
    B = opt["dataset"]["batch_size"]
    data = trainer.train_loader.infinite()
    g_names = list(state.g_opt.names)

    # the checked steps, through the window's own call; each one's discrete
    # choices are kept for the reference to read (hooks that copy them,
    # removed before the window): the frozen branch's VQ token map and
    # y_hat, and the estimator's token map that the VQGAN decoder reads
    batches, program = [], {"loss": [], "d_loss": [], "tokens": [], "codes": []}
    hooks_on = [
        trainer.model.vq_estimator.register_forward_hook(
            lambda mod, args, out: program["tokens"].append(
                torch.argmax(out[1], dim=1).cpu())),
        trainer.model.register_forward_hook(
            lambda mod, args, out: program["codes"].append(
                (out["gt_vq_indices"].cpu(), out["quantized_code"]["y"].detach().cpu())))]
    for s in range(tr["checked_steps"]):
        batch = trainer._to_device(next(data)["real_images"])
        batches.append(batch.cpu())
        state.generator.manual_seed(harness.torch_seed(seed, 100 + s))
        terms = trainer.step(batch)
        program["loss"].append(float(terms["total"]))
        program["d_loss"].append(float(terms["d_loss"]))
        if s == 0:
            d_mu = dict(zip(state.d_opt.names, state.d_opt.mu))
            grads = [m / (1 - state.g_opt.b1)
                     for m in list(state.g_opt.mu) + [d_mu[d_names[k]] for k in disc0]]
            program["grad"] = train_steps._norms(grads)
            program["grad_vec"] = [g.cpu() for g in grads]
            del grads
    for h in hooks_on:
        h.remove()
    params = dict(trainer.model.named_parameters())
    d_params = dict(state.disc.named_parameters())
    program["change"] = train_steps._norms(
        [params[n].detach() - w[n] for n in g_names]
        + [d_params[d_names[k]].detach() - v for k, v in disc0.items()])
    w = {k: v.cpu() for k, v in w.items()}
    disc0 = {k: v.cpu() for k, v in disc0.items()}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    setup.stop()

    steps, wait, queued = 0, 0.0, collections.deque()
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        batch = trainer._to_device(next(data)["real_images"])
        wait += time.perf_counter() - t
        trainer.step(batch)
        steps += 1
        if torch.cuda.is_available():
            ev = torch.cuda.Event()
            ev.record()
            queued.append(ev)
            if len(queued) > tr["in_flight"]:
                queued.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    window = time.perf_counter() - t0
    e2e = {"train_images_per_s": steps * B / window}
    harness.log(f"window: {steps} steps in {window:.3f} s, waiting {wait * 1e3 / steps:.2f} ms "
                "a step for data")
    window_peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0

    record = None
    if traced:
        n = tr["trace_steps"]

        def body():
            for _ in range(n):
                with trace.span("data"):
                    batch = trainer._to_device(next(data)["real_images"])
                with trace.span("step"):
                    trainer.step(batch)
        dev, labels = trace.two_passes(torch, body)
        extra = {"data_wait_ms": wait * 1e3 / steps, **span_ms(body, n)}
        calls, flops = unit_counts(cfg, B)
        record = trace.Record(dev, n, trace.StageTimer(), units=steps, seconds=window,
                              peak_bytes=window_peak, calls=calls, flops=flops,
                              flop_peak=roofline.TF32X3_PEAK, extra=extra, labels=labels)
    del trainer, state, params, d_params, data
    codec_cell.release_memory()
    numbers = judge(cfg["model_config"], w, lp, disc0, device, batches, program, g_names, seed)
    return harness.Outcome(e2e=e2e, numbers=numbers, attempted=steps, failed=0,
                           peak_bytes=max(peak, window_peak), record=record)


class _Only:
    """A finished profile seen with only the program spans ``keep``: a
    kernel launched inside a span left out counts for the kept span around
    it."""

    def __init__(self, prof, keep):
        self.prof, self.keep = prof, set(keep)

    def events(self):
        from dc_vic_tpu_torch.utils.profiling import SPAN_PREFIX
        return [e for e in self.prof.events() if not e.name.startswith(SPAN_PREFIX)
                or e.name[len(SPAN_PREFIX):] in self.keep]


def span_ms(body, n: int) -> dict:
    """Device ms a step under ``train.d_step`` (nested spans included) and
    under ``nn.discriminator``, from one pass of ``body`` (``n`` steps)
    that records the host and the card; the readings the program's spans
    do not give are left out."""
    try:
        from dc_vic_tpu_torch.utils.profiling import span_times
    except ImportError:
        return {}
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                                      else [])) as prof:
        body()
        if cuda:
            torch.cuda.synchronize()
    out = {}
    for key, span, seen in (("disc_ms", "nn.discriminator", prof),
                            ("d_step_ms", "train.d_step", _Only(prof, ["train.d_step"]))):
        us = span_times(seen).get(span, (0.0, 0))[0]
        if us > 0:
            out[key] = us / 1e3 / n
    return out


def disc_weights(cfg: dict, seed: int, device) -> dict:
    """The discriminator's tensors under ``PatchDisc``'s names, drawn from
    ``seed`` on ``device`` by the published initialisation: conv weights
    N(0, 0.02), the MLP's weights lecun-normal truncated at two standard
    deviations, zero biases."""
    with torch.device("meta"):
        shape = PatchDisc(cfg)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    out = {}
    for name, mod in shape.named_modules():
        if isinstance(mod, nn.Conv2d):
            w = torch.randn(mod.weight.shape, generator=g, device=device) * 0.02
        elif isinstance(mod, nn.Linear):
            std = 1.0 / math.sqrt(mod.in_features) / weights._TRUNC_STD
            w = nn.init.trunc_normal_(torch.empty(mod.weight.shape, device=device), 0.0, std,
                                      -2 * std, 2 * std, generator=g)
        else:
            continue
        out[f"{name}.weight"] = w
        out[f"{name}.bias"] = torch.zeros(mod.bias.shape, device=device)
    return out


def port_disc_names(n_layers: int) -> dict:
    """``PatchDisc``'s names -> the program's: ``cond_mlp`` for ``mlp``, and
    the trunk's ``main`` sequence holding conv, LeakyReLU, then (conv, norm,
    LeakyReLU) for each further conv, and the last conv."""
    convs = [0] + [2 + 3 * i for i in range(n_layers + 1)]
    mods = {"mlp.0": "cond_mlp.0", "mlp.2": "cond_mlp.2",
            **{f"convs.{i}": f"trunk.main.{j}" for i, j in enumerate(convs)}}
    return {f"{m}.{p}": f"{port}.{p}" for m, port in mods.items() for p in ("weight", "bias")}


def _meta_lpips() -> dict:
    sd = {}
    for i, cout, cin, k in train_steps.ALEX:
        sd[f"net.features.{i}.weight"] = torch.empty(cout, cin, k, k, device="meta")
        sd[f"net.features.{i}.bias"] = torch.empty(cout, device="meta")
    for i, (_, cout, _, _) in enumerate(train_steps.ALEX):
        sd[f"lin{i}.model.1.weight"] = torch.empty(1, cout, 1, 1, device="meta")
    return sd


def unit_counts(cfg: dict, B: int):
    """(K5/K6 calls, model FLOPs) of one step on the reference's shapes on
    the meta device: the generator's forward (its frozen encoder branch
    included) with the adversarial forward, its backward, then the
    discriminator's two forwards and their backward; the optimizers'
    arithmetic is not counted."""
    opt = cfg["model_config"]
    size = opt["dataset"]["train_dataset"]["image_size"]
    step = GANStep(opt, None, _meta_lpips(), None, "meta")

    def run():
        x = torch.empty(B, 3, size, size, device="meta")
        b = torch.empty(B, device="meta")
        terms = step.g_forward(x, b, b, lambda shape: None)
        terms["total"].backward()
        step.d_forward(x, terms["fake"], b, b).backward()
    calls = roofline.count_calls(step.model, run, opt.get("recon_kernels", ()), 4)
    return calls, roofline.flops_of(run)


def follow(opt, w, lp, disc0, device, batches, seed, tokens=None, codes=None, tf32=False,
           **fault) -> dict:
    """The reference through the checked steps on the same rows and draws,
    reading another run's discrete choices where given (a step's
    ``tokens``: the estimator's map; ``codes``: the frozen branch's VQ
    token map and y_hat; ``GANStep.g_forward``), in float32 unless
    ``tf32`` (``fault``: ``GANStep``'s planted faults): its totals,
    first-step gradients, changes, its own choices (``tokens``,
    ``margin``, ``codes``) and ``names``."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = tf32
    try:
        ref = GANStep(opt, {k: v.to(device) for k, v in w.items()},
                      {k: v.to(device) for k, v in lp.items()},
                      {k: v.to(device) for k, v in disc0.items()}, device, **fault)
        out = {"loss": [], "d_loss": [], "tokens": [], "margin": [], "codes": [],
               "names": ref.g_names}
        for s, x in enumerate(batches):
            # choices of another batch size (a program that dropped rows)
            # are not read; the flips count them whole
            ok = tokens is not None and len(tokens[s]) == len(x)
            r = ref.step(x.to(device), harness.torch_seed(seed, 100 + s),
                         tokens[s].to(device) if ok else None,
                         tuple(t.to(device) for t in codes[s]) if ok else None)
            out["loss"].append(r["total"])
            out["d_loss"].append(r["d_loss"])
            out["tokens"].append(r["tokens"].cpu())
            out["margin"].append(r["margin"].cpu())
            out["codes"].append((r["gt"].cpu(), r["y_hat"].cpu()))
            if s == 0:
                out["grad"] = train_steps._norms(r["grads"])
                out["grad_vec"] = [g.cpu() for g in r["grads"]]
        p = dict(ref.model.named_parameters())
        out["change"] = train_steps._norms(
            [p[n].detach() - w[n].to(device) for n in ref.g_names]
            + [q.detach() - disc0[k].to(device) for k, q in ref.disc.named_parameters()])
        del ref, p
        codec_cell.release_memory()
        return out
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = before


def compare(ref: dict, other: dict) -> dict:
    """The numbers ``correct`` compares, the reference ``ref`` having
    followed ``other``'s discrete choices: the RD cell's loss, gradient
    and update gaps (``train_steps.compare``) over the leaves of both
    optimizers together, and ``grad_vec_gap``, the worst kept leaf's first
    gradient compared as a vector by the same rule (a gradient turned but
    not scaled keeps its norm); the discriminator loss's relative gap at
    the first step (``d_loss_gap``); ``token_flips``, the largest share, over the steps
    and images, of the positions where the reference's own choice is
    decided (its best logit leads the next by more than
    ``codec_judge.DECIDED``) whose token ``other`` changed; ``gt_flips``
    and ``y_flips``, the largest shares of the frozen branch's VQ tokens
    and y_hat bins (a difference over 1/2) where ``other`` chose otherwise
    than the reference."""
    nums = train_steps.compare(ref["loss"], ref["grad"], ref["change"], other)
    g = np.array(ref["grad"])
    keep = g >= 1e-3 * np.median(g)
    gap = np.array([float(torch.linalg.vector_norm(a - b))
                    for a, b in zip(other["grad_vec"], ref["grad_vec"])]) / np.maximum(
        g, np.median(g))
    nums["grad_vec_gap"] = float(gap[keep].max())
    a, b = other["d_loss"][0], ref["d_loss"][0]
    nums["d_loss_gap"] = abs(a - b) / abs(b) if b else math.inf
    flips = 0.0
    for mine, theirs, margin in zip(ref["tokens"], other["tokens"], ref["margin"]):
        B = mine.shape[0]
        if theirs.shape != mine.shape:
            flips = 1.0
            continue
        decided = (margin > DECIDED).reshape(B, -1)
        wrong = (mine.reshape(B, -1) != theirs.reshape(B, -1)) & decided
        flips = max(flips, float((wrong.sum(1).float() / decided.sum(1).clamp(min=1)).max()))
    nums["token_flips"] = flips
    for i, key in enumerate(("gt_flips", "y_flips")):
        shares = []
        for mine, theirs in zip(ref["codes"], other["codes"]):
            a, b = mine[i].float(), theirs[i].float()
            shares.append(float(((a - b).abs() > 0.5).float().mean())
                          if a.shape == b.shape else 1.0)
        nums[key] = max(shares)
    return nums


def judge(opt: dict, w, lp, disc0, device, batches, program: dict, g_names, seed: int) -> dict:
    """The reference follows the checked steps in float32 without TF32, on
    the program's token maps (``compare``)."""
    ref = follow(opt, w, lp, disc0, device, batches, seed, program["tokens"],
                 program["codes"])
    if ref["names"] != g_names:
        raise ValueError("the reference's trained leaves are not the program's")
    return compare(ref, program)


# ----------------------------------------------------------- calibration
def control_readings(cell: harness.Cell, seed: int, device) -> dict:
    """The checked steps' rows of this seed followed by the float32
    reference and, in the program's place, by TF32 and the three planted
    faults: {kind: numbers}."""
    cfg, tr = cell.config, cell.traffic
    opt = cfg["model_config"]
    B = opt["dataset"]["batch_size"]
    size = opt["dataset"]["train_dataset"]["image_size"]
    hw = cfg["deployment"]["train_image_hw"]
    pool = image_pool(cfg["deployment"]["train_images"], hw[0], hw[1],
                      harness.torch_seed(seed, 2), device)
    rng = np.random.default_rng(harness.seed_parts(seed, 10))
    batches = []
    for _ in range(tr["checked_steps"]):
        rows = []
        for i in rng.choice(len(pool), B, replace=False):
            t, l = rng.integers(0, hw[0] - size + 1), rng.integers(0, hw[1] - size + 1)
            rows.append(pool[i, t:t + size, l:l + size])
        x = torch.from_numpy(np.stack(rows)).permute(0, 3, 1, 2).float() / 255.0
        batches.append((x - 0.5) * 2.0)
    with torch.device("meta"):
        shape = dcvic.DCVIC(opt)
    w = {k: v.cpu() for k, v in weights.make_weights(
        shape, harness.torch_seed(seed, 1), device, cfg["deployment"]["rate_scale"]).items()}
    lp = train_steps.lpips_weights(harness.torch_seed(seed, 9), device)
    disc0 = {k: v.cpu() for k, v in disc_weights(
        opt["discriminator"], harness.torch_seed(seed, 11), device).items()}
    args = (opt, w, lp, disc0, device, batches, seed)
    out = {}
    for kind, kw in (("control_tf32", {"tf32": True}),
                     ("fault_d_update_skipped", {"d_update": False}),
                     ("fault_fakes_attached", {"detach_fakes": False}),
                     ("fault_tokens_perturbed", {"token_noise": TOKEN_NOISE})):
        other = follow(*args, **kw)
        out[kind] = compare(follow(*args, other["tokens"], other["codes"]), other)
    return out


def calibrate(argv=None) -> int:
    p = argparse.ArgumentParser(description="the readings of a GAN cell's limits")
    p.add_argument("--calibrate", action="store_true", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    summary = collections.defaultdict(lambda: collections.defaultdict(list))

    def say(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        for k, v in obj.get("numbers", {}).items():
            summary[obj["kind"]][k].append(v)
    for s in filter(None, a.seeds.split(",")):
        t = time.time()
        out = run(cell, int(s), a.seconds, False, "cuda", harness.SetupClock(time.time()))
        say({"kind": "program", "seed": int(s), "seconds": time.time() - t,
             "failed": out.failed, "e2e": out.e2e, "numbers": out.numbers})
    for s in filter(None, a.control_seeds.split(",")):
        for kind, nums in control_readings(cell, int(s), "cuda").items():
            say({"kind": kind, "seed": int(s), "numbers": nums})
    say({"kind": "summary", "lower": {k: max(v) for k, v in summary["program"].items()},
         "upper": {kind: {k: min(v) for k, v in nums.items()}
                   for kind, nums in summary.items() if kind != "program"}})
    return 0


if __name__ == "__main__":
    raise SystemExit(calibrate())

"""Training steps back to back: ``Trainer.step`` fed by the trainer's own
loader through ``Trainer._to_device``, as ``Trainer.train_loop`` feeds it,
without its logging, validation and saves.

Set-up writes the configuration's seeded data set (uint8 ``.npy`` images
in the ``train_0..9`` layout) and seeded LPIPS(alex) weights under
``TMPDIR``, builds the trainer, loads the benchmark's weights, and drives
the trainer from the seed through ``checked_steps`` steps whose draws
(betas, noise) are fixed by reseeding the trainer's generator before each;
the loss of each, the gradients the optimizers took in the first (from
their moments) and the parameters' change over all of them are kept for
the reference. The same trainer then runs the window, at most
``in_flight`` steps queued on the card ahead of the host.

``train_images_per_s``: images in the steps of the window over the time
from its start to the card finishing its last step.
"""
from __future__ import annotations

import collections
import copy
import os
import tempfile
import time

import numpy as np
import torch

from portbench import codec_cell, harness, roofline, trace, weights
from portbench.images import image_pool
from portbench.reference import dcvic
from portbench.reference.train import RDStep

ALEX = ((0, 64, 3, 11), (3, 192, 64, 5), (6, 384, 192, 3), (8, 256, 384, 3), (10, 256, 256, 3))


def lpips_weights(seed: int, device) -> dict:
    """Seeded LPIPS(alex) weights under the released file's keys:
    He-normal convs, N(0, 0.05) biases, U(0, 1) heads."""
    g = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for i, cout, cin, k in ALEX:
        sd[f"net.features.{i}.weight"] = torch.randn(
            (cout, cin, k, k), generator=g, device=device) * (2.0 / (cin * k * k)) ** 0.5
        sd[f"net.features.{i}.bias"] = torch.randn(cout, generator=g, device=device) * 0.05
    for i, (_, cout, _, _) in enumerate(ALEX):
        sd[f"lin{i}.model.1.weight"] = torch.rand((1, cout, 1, 1), generator=g, device=device)
    return {k: v.cpu() for k, v in sd.items()}


def write_data(root: str, n: int, hw, seed: int, device) -> None:
    """``n`` seeded images as ``train_{i % 10}/img_{i}.npy`` under root."""
    imgs = image_pool(n, hw[0], hw[1], seed, device)
    for i in range(n):
        d = os.path.join(root, f"train_{i % 10}")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"img_{i:04d}.npy"), imgs[i])
    os.makedirs(os.path.join(root, "eval"), exist_ok=True)


def _norms(ts):
    return [float(torch.linalg.vector_norm(t.float())) for t in ts]


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup: harness.SetupClock, hooks=None) -> harness.Outcome:
    from dc_vic_tpu_torch.train.trainer import build_trainer
    cfg, tr = cell.config, cell.traffic
    dep = cfg["deployment"]
    work = os.path.join(tempfile.gettempdir(), "portbench", cell.name)
    write_data(os.path.join(work, "data"), dep["train_images"], dep["train_image_hw"],
               harness.torch_seed(seed, 2), device)
    lp = lpips_weights(harness.torch_seed(seed, 9), device)
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
    if hooks:
        hooks(trainer)
    B = opt["dataset"]["batch_size"]
    data = trainer.train_loader.infinite()
    state = trainer.state
    names = list(state.g_opt.names) + list(state.aux_opt.names)

    # the checked steps, through the window's own call
    batches, program = [], {"loss": []}
    for s in range(tr["checked_steps"]):
        batch = trainer._to_device(next(data)["real_images"])
        batches.append(batch.cpu())
        state.generator.manual_seed(harness.torch_seed(seed, 100 + s))
        terms = trainer.step(batch)
        program["loss"].append(float(terms["total"]))
        if s == 0:
            moments = list(state.g_opt.mu) + list(state.aux_opt.mu)
            program["grad"] = [n / (1 - state.g_opt.b1) for n in _norms(moments)]
    params = dict(trainer.model.named_parameters())
    program["change"] = _norms([params[n].detach() - w[n] for n in names])
    w = {k: v.cpu() for k, v in w.items()}
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
        calls, flops = unit_counts(cfg, B)
        record = trace.Record(dev, n, trace.StageTimer(), units=steps, seconds=window,
                              peak_bytes=window_peak, calls=calls, flops=flops,
                              flop_peak=roofline.TF32X3_PEAK,
                              extra={"data_wait_ms": wait * 1e3 / steps}, labels=labels)
    del trainer, state, params, data
    codec_cell.release_memory()
    numbers = judge(cfg["model_config"], w, lp, device, batches, program, names, seed)
    return harness.Outcome(e2e=e2e, numbers=numbers, attempted=steps, failed=0,
                           peak_bytes=max(peak, window_peak), record=record)


def unit_counts(cfg: dict, B: int):
    """(K5/K6 calls, model FLOPs) of one step, forward and backward, on
    the reference's shapes on the meta device."""
    opt = cfg["model_config"]
    size = opt["dataset"]["train_dataset"]["image_size"]
    with torch.device("meta"):
        step = _MetaStep(opt)

    def run():
        step.forward_backward(B, size)
    calls = roofline.count_calls(step.model, run, opt.get("recon_kernels", ()), 4)
    return calls, roofline.flops_of(run)


class _MetaStep:
    """The reference step's forward and backward on meta tensors, draws
    replaced by zeros, for counting."""

    def __init__(self, opt):
        self.model = dcvic.DCVIC(opt)
        from portbench.reference.train import AlexLPIPS
        sd = {}
        for i, cout, cin, k in ALEX:
            sd[f"net.features.{i}.weight"] = torch.empty(cout, cin, k, k)
            sd[f"net.features.{i}.bias"] = torch.empty(cout)
        for i, (_, cout, _, _) in enumerate(ALEX):
            sd[f"lin{i}.model.1.weight"] = torch.empty(1, cout, 1, 1)
        self.lpips = AlexLPIPS(sd)

    def forward_backward(self, B, size):
        m = self.model
        x = torch.empty(B, 3, size, size, device="meta")
        b = torch.empty(B, device="meta")
        with torch.no_grad():
            lat, idx = m.vq_encode(x)
        y = m.comp_encode(x, lat, idx, b, b)
        z = m.hyperencoder(y)
        ho = m.hyperdecoder(z)
        prev = []
        for i, ys in enumerate(y.chunk(m.context_model.slices, dim=1)):
            mu, sigma, ms = m.context_model.mu_sigma(i, ho, prev)
            prev.append(m.context_model.lrp(i, ms, ys + mu + sigma))
        fake, pred, logits, _ = m.decode_from_y_hat(torch.cat(prev, 1), b, b)
        loss = fake.sum() + pred.sum() + logits.sum() + self.lpips(x, fake).sum()
        loss.backward()


def judge(opt: dict, w, lp, device, batches, program: dict, names, seed: int) -> dict:
    """The reference follows the checked steps on the same rows and draws:
    the loss gap of each step, the worst leaf's gap of first-step gradient
    norms and of change norms, each against the larger of the leaf's and
    the median leaf's reference norm; leaves whose reference gradient is
    under a thousandth of the median leaf's are left out."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, mm.allow_tf32)
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        return _follow(opt, w, lp, device, batches, program, names, seed)
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = before


def _follow(opt, w, lp, device, batches, program, names, seed):
    ref = RDStep(opt, {k: v.to(device) for k, v in w.items()},
                 {k: v.to(device) for k, v in lp.items()}, device)
    if ref.names() != names:
        raise ValueError("the reference's trained leaves are not the program's")
    losses, grads = [], None
    for s, x in enumerate(batches):
        out = ref.step(x.to(device), harness.torch_seed(seed, 100 + s))
        losses.append(out["total"])
        if s == 0:
            grads = _norms(out["grads"])
    p = dict(ref.model.named_parameters())
    change = _norms([p[n].detach() - w[n].to(device) for n in names])
    return compare(losses, grads, change, program)


def compare(losses, grads, change, program) -> dict:
    """The three numbers ``correct`` compares (see ``judge``)."""
    g = np.array(grads)
    keep = g >= 1e-3 * np.median(g)
    gap = lambda mine, ref: float(np.max(
        np.abs(np.array(mine)[keep] - np.array(ref)[keep])
        / np.maximum(np.array(ref)[keep], np.median(np.array(ref)[keep]))))
    steps = [abs(a - b) / abs(b) for a, b in zip(program["loss"], losses)]
    return {"loss_gap": float(steps[0]), "grad_gap": gap(program["grad"], grads),
            "update_gap": gap(program["change"], change),
            **{f"loss_gap_{i + 1}": float(v) for i, v in enumerate(steps)}}

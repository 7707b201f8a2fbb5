"""The readings the limits of ``limits/<workload>.json`` are set from, in
one process on the card:

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3] [--out FILE]

For each of ``--seeds``: one run of the cell as the benchmark makes it (a
short window, the same set-up and judge), its compared numbers (the lower
readings are their largest). For each of ``--control-seeds``: the
control, the plain reference a precision step below the configuration's
put in the program's place at the cell's own sizes (fp8 stacks for a bf16
codec; TF32 for f32 training), and for training the planted fault "half of
the batch left out, the mean taken over the rest" (the upper readings are
their smallest). One JSON line per reading, then a summary. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from portbench import codec_cell, harness
from portbench.images import image_pool


def codec_control(cell: harness.Cell, seed: int, device) -> dict:
    """fp8 stacks in the program's place, on the first batch of the cell's
    traffic for this seed."""
    from portbench.reference.codec_judge import CodecReference, judge_control
    cfg, tr = cell.config, cell.traffic
    n = tr.get("batch", 1)
    images = image_pool(tr.get("pool", tr.get("streams")), tr["H"], tr["W"],
                        harness.torch_seed(seed, 2), device)[:n]
    q = int(np.random.default_rng(harness.seed_parts(seed, 3)).choice(tr["qualities"]))
    w = codec_cell.make_weights(cfg, seed, device)
    ref = CodecReference(cfg["model_config"], w, device)
    ctrl = CodecReference(cfg["model_config"], w, device, quant="fp8")
    out = judge_control(ref, ctrl, images, q)
    del ref, ctrl
    codec_cell.release_memory()
    return out


def train_readings(cell: harness.Cell, seed: int, device) -> dict:
    """TF32 in the reference's place, and the reference with half of each
    batch left out, each followed through the checked steps beside the
    float32 reference: {kind: numbers}."""
    from portbench import weights
    from portbench.drivers import train_steps
    from portbench.reference import dcvic
    from portbench.reference.train import RDStep
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

    def follow(tf32: bool, half: bool):
        cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
        before = (cudnn.allow_tf32, mm.allow_tf32)
        cudnn.allow_tf32 = mm.allow_tf32 = tf32
        try:
            ref = RDStep(opt, {k: v.to(device) for k, v in w.items()},
                         {k: v.to(device) for k, v in lp.items()}, device)
            losses, grads = [], None
            for s, x in enumerate(batches):
                x = x[:B // 2] if half else x
                out = ref.step(x.to(device), harness.torch_seed(seed, 100 + s))
                losses.append(out["total"])
                if s == 0:
                    grads = train_steps._norms(out["grads"])
            p = dict(ref.model.named_parameters())
            change = train_steps._norms([p[n].detach() - w[n].to(device) for n in ref.names()])
            del ref, p
            codec_cell.release_memory()
            return {"loss": losses, "grad": grads, "change": change}
        finally:
            cudnn.allow_tf32, mm.allow_tf32 = before

    base = follow(False, False)
    out = {}
    for kind, args in (("control_tf32", (True, False)), ("fault_half_batch", (False, True))):
        other = follow(*args)
        out[kind] = train_steps.compare(base["loss"], base["grad"], base["change"], other)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    lines = []

    def say(obj):
        line = json.dumps(obj)
        lines.append(line)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    for s in filter(None, a.seeds.split(",")):
        t = time.time()
        out = cell.driver.run(cell, int(s), a.seconds, False, "cuda",
                              harness.SetupClock(time.time()))
        say({"kind": "program", "seed": int(s), "seconds": time.time() - t,
             "failed": out.failed, "e2e": out.e2e, "numbers": out.numbers})
    for s in filter(None, a.control_seeds.split(",")):
        t = time.time()
        if cell.traffic["driver"] == "train_steps":
            for kind, nums in train_readings(cell, int(s), "cuda").items():
                say({"kind": kind, "seed": int(s), "numbers": nums})
        else:
            nums = codec_control(cell, int(s), "cuda")
            say({"kind": "control_fp8", "seed": int(s), "seconds": time.time() - t,
                 "numbers": nums})
    summary = {}
    for line in lines:
        d = json.loads(line)
        for k, v in d["numbers"].items():
            s = summary.setdefault(d["kind"], {}).setdefault(k, [])
            s.append(v)
    say({"kind": "summary", "seed": None, "numbers": {}, "lower": {
        k: max(v) for k, v in summary.get("program", {}).items()}, "upper": {
        kind: {k: min(v) for k, v in nums.items()} for kind, nums in summary.items()
        if kind != "program"}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

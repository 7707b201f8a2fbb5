"""Which of ``chip_smoke.py`` item 19 (a)'s checks catch a data-parallel step
that slices the global batch wrong, on one GPU.

    python -m dc_vic_tpu_torch.tools.dp_faults [--out FILE]

For each entry of ``FAULTS`` (none, then one slicing fault each) it copies
``chip_smoke.py``, ``config/`` and ``dc_vic_tpu_torch/`` into a temporary
directory, puts the fault into the copy (every rank given rank 0's betas,
rank 0's noise, or rank 0's rows), and runs item 19 (a)
(``chip_smoke.check_data_parallel``) there in a process of its own, with
the kernels built and the backend flags set as ``chip_smoke.main`` sets
them. Both of its holds are recorded instead of raised: the ranks' averaged
step against one process taken in the ranks' micro-batches
(``_hold_dp_grads``), which shares the copy's slicing and so its fault, and
against the step of the whole batch at once (``_hold_whole_batch``), which
does not. Prints each run's comparisons and a JSON summary (also written to
``--out``). The checkout itself is never changed. Needs CUDA; fails without.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (file of the copy, the text to replace, its replacement): a rank takes
# rank 0's share of the global draw or batch
FAULTS = {
    "none": None,
    "betas": ("dc_vic_tpu_torch/train/steps.py",
              "rank * batch_size:(rank + 1) * batch_size", "0:batch_size"),
    "noise": ("dc_vic_tpu_torch/codec/ops.py",
              "t.narrow(batch_axis, self.rank * local, local)", "t.narrow(batch_axis, 0, local)"),
    "rows": ("dc_vic_tpu_torch/parallel/mesh.py",
             "g * size + rank * part + i", "g * size + 0 * part + i"),
}


def _copy(fault, into: str) -> None:
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), into)
    shutil.copytree(os.path.join(ROOT, "config"), os.path.join(into, "config"))
    shutil.copytree(os.path.join(ROOT, "dc_vic_tpu_torch"), os.path.join(into, "dc_vic_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if fault is None:
        return
    path, old, new = fault
    path = os.path.join(into, path)
    with open(path) as f:
        text = f.read()
    if not text.count(old):
        raise RuntimeError(f"{path}: {old!r} not found")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def _run(out: str) -> None:
    """Item 19 (a) in this process's tree, its holds recorded into ``out``."""
    import torch
    import chip_smoke     # the copy's: ``python -m`` puts its directory first
    from dc_vic_tpu_torch.ops import native
    native.kernels()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    holds = []

    def recorded(hold, name):
        def call(*args):
            label = args[-1]
            try:
                got = hold(*args)
                holds.append(dict(hold=name, label=label, held=True, returned=got))
                return got
            except AssertionError as e:
                print(f"{name} FAILED: {e}", flush=True)
                holds.append(dict(hold=name, label=label, held=False, message=str(e)))
                return float("inf"), -1
        return call
    chip_smoke._hold_dp_grads = recorded(chip_smoke._hold_dp_grads, "micro-batches")
    chip_smoke._hold_whole_batch = recorded(chip_smoke._hold_whole_batch, "whole batch")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.check_data_parallel(smi)
    with open(out, "w") as f:
        json.dump(dict(card=smi, holds=holds), f)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None, help="write the JSON summary here too")
    p.add_argument("--run", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.run:
        return _run(args.run)
    summary = {}
    for name, fault in FAULTS.items():
        with tempfile.TemporaryDirectory(prefix=f"dcvic_fault_{name}_") as tmp:
            _copy(fault, tmp)
            res = os.path.join(tmp, "holds.json")
            print(f"=== fault: {name}", flush=True)
            subprocess.run([sys.executable, "-m", "dc_vic_tpu_torch.tools.dp_faults",
                            "--run", res], cwd=tmp, check=True)
            with open(res) as f:
                summary[name] = json.load(f)
    line = json.dumps(summary)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Makes the cell's weights and traffic from the
seed, sets up and warms the program (``setup_s``), measures for the given
seconds, judges sampled outputs against the plain reference, and prints the
result as the last line of standard output (``portbench/README.md``).
Exits 2 without a result when the card or the cell's files are missing, 3
when a forbidden module (JAX, the JAX package) was loaded.
"""
from __future__ import annotations

import argparse
import os
import sys

from portbench import harness, trace


def measure(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
            setup: harness.SetupClock, hooks=None):
    """Run the cell's driver; returns (result line, checks)."""
    import torch
    out = cell.driver.run(cell, seed, seconds, traced, device, setup, hooks)
    checks = harness.checks_from(out.numbers, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    prof = breakdown = None
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"]).read(out.record)
            if v is not None:
                metrics[m["name"]] = float(v)
        prof = out.record.prof
        breakdown = trace.breakdown(prof, out.record.labels)
    else:
        metrics = {m["name"]: float(setup.value if m["name"] == "setup_s" else
                                    out.e2e[m["name"]]) for m in cell.end_to_end}
    dev = harness.device_record(torch, cell.entry["chips"], prof)
    dev["memory_peak_bytes"] = int(out.peak_bytes)
    correct = out.failed == 0 and all(c.ok for c in checks)
    line = harness.result_line(correct, out.attempted, out.failed, metrics, units, dev, checks,
                               breakdown)
    return line, checks


def main(argv=None) -> int:
    setup = harness.SetupClock()
    # build and kernel caches at fixed paths inside the checkout, set before
    # anything builds
    cache = os.path.join(harness.ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = harness.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        harness.log(f"cannot load workload {args.workload!r}: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        harness.log(f"needs {cell.entry['chips']} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    line, checks = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", setup)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded in this process: {bad}")
        return 3
    harness.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())

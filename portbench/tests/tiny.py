"""Cells of the benchmark at a size a CPU test can hold: the workloads of
``BENCHMARK.json`` with the tiny model of ``tiny_model.json`` and small
traffic, driven by the same drivers, readers and reference."""
from __future__ import annotations

import copy
import json
import os

from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
LOOSE = {"stream_bad": {"limit": 0}, "token_flips": {"limit": 0.02},
         "px_rmse": {"limit": 1.0}, "h_gap": {"limit": 0.01}, "y_gap": {"limit": 0.01},
         "z_gap": {"limit": 0.01}}
SMALL = {
    "serve_roundtrip": dict(H=128, W=128, batch=3, pool=6, warm=1, check_batches=1,
                            trace_batches=2),
    "serve_decode": dict(H=128, W=128, streams=3, warm=1, check_requests=2,
                         trace_requests=2),
    "train_steps": dict(checked_steps=3, trace_steps=2),
}


def tiny_model() -> dict:
    with open(os.path.join(HERE, "tiny_model.json")) as f:
        return json.load(f)


def tiny_cell(workload: str, limits=None) -> harness.Cell:
    """``workload`` of BENCHMARK.json at the tiny size: f32 on the CPU."""
    cell = harness.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    mc = tiny_model()
    if "optim" in cfg["model_config"]:          # a training configuration
        mc = {**cfg["model_config"], "subnet": mc["subnet"]}
        mc["dataset"]["train_dataset"]["image_size"] = 64
        cfg["deployment"].update(train_images=8, train_image_hw=[80, 96])
    else:
        cfg["deployment"].update(lanes=64, bf16_stacks=[])
    cfg["model_config"] = mc
    tr = {**cell.traffic, **SMALL[cell.traffic["driver"]]}
    lim = {"limits": limits or (LOOSE if "serve" in tr["driver"] else cell.limits["limits"])}
    return harness.Cell(cell.name, cell.entry, cfg, tr, lim, cell.end_to_end, cell.per_layer)

"""What every cell's run shares: finding a workload's configuration, traffic
mix, limits, driver and per-layer readers by name; the process's set-up
clock; the device record; the check that neither JAX nor the JAX package
was loaded; and the result line.

Layout, all found by name (``portbench/README.md``):

* ``configs/<config>.json``: the configuration as it is run, with its
  source, ``reduced`` and ``assumed``;
* ``traffic/<mix>.json``: the mix's parameters and the ``driver`` that
  reads them (``drivers/<driver>.py``, one general generator per kind of
  traffic);
* ``limits/<workload>.json``: each number ``correct`` compares, with its
  limit and the readings it was set from;
* ``metrics/<metric>.py``: one reader per per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
# top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dc_vic_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything its name leads to."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self):
        return load_module(os.path.join(PKG, "drivers", self.traffic["driver"] + ".py"),
                           f"portbench_driver_{self.traffic['driver']}")


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    return Cell(name=name, entry=w,
                config=load_json(os.path.join(PKG, "configs", w["config"] + ".json")),
                traffic=load_json(os.path.join(PKG, "traffic", w["traffic"] + ".json")),
                limits=load_json(os.path.join(PKG, "limits", name + ".json")),
                end_to_end=e2e,
                per_layer=[m for m in bench["per_layer"] if _reports(m, name, names)])


def reader(metric: str):
    """The per-layer metric's reader module, ``metrics/<metric>.py``."""
    return load_module(os.path.join(PKG, "metrics", metric + ".py"),
                       "portbench_metric_" + metric.replace(".", "_"))


# ----------------------------------------------------------------- clocks
def process_start() -> float:
    """The process's start on the ``time.time`` clock (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


class SetupClock:
    """``setup_s``: from ``start`` (the process's start on the command
    line) to the first timed call, on ``time.time``."""

    def __init__(self, start: Optional[float] = None):
        self.start = process_start() if start is None else start
        self.value: Optional[float] = None

    def stop(self) -> None:
        if self.value is None:
            self.value = time.time() - self.start


# ----------------------------------------------------------------- checks
def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def checks_from(numbers: Dict[str, float], limits: dict) -> List[Check]:
    """Each number the cell's limits file names, beside its limit; a number
    the run could not read counts as failed (infinite)."""
    return [Check(k, float(numbers.get(k, float("inf"))), float(v["limit"]))
            for k, v in limits["limits"].items()]


# ----------------------------------------------------------------- device
def device_record(torch, chips: int, trace: Optional[dict] = None) -> dict:
    dev = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
           "kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "count": chips,
           "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                        for i in range(chips)))
           if torch.cuda.is_available() else 0}
    if trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return dev


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, float],
                units: Dict[str, str], device: dict, checks: List[Check],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return json.dumps(out)


def emit(line: str, checks: List[Check]) -> None:
    """The result: the compared numbers beside their limits as the last
    lines on standard error, the JSON object as the last line of standard
    output."""
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def seed_parts(seed: int, stream: int) -> List[int]:
    """A numpy seed sequence entropy for ``stream`` of run ``seed``."""
    return [int(seed) & ((1 << 64) - 1), stream]


def torch_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence(seed_parts(seed, stream)).generate_state(1, np.uint64)[0]
               >> 1)


class Reservoir:
    """The units the check judges: ``size`` of them drawn from the seed,
    uniform over all the units offered so far whatever their number
    (Algorithm R). ``offer(k)`` says whether unit ``k`` enters the sample,
    evicting one that was in it; ``kept`` maps each unit in the sample to
    what the caller keeps of it, so only those hold memory."""

    def __init__(self, size: int, seed: int, stream: int):
        self.rng = np.random.default_rng(seed_parts(seed, stream))
        self.size, self.seen, self.kept = size, 0, {}

    def offer(self, k) -> bool:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[k] = {}
            return True
        j = int(self.rng.integers(0, self.seen))
        if j >= self.size:
            return False
        del self.kept[list(self.kept)[j]]
        self.kept[k] = {}
        return True


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values it measured, the
    numbers ``correct`` compares, the requests attempted and failed, the
    device peak read after the window, and with ``--trace 1`` the record
    the per-layer readers read."""
    e2e: Dict[str, float]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    record: Optional[object] = None

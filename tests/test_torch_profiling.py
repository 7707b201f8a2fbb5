"""The port's profiling module (``utils/profiling.py``, after
``dc_vic_tpu/utils/profiling.py``) and the per-stage codec profiler
(``tools/profile_codec.py``, after ``scripts/profile_codec.py``) on the CPU."""
import json
import logging
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config

from dc_vic_tpu.utils import profiling as jax_profiling
from dc_vic_tpu.utils.profiling import StageTimer as JaxStageTimer
from dc_vic_tpu_torch.codec.driver import Codec
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.tools import profile_codec
from dc_vic_tpu_torch.utils import profiling
from dc_vic_tpu_torch.utils.logger import get_root_logger
from dc_vic_tpu_torch.utils.profiling import StageTimer, device_trace, kernel_times, sync


def test_stage_timer_totals_counts_and_means(monkeypatch):
    """Totals, counts and means per stage, sorted by name, on a controlled
    clock; the JAX package's timer reports the same on the same clock;
    ``reset`` empties it."""
    reports = []
    for cls, module in ((StageTimer, profiling), (JaxStageTimer, jax_profiling)):
        clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.75])
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(clock))
        t = cls()
        for name in ("b", "a", "b"):
            with t.stage(name):
                pass
        reports.append(t.report())
        monkeypatch.undo()
    assert reports[0] == reports[1]
    assert list(reports[0]) == ["a", "b"]
    assert reports[0]["a"] == {"total_sec": 0.25, "count": 1, "mean_sec": 0.25}
    assert reports[0]["b"] == {"total_sec": 1.25, "count": 2, "mean_sec": 0.625}
    t = StageTimer()
    with t.stage("x"):
        pass
    t.reset()
    assert t.report() == {}


def test_stage_timer_disabled_records_nothing_and_logs():
    t = StageTimer(enabled=False)
    with t.stage("x", torch.ones(2)):
        pass
    assert t.report() == {}
    t = StageTimer()
    with t.stage("x"):
        pass
    lines = []
    t.log(type("L", (), {"info": staticmethod(lines.append)}))
    assert len(lines) == 1 and lines[0].startswith("[stage] x: ") and "x1 " in lines[0]


def test_sync_on_cpu_tensors_waits_for_nothing(monkeypatch):
    """CPU tensors, devices and nests of them need no wait: no CUDA call."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    sync({"a": [torch.ones(2), (torch.zeros(1), torch.device("cpu"))], "b": None})
    sync(torch.ones(3))
    assert calls == []
    with StageTimer().stage("s", [torch.ones(1)]):
        pass
    assert calls == []


def test_device_trace_writes_a_trace_on_cpu(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert kernel_times(prof) == {}            # no device events on the CPU


@pytest.mark.parametrize("stream_format", ["tpu", "compressai"])
def test_profile_codec_reports_the_four_stages(stream_format, tmp_path, capsys):
    """``profile`` on a CPU codec of the tiny model: the four stages of the
    JAX script, each once per round; with ``trace_dir`` a trace is written
    and the kernel table printed."""
    spec = build_comp_model(tiny_config(), device="cpu")
    init_weights(spec.module, torch.Generator().manual_seed(0))
    codec = Codec(spec, stream_format=stream_format)
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    rep = profile_codec.profile(codec, images, 2, trace_dir=str(tmp_path), quality_ind=0)
    assert tuple(rep) == profile_codec.STAGES
    assert all(v["count"] == 2 and v["mean_sec"] > 0 for v in rep.values())
    assert os.path.exists(os.path.join(tmp_path, "trace.json"))
    assert "device time 0.000 ms in 0 kernel launches" in capsys.readouterr().out


def test_profile_codec_cli_on_cpu(tmp_path):
    """The command line with the flags of scripts/profile_codec.py plus
    --device, on the tiny model written as a YAML."""
    import yaml
    path = os.path.join(tmp_path, "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(tiny_config().to_plain(), f)
    logged = []
    handler = logging.Handler()
    handler.emit = lambda record: logged.append(record.getMessage())
    logger = get_root_logger()
    logger.addHandler(handler)
    try:
        rep = profile_codec.main(["--config_path", path, "--batch", "1", "--height", "64",
                                  "--width", "64", "--rounds", "1", "--device", "cpu"])
    finally:
        logger.removeHandler(handler)
    assert tuple(rep) == profile_codec.STAGES
    assert [m.split(":")[0] for m in logged[:4]] == [f"[stage] {k}" for k in rep]
    assert logged[4].startswith("end-to-end: ") and logged[4].endswith(" img/s")

"""The readers of the program's own spans and counters: None where the
program recorded nothing or keeps no such record (a commit from before
them), a reading in each traced cell at the tiny size on the CPU; and the
program's spans, host operations on the profiler's timeline, leave the
device readings of ``trace.read_profile`` as they are."""
import time

import pytest

from portbench import harness, run, trace
from portbench.tests.test_portbench_faults import (  # noqa: F401 (few_threads: a fixture)
    DECODE, TRAIN, TRAIN_LIMITS, few_threads)
from portbench.tests.tiny import tiny_cell

READERS = {"chain_host_ms.decode": DECODE, "recon_host_ms.decode": DECODE,
           "host_waits.decode": DECODE, "forward_host_ms.train": TRAIN,
           "backward_host_ms.train": TRAIN, "update_host_ms.train": TRAIN}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_finds_nothing_without_spans(metric, monkeypatch):
    from dc_vic_tpu_torch.ops import counts
    counts.reset()
    assert harness.reader(metric).read(None) is None
    monkeypatch.delattr(counts, "spans")        # a program without span totals
    assert harness.reader(metric).read(None) is None


@pytest.mark.parametrize("workload", [DECODE, TRAIN])
def test_traced_run_reads_the_program_s_spans(workload):
    """A traced run of the cell at the tiny size: every new reader of the
    cell gives a number, the decode cell one host wait per request."""
    from dc_vic_tpu_torch.ops import counts
    counts.reset()
    cell = tiny_cell(workload, TRAIN_LIMITS if workload == TRAIN else None)
    line, _ = run.measure(cell, 4_000_000_009, 0.1, True, "cpu",
                          harness.SetupClock(time.time()))
    metrics = harness.json.loads(line)["metrics"]
    counts.reset()
    mine = [m for m, w in READERS.items() if w == workload]
    assert all(metrics[m]["value"] > 0 for m in mine), metrics
    if workload == DECODE:
        assert metrics["host_waits.decode"]["value"] == 1.0


def test_readers_take_the_device_only_pass_on_a_card(monkeypatch):
    """On a card the readers read the totals of the sessions that recorded
    the card alone (the device-only pass); without one, where both passes
    record the host, those of the host-recording sessions."""
    import torch
    from dc_vic_tpu_torch.ops import counts
    from dc_vic_tpu_torch.utils import profiling
    counts.reset()
    profiling.span_totals[False].update({"codec.decompress": [0.2, 2],
                                         "codec.decode.chain": [0.04, 2]})
    profiling.span_totals[True].update({"codec.decompress": [0.9, 4],
                                        "codec.decode.chain": [0.5, 4]})
    profiling.counters[False]["host_waits"] = 2
    profiling.counters[True]["host_waits"] = 12
    try:
        for card, chain, waits in ((True, 20.0, 1.0), (False, 125.0, 3.0)):
            monkeypatch.setattr(torch.cuda, "is_available", lambda card=card: card)
            assert harness.reader("chain_host_ms.decode").read(None) == pytest.approx(chain)
            assert harness.reader("host_waits.decode").read(None) == waits
    finally:
        counts.reset()


class _Event:
    def __init__(self, name, device, start, end):
        from torch.autograd import DeviceType
        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_program_spans_keep_device_readings_and_name_uncovered_gaps():
    """Kernels, launches and busy time: the same with the program's
    host-side spans around them as without. A gap under an ATen op keeps its
    label; a gap no host op covers is named by the innermost program span
    instead of "no host op" (the labelling pass records the spans as host
    operations)."""
    base = [_Event("portbench.decompress", False, 0, 100), _Event("aten::conv", False, 5, 60),
            _Event("k1", True, 10, 20), _Event("k2", True, 50, 70),
            _Event("Memcpy HtoD", True, 80, 81)]
    spans = [_Event("dcvic.codec.decompress", False, 1, 99),
             _Event("dcvic.codec.decode.chain", False, 2, 90)]
    without, with_spans = [
        trace.read_profile(type("P", (), {"events": lambda self, ev=ev: ev})(), 1e-4)
        for ev in (base, base + spans)]
    assert {k: v for k, v in without.items() if k != "gaps"} == \
        {k: v for k, v in with_spans.items() if k != "gaps"}
    assert without["kernel_launches"] == 2 and without["busy_s"] == pytest.approx(31e-6)
    assert without["gaps"] == pytest.approx({"decompress / aten::conv": 30e-6,
                                             "decompress / no host op": 10e-6})
    assert with_spans["gaps"] == pytest.approx({
        "decompress / aten::conv": 30e-6, "decompress / dcvic.codec.decode.chain": 10e-6})

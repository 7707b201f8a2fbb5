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
from dc_vic_tpu_torch.ops import counts
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


# ------------------------------------------------------------ program spans
@pytest.fixture(scope="module")
def tiny_codec():
    """The tiny model's codec in the tpu format with the device backend
    (the benchmark's encode path; on the CPU the coder's plain versions),
    and streams of two 64x64 images."""
    spec = build_comp_model(tiny_config(), device="cpu")
    init_weights(spec.module, torch.Generator().manual_seed(0))
    codec = Codec(spec, encode_backend="device", lanes=64)
    images = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    strings = [r["string_list"] for r in codec.compress(images, 0)]
    return codec, images, strings


def _spans(prof):
    """[(name, [enclosing program spans, innermost first], kwinputs)] of the
    program spans of a CPU profile, in order of start."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith(profiling.SPAN_PREFIX):
            continue
        parents, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith(profiling.SPAN_PREFIX):
                parents.append(p.name[len(profiling.SPAN_PREFIX):])
            p = p.cpu_parent
        out.append((e.name[len(profiling.SPAN_PREFIX):], parents, e.kwinputs))
    return out


def test_spans_are_inert_outside_a_profiler(tiny_codec, monkeypatch):
    """Without a profiler session a span is the one shared do-nothing
    context and enters no record function, and a round trip leaves the span
    totals and counters empty; under a session both fill and ``reset``
    empties them."""
    codec, images, strings = tiny_codec
    counts.reset()
    with monkeypatch.context() as m:
        def refuse(*a):
            raise AssertionError("a span entered a record function outside a profiler")
        m.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        assert profiling.span("x") is profiling.span("y", {"seq": 1})
        res = codec.compress_finalize(codec.compress_dispatch(images, 0))
        codec.decompress([r["string_list"] for r in res])
    assert counts.spans(True) == {} and counts.counters(True) == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("x"):
            profiling.count("y")
            profiling.count("y")
    assert counts.spans(True)["x"][1] == 1 and counts.counters(True) == {"y": 2}
    assert counts.spans(False) == {} and counts.counters(False) == {}
    counts.reset()
    assert counts.spans(True) == {} and counts.counters(True) == {}


@pytest.mark.parametrize("activities,host", [
    (["CPU"], True), (["CPU", "CUDA"], True), (["CUDA"], False), ([], True)])
def test_which_sessions_record_the_host(activities, host):
    """Only a session that names its activities without the CPU records the
    card alone (the device-only pass of a traced benchmark run)."""
    acts = {getattr(torch.profiler.ProfilerActivity, a) for a in activities}
    assert profiling.records_host(acts) is host


def test_a_session_of_the_card_alone_records_no_span(monkeypatch):
    """Where the session records the card alone, a span enters no record
    function (which would slow each launch inside it and record nothing)
    and adds its host time and the counts apart from the host-recording
    sessions'; a session that records the host is noted as such where it
    starts."""
    counts.reset()
    monkeypatch.setattr(profiling, "_host_recorded", False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling._host_recorded is True
        monkeypatch.setattr(profiling, "_host_recorded", False)   # as a CUDA-only session
        with monkeypatch.context() as m:
            def refuse(*a):
                raise AssertionError("a span entered a record function for the card alone")
            m.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
            with profiling.span("x", {"seq": 3}):
                with profiling.span("z"):
                    profiling.count("y")
    assert not [e for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX)]
    assert {k: n for k, (_, n) in counts.spans(False).items()} == {"x": 1, "z": 1}
    assert counts.counters(False) == {"y": 1}
    assert counts.spans(True) == {} and counts.counters(True) == {}
    counts.reset()
    assert counts.spans(False) == {} and counts.counters(False) == {}


@pytest.fixture(scope="module")
def round_trip_spans(tiny_codec):
    """The program spans of one profiled round trip (dispatch, finalize,
    decompress with its fetch), with the span totals and counters it
    added."""
    codec, images, strings = tiny_codec
    counts.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        res = codec.compress_finalize(codec.compress_dispatch(images, 0))
        codec.decompress([r["string_list"] for r in res])
    got = _spans(prof), counts.spans(True), counts.counters(True)
    counts.reset()
    return got


# (span, the span it lies in, how many of it one round trip enters); the
# tiny model has 6 ChARM slices, so 6 y sections
NESTING = [
    ("codec.compress_dispatch", None, 1),
    ("codec.front", "codec.compress_dispatch", 1),
    ("codec.encode_chain", "codec.compress_dispatch", 1),
    ("codec.pack", "codec.compress_dispatch", 1),
    ("codec.compress_finalize", None, 1),
    ("codec.decompress", None, 1),
    ("codec.upload", "codec.decompress", 1),
    ("codec.decode.chain", "codec.decompress", 1),
    ("codec.decode.section", "codec.decode.chain", 6),
    ("codec.reconstruct", "codec.decompress", 1),
    ("model.decoder_feats", "codec.reconstruct", 1),
    ("model.vq_estimator", "codec.reconstruct", 1),
    ("model.vqgan_decoder", "codec.reconstruct", 1),
    ("codec.fetch", "codec.decompress", 1),
]


@pytest.mark.parametrize("name,within,n", NESTING, ids=[c[0] for c in NESTING])
def test_round_trip_spans_nest(round_trip_spans, name, within, n):
    """Each codec and model-stage span of a round trip, its parent, its
    count; the host totals count the same entries."""
    spans, totals, _ = round_trip_spans
    hits = [parents for s, parents, _ in spans if s == name]
    assert len(hits) == n and totals[name][1] == n and totals[name][0] > 0
    assert all((parents[0] if parents else None) == within for parents in hits)


@pytest.mark.parametrize("name,stage", [("nn.group_norm", "model.vqgan_decoder"),
                                        ("nn.fusion", "model.vqgan_decoder"),
                                        ("nn.fusion", "model.decoder_feats"),
                                        ("nn.attention", "model.vqgan_decoder"),
                                        ("nn.attention", "model.vq_estimator"),
                                        ("nn.group_norm", "codec.front")])
def test_module_spans_lie_in_their_stage(round_trip_spans, name, stage):
    """The NN modules' spans appear inside the model stages that run them
    (GroupNorm also inside the fusion and attention blocks that hold one)."""
    spans, _, _ = round_trip_spans
    assert any(s == name and stage in parents for s, parents, _ in spans)
    assert all(parents for s, parents, _ in spans if s == name)


def test_fused_resblock_statistics_are_group_norm():
    """The fused residual block's GroupNorm statistics (``gn_fold``, the
    GroupNorm's work outside kernel K6) count as ``nn.group_norm``."""
    from dc_vic_tpu_torch.models.vqgan import gn_fold
    from dc_vic_tpu_torch.nn.layers import GroupNorm
    counts.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gn_fold(torch.ones(2, 8, 4, 4), GroupNorm(4, 8))
    assert [s for s, _, _ in _spans(prof)] == ["nn.group_norm"]
    assert counts.spans(True)["nn.group_norm"][1] == 1
    counts.reset()


def test_codec_spans_carry_the_sequence_numbers(round_trip_spans):
    """Dispatch and finalize carry the encode batch's number, decompress and
    fetch the decode request's, so the four join in a trace."""
    spans, _, _ = round_trip_spans
    seq = {s: kw.get("seq") for s, _, kw in spans if s in (
        "codec.compress_dispatch", "codec.compress_finalize", "codec.decompress",
        "codec.fetch")}
    assert len(seq) == 4 and all(isinstance(v, int) for v in seq.values())
    assert seq["codec.compress_dispatch"] == seq["codec.compress_finalize"]
    assert seq["codec.decompress"] == seq["codec.fetch"]


@pytest.mark.parametrize("run,waits", [
    ("finalize", 6),          # stats, two offsets, two word buffers, max |y|
    ("decompress", 1),        # pixels and consumed words in one copy
    ("deferred", 1),          # the same copy, in PendingImages.fetch
    ("verify", 3),            # consumed words, then y_hat and z_hat
])
def test_host_waits_count_the_codec_s_copies(tiny_codec, run, waits):
    """``host_waits`` counts each copy of the codec that the host waits for,
    at its call site (on the CPU as on a card)."""
    codec, images, strings = tiny_codec
    handle = codec.compress_dispatch(images, 0)
    res = codec.compress(images, 0, debug=True)
    counts.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        if run == "finalize":
            codec.compress_finalize(handle)
        elif run == "decompress":
            codec.decompress(strings)
        elif run == "deferred":
            codec.decompress(strings, defer_fetch=True).fetch()
        else:
            assert codec.verify_roundtrip(res, [r["string_list"] for r in res], (64, 64))
    assert counts.counters(True) == {"host_waits": waits}
    counts.reset()


def test_rd_step_spans_forward_backward_update():
    """One stage 1_2 RD step on the tiny model: ``train.forward`` (the
    model's stages and modules inside it), ``train.backward`` and
    ``train.update``, once each and in that order."""
    from dc_vic_tpu_torch.train import losses, optim
    from dc_vic_tpu_torch.train.steps import BetaPolicy, TrainState, rd_step
    model = build_comp_model(tiny_config(), device="cpu").module
    init_weights(model, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    main, aux = optim.main_mask(names), optim.aux_mask(names)
    state = TrainState(model=model, generator=torch.Generator().manual_seed(1),
                       g_opt=optim.build_optimizer(optim.masked_params(model, main),
                                                   {"type": "Adam", "lr": 1e-4}),
                       aux_opt=optim.build_optimizer(optim.masked_params(model, aux),
                                                     {"type": "Adam", "lr": 1e-3}))
    step_losses = {k: losses.build_loss(v) for k, v in {
        "rate_loss": {"type": "RateLoss", "loss_weight": 0.5, "reduction": "none"},
        "distortion_loss": {"type": "MSELoss", "loss_weight": 50}}.items()}
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2)) * 2 - 1
    counts.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rd_step(state, x, step_losses, BetaPolicy(sample_batch_beta=True))
    spans = _spans(prof)
    top = [s for s, parents, _ in spans if not parents]
    assert top == ["train.forward", "train.backward", "train.update"]
    assert any(s == "model.vqgan_decoder" and parents == ["train.forward"]
               for s, parents, _ in spans)
    assert {k: n for k, (_, n) in counts.spans(True).items() if k.startswith("train.")} == {
        "train.forward": 1, "train.backward": 1, "train.update": 1}
    counts.reset()


def test_data_spans_take_each_batch(tmp_path):
    """The loader's ``next`` (``data.next``, an epoch's start included) and
    ``Trainer._to_device`` (``data.to_device``) as program spans, once per
    batch."""
    from dc_vic_tpu_torch.data.loader import HostDataLoader
    from dc_vic_tpu_torch.train.trainer import Trainer

    class Ramp:
        def __len__(self):
            return 4

        def get(self, i, rng=None):
            return {"real_images": np.full((8, 8, 3), i, np.float32), "path": str(i)}

    data = HostDataLoader(Ramp(), batch_size=2, num_workers=1).infinite()
    host = type("T", (), {"device": torch.device("cpu")})()
    counts.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # two batches an epoch: the third starts the second epoch
        batches = [Trainer._to_device(host, next(data)["real_images"]) for _ in range(3)]
    assert all(b.shape == (2, 3, 8, 8) for b in batches)
    assert [s for s, parents, _ in _spans(prof) if not parents] == \
        ["data.next", "data.to_device"] * 3
    assert {k: n for k, (_, n) in counts.spans(True).items()} == {"data.next": 3,
                                                              "data.to_device": 3}
    counts.reset()


class _Event:
    """A stand-in for a profile's event: name, host or device, interval,
    correlation id."""

    def __init__(self, name, start, end, cid=0, device=False):
        from torch.autograd import DeviceType
        self.name, self.id = name, cid
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = device and name.startswith("dcvic.")
        self.time_range = type("R", (), {"start": start, "end": end,
                                         "elapsed_us": lambda self: self.end - self.start})()


def test_span_times_by_innermost_span_on_any_thread():
    """Device time by the innermost program span around each operation's
    launch (the runtime call with its correlation id), whatever thread
    launched it (autograd's own, inside ``train.backward``); launches
    outside every span, or with no recorded launch, count apart, and a user
    annotation's copy on the device timeline counts for nothing."""
    events = [_Event("dcvic.train.forward", 0, 100), _Event("dcvic.nn.group_norm", 10, 20),
              _Event("aten::mul", 12, 14), _Event("cudaLaunchKernel", 12, 13, cid=1),
              _Event("cudaLaunchKernel", 13, 14, cid=2), _Event("k", 200, 205, 1, True),
              _Event("k", 205, 206, 2, True), _Event("cudaLaunchKernel", 30, 31, cid=3),
              _Event("k", 210, 212, 3, True), _Event("dcvic.nn.fusion", 40, 60),
              _Event("dcvic.nn.group_norm", 40, 50), _Event("cudaMemcpyAsync", 55, 56, cid=4),
              _Event("Memcpy DtoD", 212, 215, 4, True),
              _Event("dcvic.train.backward", 100, 300),
              _Event("cudaLaunchKernel", 150, 151, cid=5), _Event("k", 300, 307, 5, True),
              _Event("dcvic.train.backward", 100, 300, device=True),
              _Event("cudaLaunchKernel", 400, 401, cid=6), _Event("k", 401, 412, 6, True),
              _Event("k", 500, 501, 7, True)]
    prof = type("P", (), {"events": lambda self: events})()
    assert profiling.span_times(prof) == {
        "nn.group_norm": (6.0, 2), "train.forward": (2.0, 1), "nn.fusion": (3.0, 1),
        "train.backward": (7.0, 1), "(outside)": (12.0, 2)}

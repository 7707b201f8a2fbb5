"""Tracing and per-stage timing (port of dc_vic_tpu/utils/profiling.py).

``device_trace`` records a ``torch.profiler`` trace of the CPU and the card
and writes it as a Chrome trace; ``kernel_times`` sums a profile's device
time by kernel name and ``kernel_report`` lists it. ``graph_ms``,
``profiled_ms`` and ``host_us_per_call`` time a call that launches one
small kernel: by the replay of a captured CUDA graph, by the profiler's
kernel durations, and by the host's clock over the enqueue; ``load_parent``
imports a module of another tree's ``ops`` with its own kernel build, so
that two versions of a kernel can be timed in turns. ``StageTimer``
accumulates host-clock seconds per named stage, each stage ending in a wait
for the device work it names (``sync``), so that a stage's time is its own
on a device that runs asynchronously.

Program spans. ``span(name)`` marks a layer boundary of the program (the
codec driver, the model stages, the NN modules, the trainer, the data path;
PERF.md lists them with the metrics that read them) and ``count(name)``
counts an event there. Both act only while a ``torch.profiler`` session
records, and cost one flag check otherwise. Where the session records the
host's operations, a span is an operation named ``dcvic.<name>`` on the
profiler's host timeline, nested in the spans around it, with its ``args``
attached (the trace shows them when the profiler records shapes); where it
records the card alone, a span records no event. Either way its host
seconds and entries, and the counts, add up in memory, apart by the kind
of session, and are read and reset with the kernel counters through
``ops/counts.py``. ``span_times`` sums a finished profile's device time by
the innermost span that launched each kernel (``kernel_report`` lists it).
"""
from __future__ import annotations

import contextlib
import importlib
import os
import sys
import threading
import time
import types
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch


SPAN_PREFIX = "dcvic."
# while a profiler records, by whether its session records the host's
# operations too (True) or the card alone (False): span name -> [host
# seconds, entries], counter name -> count; ``ops/counts.py`` reads and
# resets them under ``totals_lock``
span_totals: Dict[bool, Dict[str, List[float]]] = {True: {}, False: {}}
counters: Dict[bool, Dict[str, int]] = {True: {}, False: {}}
totals_lock = threading.Lock()
_OFF = contextlib.nullcontext()
_host_recorded = True     # set where each profiler session starts (_watch_sessions)


def records_host(activities) -> bool:
    """Whether a session of these ``ProfilerActivity``s records the host's
    operations: one that names its activities without the CPU records the
    card alone; one that names none (NVTX, ITT) takes the spans as host
    ranges."""
    return not activities or torch.profiler.ProfilerActivity.CPU in activities


def _watch_sessions() -> None:
    """Note, where each profiler session starts, whether it records the
    host's operations. torch has no query of a running session's
    activities, so the call of ``torch.autograd.profiler`` that starts one,
    ``_enable_profiler(config, activities)`` (``torch.profiler.profile``
    goes through it), is wrapped once (``records_host``)."""
    from torch.autograd import profiler as autograd_profiler
    start = autograd_profiler._enable_profiler
    if getattr(start, "notes_host", False):
        return

    def enable(config, activities, *rest, **kwargs):
        global _host_recorded
        _host_recorded = records_host(activities)
        return start(config, activities, *rest, **kwargs)
    enable.notes_host = True
    autograd_profiler._enable_profiler = enable


_watch_sessions()


class _Span:
    """An active span. Where the session records the host, it is a host
    operation on the profiler's timeline, recorded at the FUNCTION scope
    (``_RecordFunctionFast``), not as a user annotation
    (``record_function``): a user annotation also puts a copy of itself on
    the device timeline, spanning the kernels it launched, which anything
    that counts the device timeline's events as device work would count as
    a kernel; and it costs ten times as much host time. Where the session
    records the card alone, a span would record no event and still slow
    every launch inside it (about 1.5 us on the card), so it enters no
    record and only adds up its host time."""
    __slots__ = ("name", "args", "host", "rf", "t0")

    def __init__(self, name: str, args: Optional[dict], host: bool):
        self.name, self.args, self.host = name, args, host

    def __enter__(self):
        if self.host:
            self.rf = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + self.name, (),
                                                             self.args or {})
            self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.host:
            self.rf.__exit__(*exc)
        with totals_lock:
            tot = span_totals[self.host].setdefault(self.name, [0.0, 0])
            tot[0] += dt
            tot[1] += 1


def span(name: str, args: Optional[dict] = None):
    """A context that marks the block as the program span ``name`` while a
    profiler records (``args``: numbers shown with it in the trace, such as
    a request's sequence number); otherwise a shared context that does
    nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, args, _host_recorded)


def count(name: str) -> None:
    """Add one to the counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        with totals_lock:
            table = counters[_host_recorded]
            table[name] = table.get(name, 0) + 1


def _devices(tree, out: set) -> set:
    """The CUDA devices of the tensors (and devices) in a nest of lists,
    tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, torch.device):
        if tree.type == "cuda":
            out.add(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def sync(tree) -> None:
    """Wait for all work queued on the CUDA devices of ``tree``'s tensors
    (a tensor, a ``torch.device``, or lists, tuples and dicts of them); CPU
    tensors need no wait."""
    for dev in _devices(tree, set()):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block's CPU work and, where a card is present, its
    device work; on exit write the trace to ``log_dir/trace.json``
    (chrome://tracing or Perfetto). Yields the profile, for
    ``kernel_times``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def kernel_times(prof) -> Dict[str, Tuple[float, int]]:
    """{kernel name: (device microseconds, launches)} of a finished
    profile, device events only."""
    from torch.autograd import DeviceType
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (float(us), int(evt.count))
    return out


def kernel_report(times: Dict[str, Tuple[float, int]], top: int = 20) -> List[str]:
    """Lines of ``kernel_times``' result: the total device time and
    launches, then the ``top`` kernels by device time with their share."""
    total = sum(us for us, _ in times.values())
    lines = [f"device time {total / 1e3:.3f} ms in {sum(n for _, n in times.values())} "
             f"kernel launches"]
    for name, (us, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"{100 * us / max(total, 1e-9):6.2f}%  {us / 1e3:10.3f} ms  {n:6d}  "
                     f"{name[:110]}")
    return lines


def span_times(prof) -> Dict[str, Tuple[float, int]]:
    """{program span name (no prefix): (device microseconds, operations)} of
    a finished profile that recorded the host too: each operation on the
    device (a kernel, a copy) counts for the innermost program span whose
    host interval holds its launch, the runtime call (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) that shares its correlation id. By interval
    and not by the launching thread's stack, so that the kernels autograd
    launches on its own thread count for the span its caller was in
    (``train.backward``). Operations launched outside every span, or whose
    launch the profile holds no record of, count under ``"(outside)"``;
    user annotations' copies on the device timeline are no operation."""
    from torch.autograd import DeviceType
    events = prof.events()
    host = [e for e in events if e.device_type == DeviceType.CPU]
    # by start, the outer of two that start together first
    spans = sorted(((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):])
                    for e in host if e.name.startswith(SPAN_PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    launched = {e.id: e.time_range.start for e in host if e.name.startswith("cu")}
    device = sorted((launched.get(e.id, float("-inf")), e.time_range.elapsed_us())
                    for e in events if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))
    out: Dict[str, List[float]] = {}
    open_spans: List[Tuple[float, float, str]] = []    # nested: innermost last
    j = 0
    for t, us in device:
        while j < len(spans) and spans[j][0] <= t:
            while open_spans and open_spans[-1][1] < spans[j][0]:
                open_spans.pop()
            open_spans.append(spans[j])
            j += 1
        while open_spans and open_spans[-1][1] < t:
            open_spans.pop()
        tot = out.setdefault(open_spans[-1][2] if open_spans else "(outside)", [0.0, 0])
        tot[0] += us
        tot[1] += 1
    return {k: (v[0], int(v[1])) for k, v in out.items()}


def graph_ms(fn, *args, launches: int = 100, replays: int = 5) -> float:
    """Device milliseconds a call of ``fn(*args)``: ``launches`` calls
    captured in one CUDA graph, the graph replayed ``replays`` times between
    CUDA events, the median replay over ``launches``. The host does not run
    between the launches, so a kernel of a few microseconds is timed by the
    card and not by how fast Python enqueues it; what is left beside the
    kernel is the card's own gap from one graph node to the next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)                          # warm-up off the capture: builds, caches
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: an entry that sets a kernel's shared-memory limit on every
    # call (cudaFuncSetAttribute) may do so while the stream is captured
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    return sorted(times)[len(times) // 2]


def profiled_ms(fn, *args, kernel: str, launches: int = 100) -> float:
    """Device milliseconds a launch of the kernels whose names contain
    ``kernel``, from ``torch.profiler`` over ``launches`` calls of
    ``fn(*args)`` (``kernel_times``: start to end of each kernel on the
    card). Raises if the profile holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn(*args)
        torch.cuda.synchronize()
    hits = [(us, n) for name, (us, n) in kernel_times(prof).items() if kernel in name]
    if not hits or sum(n for _, n in hits) == 0:
        raise RuntimeError(f"the profile holds no kernel named like {kernel!r}")
    return sum(us for us, _ in hits) / sum(n for _, n in hits) / 1e3


def host_us_per_call(fn, *args, calls: int = 1000) -> float:
    """Host microseconds a call of ``fn(*args)`` takes to return: the host
    clock over ``calls`` calls, then one wait for the card (outside the
    clock). For a call that only enqueues, this is the enqueue rate."""
    fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def load_parent(pkg_dir: str, module: str, name: str = "_parent_ops"):
    """``ops/<module>.py`` of the ``dc_vic_tpu_torch`` package at ``pkg_dir``
    (``git archive <commit> dc_vic_tpu_torch`` unpacked into a directory that
    ``.gitignore`` lists), imported as the private package ``name`` so that
    its ``native`` builds and loads its own library from its own sources."""
    pkg = types.ModuleType(name)
    pkg.__path__ = [os.path.join(os.path.abspath(pkg_dir), "ops")]
    sys.modules[name] = pkg
    return importlib.import_module(f"{name}.{module}")


class StageTimer:
    """Accumulates host-clock seconds per named stage across iterations."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_tree=None) -> Iterator[None]:
        """Time the block; with ``sync_tree`` the time ends when the device
        work of its tensors (``sync``) has finished."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_tree is not None:
                sync(sync_tree)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_sec": self.totals[k], "count": self.counts[k],
                "mean_sec": self.totals[k] / max(1, self.counts[k])}
            for k in sorted(self.totals)
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def log(self, logger) -> None:
        for k, v in self.report().items():
            logger.info(f"[stage] {k}: {v['mean_sec'] * 1000:.1f} ms/call "
                        f"x{v['count']} ({v['total_sec']:.2f}s total)")

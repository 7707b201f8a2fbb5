"""The traced windows: the device's kernels and its busy share under
``torch.profiler`` recording the card alone, the idle gaps by what the host
was doing (the benchmark's own ``portbench.*`` spans and the host's
operations) from a second pass that records the host too, and per-stage
host-clock spans that each end in a wait for the device.

The grouping of kernel names is a frozen copy of the program's
``tools/recon_ab.py::group_of`` (the port's own kernels one by one; cuDNN and
cuBLAS; PyTorch's elementwise and reduction kernels; other), so that it
stays fixed while the program changes.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, Iterator, List, Optional, Tuple

OWN = ("vq_argmin_kernel", "flash_attn_f32_kernel", "gn_channel_sums_kernel",
       "gn_apply_kernel", "conv3x3_same_kernel", "conv3x3_gn_swish_kernel",
       "conv3x3_bf16_kernel<false>", "conv3x3_bf16_kernel<true>", "repack_weights_kernel",
       "repack_weights_bf16_kernel", "rans_encode_symbols_kernel", "rans_encode_states_kernel",
       "rans_encode_scan_kernel", "rans_encode_scatter_kernel", "rans_decode_section_kernel")
LIBRARY = ("cudnn", "cutlass", "gemm", "gemv", "fft", "DSE::", "region_transform", "conv",
           "nchwToNhwc", "nhwcToNchw", "implicit", "xmma", "dgrad", "sm90_", "sm80_")
POINTWISE = ("elementwise", "reduce", "Reduce", "vectorized", "softmax", "layer_norm",
             "LayerNorm", "CatArray", "upsample", "Upsample")
ELEMENTWISE = "elementwise and reductions"
LIBRARY_GROUP = "conv and matmul library"


def group_of(name: str) -> str:
    for own in OWN:
        if own in name:
            return own
    if any(p in name for p in LIBRARY):
        return LIBRARY_GROUP
    if any(p in name for p in POINTWISE):
        return ELEMENTWISE
    return "other"


class StageTimer:
    """Host-clock seconds per named stage; a stage given ``sync`` ends when
    the device has finished the work queued so far."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler."""
    import torch
    return torch.profiler.record_function("portbench." + name)


@contextlib.contextmanager
def profiled(torch, host: bool = True) -> Iterator[dict]:
    """Profile the block on the card, and with ``host`` on the host too
    (always on a machine without a card); the dict it yields is filled on
    exit with the window's kernels and spans (``read_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    out: dict = {}
    torch.cuda.synchronize() if torch.cuda.is_available() else None
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        wall = time.perf_counter() - t0
    out.update(read_profile(prof, wall))


def two_passes(torch, body) -> Tuple[dict, dict]:
    """``body()`` under the profiler twice: first recording the card alone,
    for the device's readings and its busy and idle time; then recording
    the host's operations too, which slows a host-bound loop and so
    inflates the idle time, only to label the idle gaps by what the host
    was doing. Returns (device pass, labelling pass)."""
    with profiled(torch, host=False) as dev:
        body()
    with profiled(torch, host=True) as labels:
        body()
    return dev, labels


def _intervals(events) -> List[Tuple[float, float]]:
    iv = sorted((e[1], e[1] + e[2]) for e in events)
    merged: List[List[float]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def read_profile(prof, wall_s: float) -> dict:
    """Device events (name, start us, duration us) of the window, kernel
    totals by name, the busy seconds, and the idle gaps labelled by the
    innermost benchmark span that covers their middle."""
    from torch.autograd import DeviceType
    dev, spans, ops = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench."):
            # the span's copy on the device timeline is an annotation, no work
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name[len("portbench."):], float(start), float(end)))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.name, float(start), float(end - start)))
        else:
            ops.append((float(start), float(end), e.name))
    ops.sort()
    starts = [o[0] for o in ops]
    kernels: Dict[str, List[float]] = {}
    for name, _, dur in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += dur
        k[1] += 1
    busy = _intervals(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    window_s = wall_s
    if busy:
        window_s = max(wall_s, (busy[-1][1] - busy[0][0]) / 1e6)
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (_, b), (a2, _) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (b + a2)
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        label = min(inner, key=lambda s: s[2] - s[1])[0] if inner else "outside a span"
        gaps[f"{label} / {_innermost(ops, starts, mid)}"] += (a2 - b) / 1e6
    copies = ("Memcpy", "Memset")
    return dict(kernels={k: (v[0], int(v[1])) for k, v in kernels.items()},
                kernel_launches=sum(1 for name, _, _ in dev if not name.startswith(copies)),
                busy_s=busy_s, window_s=window_s, gaps=dict(gaps))


def _innermost(ops, starts, t: float, look: int = 4000) -> str:
    """The shortest host operation (ATen op, runtime call) running at
    time ``t``, among the ``look`` that started last before it."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, e, name in ops[max(0, i - look):i]:
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "no host op"


def breakdown(dev: dict, labels: dict) -> dict:
    """The ``breakdown`` of a result line: the ten device operations that
    took most time in the device pass, and the ten largest sums of idle
    gaps by host span in the labelling pass."""
    ops = sorted(dev["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(labels["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:200], us / 1e6] for n, (us, _) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


class Record:
    """What the per-layer readers read: the device pass of the profiled
    window (``prof``; ``labels`` is the labelling pass), the stage spans (``stages``), the per-unit counts the benchmark computed
    from shapes (``calls``: kernel family -> [(ops, bytes, peak)];
    ``flops``), the untraced window's throughput (``units``, ``seconds``),
    and the cell's own extras (``extra``). A unit is a batch, an image or a
    step, as the cell's traffic has it; ``prof_units`` counts the units
    inside the profiled window."""

    def __init__(self, prof: dict, prof_units: int, stages: StageTimer,
                 units: float, seconds: float, peak_bytes: int, calls=None,
                 flops: Optional[float] = None, flop_peak: Optional[float] = None,
                 extra: Optional[dict] = None, labels: Optional[dict] = None):
        self.prof, self.prof_units, self.labels = prof, prof_units, labels
        self.stages, self.units, self.seconds = stages, units, seconds
        self.peak_bytes, self.calls, self.flops, self.flop_peak = peak_bytes, calls or {}, \
            flops, flop_peak
        self.extra = extra or {}

    def device_ms_per_unit(self, pick) -> Optional[float]:
        """Device ms per unit of the kernels whose name ``pick`` accepts;
        None when the window ran none of them."""
        hits = [us for name, (us, _) in self.prof["kernels"].items() if pick(name)]
        if not hits or self.prof_units <= 0:
            return None
        return sum(hits) / 1e3 / self.prof_units

    def group_ms_per_unit(self, group: str) -> Optional[float]:
        return self.device_ms_per_unit(lambda n: group_of(n) == group)

    def stage_ms(self, name: str) -> Optional[float]:
        n = self.stages.counts.get(name, 0)
        return self.stages.totals[name] * 1e3 / n if n else None

    def roofline(self, family: str, pick, also=None) -> Optional[float]:
        """Percent: the calls' summed bound over the device time of the
        kernels ``pick`` accepts (and of those ``also`` accepts, work that
        belongs to the same calls), read only where the window launched the
        kernels ``pick`` accepts as often as the calls the benchmark
        counted."""
        calls = self.calls.get(family)
        hits = [(us, n) for name, (us, n) in self.prof["kernels"].items() if pick(name)]
        if not calls or not hits:
            return None
        if sum(n for _, n in hits) != len(calls) * self.prof_units:
            return None
        us = sum(u for u, _ in hits)
        if also is not None:
            us += sum(u for name, (u, _) in self.prof["kernels"].items()
                      if also(name) and not pick(name))
        from .roofline import bound_s
        bound = sum(bound_s(*c) for c in calls) * self.prof_units
        return 100.0 * bound / (us / 1e6)

    def idle_share(self) -> Optional[float]:
        if self.prof["window_s"] <= 0 or self.prof["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.prof["busy_s"] / self.prof["window_s"])

    def mfu(self) -> Optional[float]:
        """None unless the profiled window saw the card work: a rate
        against the card's peak means nothing of a CPU run."""
        if not self.prof["kernels"] or not self.flops or not self.flop_peak \
                or self.seconds <= 0:
            return None
        return 100.0 * self.flops * self.units / self.seconds / self.flop_peak

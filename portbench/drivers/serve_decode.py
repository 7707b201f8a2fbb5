"""A viewer opening images one at a time: one client in a closed loop,
each request ``Codec.decompress`` of one image's streams, pixels on the
host.

Traffic parameters: ``H``, ``W``, ``streams`` (distinct seeded images,
each encoded alone at set-up; the levels of ``qualities`` in equal shares,
in a seeded order),
``warm`` (decodes of set-up), ``check_requests`` (requests the reference
judges), ``trace_requests`` (requests in each of the two profiled
passes, ``--trace 1``). The requests visit the streams in seeded
rounds, each round a new order of all of them.

``decode_p95_ms``: the 95th percentile of the latencies of every request
of the window, call to pixels on the host.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import codec_cell, harness, trace
from portbench.images import image_pool


class Order:
    """Stream indexes of the requests in order: rounds of permutations."""

    def __init__(self, n: int, seed: int):
        self.rng = np.random.default_rng(harness.seed_parts(seed, 6))
        self.n, self.items = n, []

    def __getitem__(self, k: int) -> int:
        while len(self.items) <= k:
            self.items.extend(int(i) for i in self.rng.permutation(self.n))
        return self.items[k]


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup: harness.SetupClock, hooks=None) -> harness.Outcome:
    cfg, tr = cell.config, cell.traffic
    H, W, n = tr["H"], tr["W"], tr["streams"]
    w = codec_cell.make_weights(cfg, seed, device)
    codec = codec_cell.build_codec(cfg, w, device)
    images = image_pool(n, H, W, harness.torch_seed(seed, 2), device)
    qrng = np.random.default_rng(harness.seed_parts(seed, 7))
    # every seed encodes the same mix of levels, in its own order
    levels = tr["qualities"]
    quality = [int(q) for q in qrng.permutation([levels[i % len(levels)] for i in range(n)])]
    tap = codec_cell.Tap(codec.module)
    strings, fronts = [], []
    for i in range(n):
        tap.armed = True
        strings.append(codec.compress(images[i:i + 1], quality[i])[0]["string_list"])
        fronts.append(tap.take()[0])
    for i in range(tr["warm"]):
        codec.decompress([strings[i % n]])
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    order = Order(n, seed)
    if hooks:                       # a test's fault, planted in the timed path
        hooks(codec)
    # judged: requests drawn from the seed among those of the window
    keep = harness.Reservoir(tr["check_requests"], seed, 4)
    setup.stop()

    lat, ok = [], []   # per request: latency s, pixels came
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = len(lat)
        s = order[i]
        tap.armed = keep.offer(i)
        t = time.perf_counter()
        try:
            px = codec.decompress([strings[s]])
        except (RuntimeError, ValueError) as e:        # the program refused the request
            harness.log(f"request {i} failed: {e}")
            px = None
        lat.append(time.perf_counter() - t)
        ok.append(px is not None)
        logits = tap.take()[1]
        if i in keep.kept:
            keep.kept[i].update(stream=s, px=px, logits=logits)
    # a failed request misses every latency limit
    lat_ms = np.where(ok, lat, np.inf) * 1e3
    failed = len(ok) - sum(ok)
    window_s = time.perf_counter() - t0
    tap.close()
    e2e = {"decode_p95_ms": float(np.percentile(lat_ms, 95))}
    harness.log(f"window: {len(lat_ms)} requests in {window_s:.3f} s, p50 "
                f"{np.percentile(lat_ms, 50):.3f} ms, p95 {e2e['decode_p95_ms']:.3f} ms")
    window_peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0

    record = None
    if traced:
        m, nxt = tr["trace_requests"], [len(lat)]

        def body():
            for _ in range(m):
                with trace.span("decompress"):
                    codec.decompress([strings[order[nxt[0]]]])
                nxt[0] += 1
        dev, labels = trace.two_passes(torch, body)
        calls, flops = codec_cell.unit_counts(cfg, 1, H, W, encode=False)
        record = trace.Record(dev, m, trace.StageTimer(), units=len(lat), seconds=window_s,
                              peak_bytes=window_peak, calls=calls, flops=flops,
                              flop_peak=codec_cell.flop_peak(cfg),
                              extra={"latencies_ms": lat_ms.tolist()}, labels=labels)

    sample = [(images[d["stream"]:d["stream"] + 1], quality[d["stream"]], [strings[d["stream"]]],
               d["px"], fronts[d["stream"]], d["logits"])
              for _, d in sorted(keep.kept.items()) if d["px"] is not None]
    del codec, keep
    codec_cell.release_memory()
    numbers = codec_cell.judge(cfg, w, device, sample)
    return harness.Outcome(e2e=e2e, numbers=numbers, attempted=len(lat_ms), failed=failed,
                           peak_bytes=max(peak, window_peak), record=record)

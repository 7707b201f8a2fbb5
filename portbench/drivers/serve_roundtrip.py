"""The serving loop of a codec service, closed and one batch deep: per cycle
dispatch batch k + 1's encode, fetch batch k - 1's decoded pixels, finalize
batch k's streams and dispatch their decode with the fetch deferred (the
loop of the program's ``chip_smoke.py::pipelined_cycle``, driven over
distinct batches for the whole window).

Traffic parameters: ``H``, ``W`` (the images' size), ``batch``, ``pool``
(distinct seeded images the batches are drawn from, each batch without
repeats), ``qualities`` (a batch's level; each round of as many batches
holds each level once, in a seeded order),
``warm`` (round trips of set-up), ``check_batches`` (batches the reference
judges), ``trace_batches`` (batches in each of the two profiled passes
and under the stage spans, ``--trace 1``).

``codec_images_per_s``: images round-tripped (encoded, decoded, pixels on
the host) after the window's first fetch, over the time from that fetch to
the window's last.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import codec_cell, harness, trace
from portbench.images import image_pool


class Plan:
    """The batches in order: image indexes into the pool and a quality.
    The qualities come in rounds that hold each level once, in a seeded
    order, so every seed asks for the same mix of levels."""

    def __init__(self, tr: dict, seed: int, stream: int):
        self.rng = np.random.default_rng(harness.seed_parts(seed, stream))
        self.tr, self.items, self.levels = tr, [], []

    def __getitem__(self, k: int):
        while len(self.items) <= k:
            if not self.levels:
                self.levels = [int(q) for q in self.rng.permutation(self.tr["qualities"])]
            idx = self.rng.choice(self.tr["pool"], self.tr["batch"], replace=False)
            self.items.append((np.sort(idx), self.levels.pop()))
        return self.items[k]


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _loop(codec, pool, plan, k0: int, seconds=None, count=None, keep=None, tap=None):
    """The pipelined loop from batch ``k0``: for ``seconds`` after the first
    fetch, or over exactly ``count`` batches. Returns [(k, fetch time,
    fetched)] of the batches fetched inside it. With ``keep`` (a
    ``harness.Reservoir``) and ``tap`` (a ``codec_cell.Tap``), the batches
    the sample takes keep their front, logits, strings and pixels in
    ``keep.kept``, and the batches still in flight when the window closes
    are finished after it, uncounted, so that every batch offered to the
    sample is one the program finished."""
    done = []

    def dispatch(k):
        if count is not None and k >= k0 + count:
            return None
        idx, q = plan[k]
        took = keep is not None and keep.offer(k)
        if took:
            tap.armed = True
        with trace.span("dispatch"):
            handle = codec.compress_dispatch(pool[idx], q)
        if took:
            keep.kept[k]["front"] = tap.take()[0]
        return k, handle

    def finish(k, handle):
        with trace.span("finalize"):
            res = codec.compress_finalize(handle)
        strings = [r["string_list"] for r in res]
        took = keep is not None and k in keep.kept
        if took:
            tap.armed = True
        with trace.span("decompress"):
            pend = codec.decompress(strings, defer_fetch=True)
        if took:
            keep.kept[k].update(strings=strings, logits=tap.take()[1])
        return k, pend

    def fetch(k, pend):
        with trace.span("fetch"):
            try:
                px = pend.fetch()
            except (RuntimeError, ValueError) as e:     # the program refused the batch
                harness.log(f"batch {k} failed: {e}")
                px = None
        if keep is not None and k in keep.kept:
            keep.kept[k]["px"] = px
        return px is not None

    cur, pending = dispatch(k0), None
    while cur is not None:
        nxt = dispatch(cur[0] + 1)
        if pending is not None:
            done.append((pending[0], time.perf_counter(), fetch(*pending)))
            if seconds is not None and done[-1][1] - done[0][1] >= seconds:
                for unit in (cur, nxt):
                    fetch(*finish(*unit))
                break
        pending = finish(*cur)
        cur = nxt
    else:
        fetch(*pending)
    _sync()
    return done


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, device,
        setup: harness.SetupClock, hooks=None) -> harness.Outcome:
    cfg, tr = cell.config, cell.traffic
    B, H, W = tr["batch"], tr["H"], tr["W"]
    w = codec_cell.make_weights(cfg, seed, device)
    codec = codec_cell.build_codec(cfg, w, device)
    pool = image_pool(tr["pool"], H, W, harness.torch_seed(seed, 2), device)
    plan = Plan(tr, seed, 3)
    _loop(codec, pool, Plan(tr, seed, 5), 0, count=tr["warm"])
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    if hooks:                       # a test's fault, planted in the timed path
        hooks(codec)
    tap = codec_cell.Tap(codec.module)
    # judged: batches drawn from the seed among those the window finished
    keep = harness.Reservoir(tr["check_batches"], seed, 4)
    setup.stop()

    done = _loop(codec, pool, plan, 0, seconds=seconds, keep=keep, tap=tap)
    tap.close()
    window = done[-1][1] - done[0][1]
    failed = B * sum(not d[2] for d in done[1:])
    images = B * (len(done) - 1) - failed
    e2e = {"codec_images_per_s": images / window}
    window_peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    harness.log(f"window: {len(done) - 1} batches in {window:.3f} s; kept on the card for the "
                f"check: {codec_cell.card_bytes(keep.kept) / 2**20:.1f} MiB, in the window's peak")

    record = None
    if traced:
        n = tr["trace_batches"]
        dev, labels = trace.two_passes(
            torch, lambda: _loop(codec, pool, plan, len(plan.items), count=n))
        stages = trace.StageTimer()
        sync = torch.cuda.synchronize if torch.cuda.is_available() else None
        k = len(plan.items)
        for j in range(n):
            idx, q = plan[k + j]
            with stages.stage("encode", sync):
                handle = codec.compress_dispatch(pool[idx], q)
            with stages.stage("host_coding"):
                res = codec.compress_finalize(handle)
            with stages.stage("decode", sync):
                pend = codec.decompress([r["string_list"] for r in res], defer_fetch=True)
            with stages.stage("fetch"):
                pend.fetch()
        calls, flops = codec_cell.unit_counts(cfg, B, H, W, encode=True)
        record = trace.Record(dev, n, stages, units=len(done) - 1,
                              seconds=window, peak_bytes=window_peak, calls=calls,
                              flops=flops, flop_peak=codec_cell.flop_peak(cfg), labels=labels)

    sample = [(pool[plan[k][0]], plan[k][1], d["strings"], d["px"], d["front"], d["logits"])
              for k, d in sorted(keep.kept.items()) if d["px"] is not None]
    del codec, done, keep
    codec_cell.release_memory()
    numbers = codec_cell.judge(cfg, w, device, sample)
    return harness.Outcome(e2e=e2e, numbers=numbers, attempted=images + failed, failed=failed,
                           peak_bytes=max(peak, window_peak), record=record)

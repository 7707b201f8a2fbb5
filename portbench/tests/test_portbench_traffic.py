"""Each traffic mix is the same for one seed and different across seeds,
and the yardstick's counts match hand counts at small shapes."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import harness, roofline
from portbench.drivers import serve_decode, serve_roundtrip
from portbench.images import image_pool
from portbench.tests.tiny import tiny_model

BIG = 3_000_000_017


def _mixes(driver):
    d = os.path.join(harness.PKG, "traffic")
    out = []
    for f in sorted(os.listdir(d)):
        tr = harness.load_json(os.path.join(d, f))
        if tr["driver"] == driver:
            out.append(tr)
    return out


@pytest.mark.parametrize("tr", _mixes("serve_roundtrip"), ids=lambda t: t["why"][:30])
def test_roundtrip_plan(tr):
    a, b, c = (serve_roundtrip.Plan(tr, s, 3) for s in (BIG, BIG, BIG + 1))
    seq = lambda p: [(tuple(p[k][0]), p[k][1]) for k in range(50)]
    assert seq(a) == seq(b) and seq(a) != seq(c)
    for idx, q in a.items:
        assert len(set(idx)) == tr["batch"] and q in tr["qualities"]


@pytest.mark.parametrize("tr", _mixes("serve_decode"), ids=lambda t: t["why"][:30])
def test_decode_order(tr):
    a, b, c = (serve_decode.Order(tr["streams"], s) for s in (BIG, BIG, BIG + 1))
    seq = lambda o: [o[k] for k in range(3 * tr["streams"])]
    assert seq(a) == seq(b) and seq(a) != seq(c)
    assert sorted(seq(a)[:tr["streams"]]) == list(range(tr["streams"]))


def test_image_pool():
    a, b, c = (image_pool(3, 32, 48, s, "cpu") for s in (BIG, BIG, BIG + 1))
    assert a.dtype == np.uint8 and a.shape == (3, 32, 48, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[1])


def test_attention_and_conv_counts_by_hand():
    ops, nbytes, peak = roofline.attention_call(2, 10, 8)
    assert ops == 2 * (2 * 2 * 10 * 10 * 8) and nbytes == 4 * 4 * 2 * 10 * 8
    assert peak == 495e12 / 3
    ops, nbytes, peak = roofline.conv3x3_call(1, 4, 6, 5, 7, 2, False, False)
    assert ops == 2 * 9 * 4 * 6 * 35
    assert nbytes == 2 * (4 * 35 + 9 * 4 * 6 + 6 * 35) and peak == 989e12
    assert roofline.bound_s(3.35e12, 0, 1e12) == pytest.approx(3.35)
    assert roofline.bound_s(0, 3.35e12, 1e12) == pytest.approx(1.0)


def test_flop_counter_by_hand():
    conv = torch.nn.Conv2d(3, 5, 3, padding=1, bias=False)
    x = torch.zeros(2, 3, 8, 8)
    assert roofline.flops_of(lambda: conv(x)) == 2 * 9 * 3 * 5 * 2 * 64


def test_calls_of_a_tiny_vqgan():
    """At 256 x 256 and batch 1 the tiny VQGAN's 8-channel blocks fail the
    kernels' channel rule: no conv call; each attention block one call."""
    from portbench import codec_cell
    cfg = {"model_config": tiny_model(),
           "deployment": {"recon_kernels": ["gn", "conv3x3", "fused_resblock"]}}
    calls, flops = codec_cell.unit_counts(cfg, 1, 256, 256, encode=True)
    assert calls["conv3x3"] == []
    # encoder: one block with attention at 8 x 8, mid; decoder: mid, two at 8 x 8
    assert len(calls["attn"]) == 5
    assert calls["attn"][0] == roofline.attention_call(1, 32 * 32, 16)
    assert flops > 0
    assert roofline.kernel_rule(2, 128, 256, 128, 96) and not roofline.kernel_rule(
        1, 128, 128, 64, 64)


def test_traffic_files_are_data():
    for f in os.listdir(os.path.join(harness.PKG, "traffic")):
        assert f.endswith(".json")
        with open(os.path.join(harness.PKG, "traffic", f)) as fh:
            assert "driver" in json.load(fh)


def test_reservoir_is_seeded_and_uniform():
    """The judged units: the same for one seed, another for the next, never
    more than asked, and every unit offered as likely as any other."""
    def sample(seed, n=40, size=3):
        r = harness.Reservoir(size, seed, 4)
        for k in range(n):
            r.offer(k)
        return sorted(r.kept)
    assert sample(BIG) == sample(BIG) and sample(BIG) != sample(BIG + 1)
    assert len(sample(BIG)) == 3 and sample(BIG, n=2) == [0, 1]
    hits = np.zeros(40)
    for s in range(3000):
        hits[sample(BIG + s)] += 1
    assert hits.sum() == 9000 and abs(hits / 225 - 1).max() < 0.25

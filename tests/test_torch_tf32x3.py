"""The numeric core of the tensor-core kernels K2 (attention) and K5/K6 (3x3
conv), on the CPU: the TF32 split and the error-compensated three-product sum
of ``dc_vic_tpu_torch/ops/tf32.py``, which mirrors ``csrc/tf32x3.cuh``.

The kernels are held to 1e-4 against f32 references on the card. These tests
give the reason that tolerance can stay: at the kernels' reduction lengths the
compensated sum is within 1e-5 of a float64 product (relative to the largest
result where results exceed 1), while one plain TF32 product is not within
1e-4."""
import numpy as np
import pytest
import torch

from dc_vic_tpu_torch.ops import tf32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _attention_scores(rng):
    """Q K^T at C = 512: q pre-scaled by C^-1/2, as the VQGAN block calls K2."""
    return _t(rng.standard_normal((48, 512)) * 512 ** -0.5), _t(rng.standard_normal((512, 40)))


def _attention_values(rng):
    """P V over N = 6144 keys with softmax weights; logits wide enough
    (x8) that a few keys carry each row, as after training."""
    logits = rng.standard_normal((24, 6144)) * 8.0
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return _t(p / p.sum(-1, keepdims=True)), _t(rng.standard_normal((6144, 32)))


def _conv_taps(channels):
    """One output pixel row of K5: 9 taps x channels inputs against weights
    of scale 0.05, the main path's reductions."""
    def make(rng):
        k = 9 * channels
        return _t(rng.standard_normal((32, k))), _t(rng.standard_normal((k, 32)) * 0.05)
    return make


PRODUCTS = {"qk_512": _attention_scores, "pv_6144": _attention_values,
            "conv_9x128": _conv_taps(128), "conv_9x256": _conv_taps(256),
            "conv_9x512": _conv_taps(512)}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_three_product_sum_is_f32_class_where_plain_tf32_is_not(name):
    a, b = PRODUCTS[name](np.random.default_rng(sorted(PRODUCTS).index(name)))
    want = a.double() @ b.double()
    unit = max(1.0, float(want.abs().max()))
    err3 = float((tf32.matmul_3xtf32(a, b).double() - want).abs().max())
    err1 = float((tf32.matmul_tf32(a, b).double() - want).abs().max())
    assert err3 <= 1e-5 * unit, (name, err3)
    assert err1 > 1e-4, (name, err1)


def test_hi_plus_lo_reproduces_the_value_to_21_bits():
    rng = np.random.default_rng(7)
    a = _t(rng.standard_normal(100_000) * np.exp(rng.uniform(-20, 20, 100_000)))
    hi, lo = tf32.split_tf32(a)
    rel = ((hi.double() + lo.double()) - a.double()).abs() / a.double().abs()
    assert float(rel.max()) <= 2.0 ** -21
    assert float(rel.max()) > 2.0 ** -24     # and it is not simply a again
    # both parts are TF32 values, and lo is at most half a unit of hi's last place
    assert torch.equal(tf32.cut_tf32(hi), hi) and torch.equal(tf32.cut_tf32(lo), lo)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


def test_split_of_a_tf32_value_has_no_low_part():
    rng = np.random.default_rng(8)
    a = tf32.round_tf32(_t(rng.standard_normal(10_000) * 37.0))
    hi, lo = tf32.split_tf32(a)
    assert torch.equal(hi, a) and not bool(lo.any())
    # bf16 values are TF32 values: the conv kernels issue one product for them
    b = _t(rng.standard_normal(10_000)).to(torch.bfloat16).float()
    assert not bool(tf32.split_tf32(b)[1].any())


def test_rounding_is_to_nearest_with_ties_away_from_zero():
    step = 2.0 ** -10                       # TF32's unit in the last place at 1
    a = _t([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2.0 ** -23, 1 + 0.75 * step])
    want = _t([1 + step, -(1 + step), 1.0, 1 + step])
    assert torch.equal(tf32.round_tf32(a), want)
    # truncation would have given 1, -1, 1, 1
    assert torch.equal(tf32.cut_tf32(a), _t([1.0, -1.0, 1.0, 1.0]))


def test_zero_and_infinity_pass_through():
    a = _t([0.0, -0.0, np.inf, -np.inf])
    hi, lo = tf32.split_tf32(a)
    assert torch.equal(hi, a)
    assert torch.equal(torch.signbit(hi), torch.signbit(a))
    assert float(lo[0]) == 0.0 and float(lo[1]) == 0.0
    assert bool(torch.isnan(lo[2:]).all())   # inf - inf, as in the kernels


def test_functions_reject_other_types():
    with pytest.raises(TypeError):
        tf32.round_tf32(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        tf32.matmul_3xtf32(torch.zeros(2, 3), torch.zeros(4, 2))

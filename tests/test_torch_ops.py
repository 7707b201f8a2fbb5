"""The port's kernel modules against the JAX package's (dc_vic_tpu_torch.ops
vs dc_vic_tpu.ops): the plain PyTorch versions of K1 (VQ argmin) and K2
(flash attention) against the XLA references and the Pallas kernels run in
interpret mode, and the CPU dispatch of the CUDA wrappers. The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _vq_cases():
    rng = np.random.default_rng(0)
    cb = rng.standard_normal((256, 4)).astype(np.float32)
    ties = cb.copy()
    ties[100] = ties[7]      # exact duplicates: every hit on 7/100 is a tie
    ties[255] = ties[0]
    return {
        "random": (rng.standard_normal((4096, 4)).astype(np.float32), cb),
        "ragged": (rng.standard_normal((1024 + 37, 4)).astype(np.float32), cb),
        "ties": (np.repeat(ties, 8, axis=0), ties),
    }


@pytest.mark.parametrize("case", ["random", "ragged", "ties"])
def test_vq_plain_matches_xla(case):
    """Plain K1 equals _vq_argmin_xla exactly; ties go to the lower index."""
    from dc_vic_tpu.ops.vq import _vq_argmin_xla
    from dc_vic_tpu_torch.ops.vq import vq_argmin_plain
    z, cb = _vq_cases()[case]
    got = vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    want = np.asarray(_vq_argmin_xla(jnp.asarray(z), jnp.asarray(cb)))
    assert got.dtype == np.int32 and got.shape == (z.shape[0],)
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        assert got[100 * 8] == 7 and got[255 * 8] == 0


def test_vq_plain_matches_pallas_interpret(interpret_pallas):
    """Plain K1 equals the TPU kernel's logic (Pallas interpreter), padded
    tail included."""
    from dc_vic_tpu.ops.vq import _vq_argmin_pallas
    from dc_vic_tpu_torch.ops.vq import vq_argmin_plain
    z, cb = _vq_cases()["ragged"]
    got = vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_vq_argmin_pallas(jnp.asarray(z), jnp.asarray(cb))))


def _qkv(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    q = (rng.standard_normal(shape) * C ** -0.5 * scale).astype(np.float32)
    k = (rng.standard_normal(shape) * scale).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v


def test_attention_plain_matches_reference():
    """Plain K2 against _reference_attention at [2, 96, 32] (f32; tolerance
    1e-5 for the different summation order)."""
    from dc_vic_tpu.ops.attention import _reference_attention
    from dc_vic_tpu_torch.ops.attention import attention_plain
    q, k, v = _qkv((2, 96, 32), 1)
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(_reference_attention(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_attention_plain_matches_pallas_interpret(interpret_pallas):
    """Plain K2 against the TPU kernel's online softmax (Pallas interpreter)
    at [1, 1024, 128], tolerance 2e-5 as the JAX package's own test."""
    from dc_vic_tpu.ops.attention import _flash_attention_fwd_impl
    from dc_vic_tpu_torch.ops.attention import attention_plain
    q, k, v = _qkv((1, 1024, 128), 2)
    got = attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    want = np.asarray(_flash_attention_fwd_impl(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_cuda_wrappers_dispatch_by_device_without_cuda():
    """The wrapper modules import without CUDA (nvcc runs only inside a
    CUDA call); a CPU tensor takes the plain version without counting a
    launch; any other device raises instead of falling back."""
    from dc_vic_tpu_torch.ops import attention, native, vq
    assert "libdcvic_kernels.so" not in native._libs
    z, cb = (torch.from_numpy(a) for a in _vq_cases()["random"])
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 40, 16), 3))
    before = (vq.launches, attention.launches)
    assert torch.equal(vq.vq_argmin(z, cb), vq.vq_argmin_plain(z, cb))
    assert torch.equal(attention.flash_attention(q, k, v),
                       attention.attention_plain(q, k, v))
    assert (vq.launches, attention.launches) == before
    with pytest.raises(ValueError):
        vq.vq_argmin(z.to("meta"), cb.to("meta"))
    with pytest.raises(ValueError):
        attention.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert "libdcvic_kernels.so" not in native._libs

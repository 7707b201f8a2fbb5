"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Imports neither JAX nor the JAX package, so it runs where JAX is not
installed: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py -m cuda``. Without a GPU every test skips."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("M", [4 * 96 * 64, 1037])
def test_vq_argmin_kernel_matches_plain(dev, M):
    from dc_vic_tpu_torch.ops import vq
    g = torch.Generator(device=dev).manual_seed(M)
    z = torch.randn(M, 4, generator=g, device=dev)
    cb = torch.randn(256, 4, generator=g, device=dev)
    torch.testing.assert_close(vq.vq_argmin(z, cb), vq.vq_argmin_plain(z, cb),
                               atol=0, rtol=0)


def test_vq_argmin_kernel_ties_take_lower_index(dev):
    from dc_vic_tpu_torch.ops import vq
    g = torch.Generator(device=dev).manual_seed(1)
    cb = torch.randn(256, 4, generator=g, device=dev)
    cb[100], cb[255] = cb[7], cb[0]
    got = vq.vq_argmin(cb.repeat_interleave(8, 0), cb)
    assert int(got[100 * 8]) == 7 and int(got[255 * 8]) == 0


@pytest.mark.parametrize("shape,scale", [((2, 6144, 512), 1.0),
                                         ((1, 1000, 512), 1.0),
                                         ((1, 1024, 128), 3.0)])
def test_flash_attention_kernel_matches_plain(dev, shape, scale):
    """atol = rtol = 1e-4: the kernel sums in another order than cuBLAS."""
    from dc_vic_tpu_torch.ops import attention
    g = torch.Generator(device=dev).manual_seed(shape[1])
    pre = shape[-1] ** -0.5 if scale == 1.0 else scale
    q = torch.randn(shape, generator=g, device=dev) * pre
    k = torch.randn(shape, generator=g, device=dev) * scale
    v = torch.randn(shape, generator=g, device=dev)
    torch.testing.assert_close(attention.flash_attention(q, k, v),
                               attention.attention_plain(q, k, v),
                               atol=1e-4, rtol=1e-4)


def test_flash_attention_kernel_rejects_unsupported_width(dev):
    from dc_vic_tpu_torch.ops import attention
    q = torch.zeros(1, 8, 516, device=dev)
    with pytest.raises(ValueError):
        attention.flash_attention(q, q, q)

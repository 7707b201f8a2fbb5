"""CUDA kernels of the port against their plain PyTorch versions, on the
card. Imports neither JAX nor the JAX package, so it runs where JAX is not
installed: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py -m cuda``. Without a GPU every test skips."""
import numpy as np
import pytest
import torch

import vq_model

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _vq_held(got, z, cb):
    """K1's indices equal its numpy model's (tests/vq_model.py: the same
    FFMAs, lane slices and butterfly) bit for bit, and the plain version's
    but for near ties (the exact distances of the two picks within 1e-6
    max(1, |d|))."""
    from dc_vic_tpu_torch.ops import vq
    z_np, cb_np = z.cpu().numpy(), cb.cpu().numpy()
    np.testing.assert_array_equal(got.cpu().numpy(), vq_model.kernel_argmin(z_np, cb_np))
    want = vq.vq_argmin_plain(z, cb).cpu().numpy()
    z64, cb64 = z_np.astype(np.float64), cb_np.astype(np.float64)
    rows = np.arange(len(z_np))
    g, w = got.cpu().numpy(), want
    d_got = (cb64[g] ** 2).sum(1) - 2 * (z64 * cb64[g]).sum(1)
    d_want = (cb64[w] ** 2).sum(1) - 2 * (z64 * cb64[w]).sum(1)
    assert not ((g != w) & (np.abs(d_got - d_want) >= 1e-6 * np.maximum(1, np.abs(d_want)))
                ).any(), rows[g != w][:10]


# the port's VQ rows: training, batch 4, the tiled 2048x1365 canvas, the
# contract's batch 16; and a ragged M
@pytest.mark.parametrize("M", [6144, 4 * 96 * 64, 45056, 16 * 96 * 64, 1037])
def test_vq_argmin_kernel_matches_plain(dev, M):
    from dc_vic_tpu_torch.ops import vq
    g = torch.Generator(device=dev).manual_seed(M)
    z = torch.randn(M, 4, generator=g, device=dev)
    cb = torch.randn(256, 4, generator=g, device=dev)
    _vq_held(vq.vq_argmin(z, cb), z, cb)


@pytest.mark.parametrize("N", [1000, 11622, 1037, 3])
def test_vq_argmin_kernel_other_codebook_sizes(dev, N):
    """Codebooks of 1000 entries, of 11,622 (the most shared memory takes)
    and of sizes no multiple of the lanes."""
    from dc_vic_tpu_torch.ops import vq
    g = torch.Generator(device=dev).manual_seed(N)
    z = torch.randn(3001, 4, generator=g, device=dev)
    cb = torch.randn(N, 4, generator=g, device=dev)
    _vq_held(vq.vq_argmin(z, cb), z, cb)


def test_vq_argmin_kernel_ties_take_lower_index(dev):
    """Exact duplicates in other lanes' slices (n mod 4 differs) and in the
    same slice: every row on one of them goes to the lower index."""
    from dc_vic_tpu_torch.ops import vq
    g = torch.Generator(device=dev).manual_seed(1)
    cb = torch.randn(256, 4, generator=g, device=dev)
    cb[100], cb[255], cb[13], cb[12] = cb[7], cb[0], cb[6], cb[4]
    got = vq.vq_argmin(cb.repeat_interleave(8, 0), cb)
    for dup, first in ((100, 7), (255, 0), (13, 6), (12, 4)):
        assert (got[dup * 8:dup * 8 + 8] == first).all()
    _vq_held(got, cb.repeat_interleave(8, 0), cb)


@pytest.mark.parametrize("shape", [(16, 96, 64), (3, 37, 29), (2, 1, 45)])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_vq_argmin_nchw_entry_equals_flat_entry(dev, shape, layout):
    """The NCHW entry reads the latent in place and gives the flat entry's
    indices, at B > 1 with H W no multiple of a block's rows."""
    from dc_vic_tpu_torch.ops import vq
    B, H, W = shape
    g = torch.Generator(device=dev).manual_seed(H * W)
    z = torch.randn(B, 4, H, W, generator=g, device=dev)
    if layout == "channels_last":
        z = z.contiguous(memory_format=torch.channels_last)
    cb = torch.randn(256, 4, generator=g, device=dev)
    before = vq.launches
    got = vq.vq_argmin_nchw(z, cb)
    assert vq.launches == before + 1
    flat = z.permute(0, 2, 3, 1).reshape(-1, 4).contiguous()
    assert torch.equal(got, vq.vq_argmin(flat, cb).reshape(B, H, W))
    _vq_held(got.reshape(-1), flat, cb)


@pytest.mark.parametrize("shape,scale", [((2, 6144, 512), 1.0),
                                         ((1, 1000, 512), 1.0),
                                         ((1, 1024, 128), 3.0),
                                         ((1, 1037, 512), 1.0),    # N a multiple of no tile
                                         ((2, 777, 256), 1.0),
                                         ((1, 2048, 512), 0.728)])  # scores over about +-60
def test_flash_attention_kernel_matches_plain(dev, shape, scale):
    """atol = rtol = 1e-4: the kernel sums in another order than cuBLAS and
    takes each product as three TF32 products. A scale other than 1
    multiplies q and k: wide scores move the running maximum often, so the
    online rescale works hardest. At scores of +-500 (scale 3 at C = 128) an
    f32 score is only good to 1e-4 and the f32 plain version itself can
    leave the tolerance against float64, so the kernel is held to float64
    always and to the plain version wherever that is within the tolerance of
    float64 itself. Bitwise repeatable."""
    from dc_vic_tpu_torch.ops import attention
    g = torch.Generator(device=dev).manual_seed(shape[1])
    pre = shape[-1] ** -0.5 if scale == 1.0 else scale
    q = torch.randn(shape, generator=g, device=dev) * pre
    k = torch.randn(shape, generator=g, device=dev) * scale
    v = torch.randn(shape, generator=g, device=dev)
    got = attention.flash_attention(q, k, v)
    assert bool(torch.isfinite(got).all())
    want = attention.attention_plain(q, k, v)
    exact = torch.bmm(torch.softmax(torch.bmm(q.double(), k.double().transpose(1, 2)), -1),
                      v.double()).float()
    torch.testing.assert_close(got, exact, atol=1e-4, rtol=1e-4)
    if torch.allclose(want, exact, atol=1e-4, rtol=1e-4):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got, attention.flash_attention(q, k, v))


def test_flash_attention_kernel_weights_sum_to_one_at_a_ragged_length(dev):
    """With every value row equal to 1 the output is the sum of the softmax
    weights: 1 in every row, also where the last key tile is cut short (keys
    past N must weigh nothing, and the denominator must count the same keys)."""
    from dc_vic_tpu_torch.ops import attention
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, 1037, 128, generator=g, device=dev) * 0.3
    k = torch.randn(2, 1037, 128, generator=g, device=dev)
    got = attention.flash_attention(q, k, torch.ones_like(k))
    torch.testing.assert_close(got, torch.ones_like(got), atol=1e-5, rtol=0)


def test_flash_attention_kernel_rejects_unsupported_width(dev):
    """The kernel takes C = 128, 256, 384 or 512 (whole 128-channel chunks):
    its launcher raises for other widths, and ``flash_attention`` sends
    them, like bf16 operands, to the plain version on the card without a
    launch."""
    from dc_vic_tpu_torch.ops import attention
    g = torch.Generator(device=dev).manual_seed(5)
    for width in (516, 64, 640):
        q = torch.randn(1, 8, width, generator=g, device=dev)
        with pytest.raises(ValueError):
            attention._flash_attention_cuda(q, q, q)
        before = attention.launches
        assert torch.equal(attention.flash_attention(q, q, q), attention.attention_plain(q, q, q))
        assert attention.launches == before
    q = torch.randn(2, 300, 128, generator=g, device=dev).bfloat16()
    before = attention.launches
    assert torch.equal(attention.flash_attention(q, q, q), attention.attention_plain(q, q, q))
    assert attention.launches == before


def test_vq_argmin_outside_the_kernel_rule_takes_the_plain_version(dev):
    """D other than 4 (here 8) goes to the plain version on the card, as
    the reference goes to XLA; no launch, no error."""
    from dc_vic_tpu_torch.ops import vq
    g = torch.Generator(device=dev).manual_seed(6)
    z, cb = torch.randn(1000, 8, generator=g, device=dev), torch.randn(256, 8, generator=g,
                                                                      device=dev)
    before = vq.launches
    assert torch.equal(vq.vq_argmin(z, cb), vq.vq_argmin_plain(z, cb))
    assert vq.launches == before


# ------------------------------------------------- K3, K4: GroupNorm kernels

def _border(t):
    """The one-pixel frame of the last two dims, flattened."""
    return torch.cat([t[..., 0, :].flatten(), t[..., -1, :].flatten(),
                      t[..., :, 0].flatten(), t[..., :, -1].flatten()])


@pytest.mark.parametrize("shape,dtype", [((2, 128, 96, 64), torch.float32),
                                         ((1, 24, 37, 53), torch.float32),
                                         ((2, 128, 48, 64), torch.bfloat16),
                                         ((2, 128, 384, 256), torch.bfloat16)])
def test_gn_channel_sums_kernel_matches_float64(dev, shape, dtype):
    """Kernel and plain version both within 1e-5 of sum|x| (resp. sum x^2) of
    a float64 sum of the same input; the kernel is bitwise repeatable."""
    from dc_vic_tpu_torch.ops import gn
    g = torch.Generator(device=dev).manual_seed(shape[2])
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    xd = x.double().flatten(2)
    want = torch.stack([xd.sum(-1), (xd * xd).sum(-1)], 1)
    scale = torch.stack([xd.abs().sum(-1), (xd * xd).sum(-1)], 1)
    got = gn.channel_sums(x)
    assert got.shape == (shape[0], 2, shape[1]) and got.dtype == torch.float32
    for val in (got, gn.channel_sums_plain(x)):
        assert bool(((val.double() - want).abs() <= 1e-5 * scale).all())
    assert torch.equal(got, gn.channel_sums(x))


@pytest.mark.parametrize("act", [None, "swish"])
@pytest.mark.parametrize("shape,dtype", [((2, 128, 96, 64), torch.float32),
                                         ((1, 24, 37, 53), torch.float32),
                                         ((2, 128, 48, 64), torch.bfloat16),
                                         ((2, 128, 384, 256), torch.bfloat16)])
def test_gn_apply_kernel_matches_plain(dev, shape, dtype, act):
    """f32: atol = rtol = 1e-6 (the affine has the plain version's bits, the
    sigmoid may differ in the last place); bf16: one ulp of the output."""
    from dc_vic_tpu_torch.ops import gn
    g = torch.Generator(device=dev).manual_seed(shape[3])
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    scale = torch.rand(shape[:2], generator=g, device=dev) * 1.5 + 0.5
    bias = torch.randn(shape[:2], generator=g, device=dev)
    got = gn.apply_affine(x, scale, bias, act)
    want = gn.apply_affine_plain(x, scale, bias, act)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(got, gn.apply_affine(x, scale, bias, act))


def test_group_norm_kernels_match_module_code(dev):
    """K3 + K4 end to end against GroupNorm's ordinary PyTorch forward;
    2e-5 as the JAX package holds its kernels to flax."""
    from dc_vic_tpu_torch.nn.layers import GroupNorm
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(2, 128, 64, 48, generator=g, device=dev) * 3 + 2
    norm = GroupNorm(32, 128, act="swish").to(dev)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(128, generator=g, device=dev) + 0.5)
        norm.bias.copy_(torch.randn(128, generator=g, device=dev) * 0.1)
        want = norm(x)
        norm.recon_kernel = True
        assert norm.takes_kernel(x.shape)
        got = norm(x)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_gn_kernels_reject_bad_input(dev):
    from dc_vic_tpu_torch.ops import gn
    x = torch.zeros(2, 8, 4, 4, device=dev)
    with pytest.raises(ValueError):
        gn.channel_sums(torch.zeros(2, 8, device=dev))
    with pytest.raises(ValueError):
        gn.apply_affine(x, torch.zeros(2, 4, device=dev), torch.zeros(2, 4, device=dev))
    with pytest.raises(TypeError):
        gn.channel_sums(x.to(torch.float16))


# ---------------------------------------------------- K5, K6: conv kernels

def _conv_case(dev, B, C, Cout, H, W, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, C, H, W, generator=g, device=dev).to(dtype)
    w = (torch.randn(Cout, C, 3, 3, generator=g, device=dev) * 0.05).to(dtype)
    scale = torch.rand(B, C, generator=g, device=dev) * 1.5 + 0.5
    bias = torch.randn(B, C, generator=g, device=dev) + 2.0   # swish(bias) far from 0
    cbias = torch.randn(Cout, generator=g, device=dev)
    res = torch.randn(B, Cout, H, W, generator=g, device=dev).to(dtype)
    return x, w, scale, bias, cbias, res


CONV_SHAPES = [((2, 128, 128, 16, 64), torch.float32),
               ((1, 256, 128, 24, 32), torch.float32),    # a channel change
               ((1, 128, 64, 13, 37), torch.float32),     # odd plane: ragged tiles
               ((1, 128, 128, 16, 32), torch.bfloat16),
               ((2, 128, 128, 192, 128), torch.bfloat16),  # a plane that passes the shape rule
               ((1, 256, 128, 24, 32), torch.bfloat16),    # bf16 across a channel change
               ((1, 512, 512, 24, 32), torch.float32)]    # the path's deepest reduction


@pytest.fixture()
def no_tf32():
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize("shape,dtype", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(dev, no_tf32, shape, dtype):
    """atol = rtol = 1e-4 in f32 against F.conv2d with TF32 off (another
    summation order, each product three TF32 products), 1e-2 in bf16 (one
    step of the output type: both round an f32 sum once); border and whole
    tensor; bitwise repeatable."""
    from dc_vic_tpu_torch.ops import conv3x3
    B, C, Cout, H, W = shape
    x, w, *_ = _conv_case(dev, B, C, Cout, H, W, dtype, H)
    got = conv3x3.conv3x3_same(x, w)
    want = conv3x3.conv3x3_same_plain(x, w)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(_border(got), _border(want), atol=tol, rtol=tol)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(got, conv3x3.conv3x3_same(x, w))


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape,dtype", CONV_SHAPES)
def test_conv3x3_gn_swish_kernel_matches_plain(dev, no_tf32, shape, dtype, with_res):
    """As above for the fused kernel. The affine's bias is near 2, so a
    halo that went through affine and swish instead of being zero would put
    about 1.8 into every border tap: the border is checked on its own."""
    from dc_vic_tpu_torch.ops import conv3x3
    B, C, Cout, H, W = shape
    x, w, scale, bias, cbias, res = _conv_case(dev, B, C, Cout, H, W, dtype, W)
    res = res if with_res else None
    got = conv3x3.conv3x3_gn_swish(x, w, scale, bias, cbias, res)
    want = conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(_border(got), _border(want), atol=tol, rtol=tol)
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    assert torch.equal(got, conv3x3.conv3x3_gn_swish(x, w, scale, bias, cbias, res))


def test_conv3x3_kernels_take_channels_last_memory(dev, no_tf32):
    """An input that is channels-last in memory is brought to row-major
    before the kernel indexes it."""
    from dc_vic_tpu_torch.ops import conv3x3
    x, w, *_ = _conv_case(dev, 1, 128, 64, 8, 8, torch.float32, 3)
    xl = x.to(memory_format=torch.channels_last)
    assert torch.equal(conv3x3.conv3x3_same(xl, w), conv3x3.conv3x3_same(x, w))


# the bf16 kernels' ragged cases: W not a multiple of the 64-column tile, H
# not a multiple of its 4 rows, C of one and of three 16-channel steps, Cout
# of half a 128-channel tile and of one and a half
BF16_RAGGED = [(1, 16, 64, 13, 37), (2, 48, 192, 10, 70), (1, 32, 128, 6, 130),
               (1, 256, 256, 9, 64)]


@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", BF16_RAGGED)
def test_conv3x3_bf16_kernels_match_plain_at_ragged_sizes(dev, no_tf32, shape, with_res):
    """K5 (without the residual case) and K6 in bf16 against their plain
    versions: atol = rtol = 1e-2, one step of the output type, whole tensor
    and border; bitwise repeatable."""
    from dc_vic_tpu_torch.ops import conv3x3
    B, C, Cout, H, W = shape
    x, w, scale, bias, cbias, res = _conv_case(dev, B, C, Cout, H, W, torch.bfloat16, C + H)
    res = res if with_res else None
    cases = [(lambda: conv3x3.conv3x3_gn_swish(x, w, scale, bias, cbias, res),
              conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res))]
    if not with_res:
        cases.append((lambda: conv3x3.conv3x3_same(x, w), conv3x3.conv3x3_same_plain(x, w)))
    for kernel, want in cases:
        got = kernel()
        assert got.dtype == torch.bfloat16 and got.shape == (B, Cout, H, W)
        torch.testing.assert_close(_border(got), _border(want), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
        assert torch.equal(got, kernel())


def test_conv3x3_bf16_kernels_take_channels_last_memory(dev):
    from dc_vic_tpu_torch.ops import conv3x3
    x, w, scale, bias, cbias, res = _conv_case(dev, 2, 48, 192, 10, 70, torch.bfloat16, 5)
    xl, rl = (t.to(memory_format=torch.channels_last) for t in (x, res))
    assert torch.equal(conv3x3.conv3x3_same(xl, w), conv3x3.conv3x3_same(x, w))
    assert torch.equal(conv3x3.conv3x3_gn_swish(xl, w, scale, bias, cbias, rl),
                       conv3x3.conv3x3_gn_swish(x, w, scale, bias, cbias, res))


@pytest.mark.parametrize("C,Cout", [(16, 64), (48, 192), (256, 256)])
def test_bf16_weight_repack_kernel_equals_plain(dev, C, Cout):
    """The kernels' first pass, bit for bit."""
    from dc_vic_tpu_torch.ops import conv3x3
    _, w, *_ = _conv_case(dev, 1, C, Cout, 1, 1, torch.bfloat16, C)
    assert torch.equal(conv3x3.repack_weights_bf16(w), conv3x3.repack_weights_bf16_plain(w))


def test_conv3x3_kernels_reject_unsupported_shapes(dev):
    from dc_vic_tpu_torch.ops import conv3x3
    x = torch.zeros(1, 12, 8, 8, device=dev)
    with pytest.raises(ValueError):                      # C % 8 != 0
        conv3x3.conv3x3_same(x, torch.zeros(64, 12, 3, 3, device=dev))
    x = torch.zeros(1, 16, 8, 8, device=dev)
    with pytest.raises(ValueError):                      # Cout % 64 != 0
        conv3x3.conv3x3_same(x, torch.zeros(32, 16, 3, 3, device=dev))
    with pytest.raises(ValueError):                      # not a 3x3 kernel
        conv3x3.conv3x3_same(x, torch.zeros(64, 16, 5, 5, device=dev))
    with pytest.raises(ValueError):                      # bf16 and C % 16 != 0
        conv3x3.conv3x3_same(torch.zeros(1, 24, 8, 8, device=dev, dtype=torch.bfloat16),
                             torch.zeros(64, 24, 3, 3, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        conv3x3.repack_weights_bf16(torch.zeros(64, 24, 3, 3, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):                      # scale of another batch
        conv3x3.conv3x3_gn_swish(x, torch.zeros(64, 16, 3, 3, device=dev),
                                 torch.zeros(2, 16, device=dev),
                                 torch.zeros(2, 16, device=dev),
                                 torch.zeros(64, device=dev))


def test_fused_resblock_kernels_match_unfused_module(dev, no_tf32):
    """VQResnetBlock through two K6 calls against its ordinary forward on
    the same parameters; 2e-4 as the JAX package holds fused to unfused."""
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(2, 128, 128, 96, generator=g, device=dev) * 0.7
    for out_ch in (128, 256):
        blk = VQResnetBlock(128, out_ch).to(dev)
        with torch.no_grad():
            for p in blk.parameters():
                p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
            want = blk(x)
            blk.fused = True
            assert blk.takes_fused(x.shape)
            got = blk(x)
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


def test_bf16_modules_hand_the_kernels_bf16(dev, no_tf32):
    """A bf16 VQResnetBlock with every route on against its ordinary bf16
    forward: the fused route (two K6 calls on bf16 operands, f32 folded
    affine and conv bias) and the GroupNorm + conv route (K3, K4, K5);
    5e-2 (steps of the bf16 output after 1152 taps, twice)."""
    from dc_vic_tpu_torch.models import set_compute_dtype
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import Conv2d, GroupNorm
    from dc_vic_tpu_torch.ops import conv3x3, gn
    g = torch.Generator(device=dev).manual_seed(11)
    x = (torch.randn(2, 128, 128, 96, generator=g, device=dev) * 0.7).to(torch.bfloat16)
    blk = VQResnetBlock(128, 256).to(dev)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
        set_compute_dtype(blk, torch.bfloat16)
        want = blk(x)
        before = dict(conv3x3.launches), dict(gn.launches)
        blk.fused = True
        fused = blk(x)
        assert conv3x3.launches["conv3x3_gn_swish"] == before[0]["conv3x3_gn_swish"] + 2
        blk.fused = False
        for m in blk.modules():
            if isinstance(m, (GroupNorm, Conv2d)):
                m.recon_kernel = True
        routed = blk(x)
        assert conv3x3.launches["conv3x3_same"] == before[0]["conv3x3_same"] + 2
        assert gn.launches["gn_apply"] == before[1]["gn_apply"] + 2
    for got in (fused, routed):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, want, atol=5e-2, rtol=5e-2)


def _tiny_config(vq_ch=8, **numerics):
    """The narrow flagship-family model of the CPU tests (tests/helpers.py,
    which this file cannot import: it pulls in the JAX package). ``vq_ch``
    64 makes the VQGAN's attention 128 wide, the narrowest K2 takes."""
    film = dict(max_beta_1=3.0, max_beta_2=3.5, cond_ch=16, L=4, use_pi=False, include_x=True)
    return dict(
        numerics,
        model={"type": "HyperpriorCharmDualCondVicModel", "enc_vq_input": "onehot_indices",
               "selected_beta_rate": [2.29, 1.12, 0.16], "selected_beta_vq": [3.0, 2.0, 1.0]},
        subnet={
            "encoder": dict(type="ElicDualBetaFtVqScEncoder", in_ch=3, out_ch=24, main_ch=16,
                            block_mid_ch=8, num_blocks=1, **film),
            "decoder": dict(type="ElicDualBetaFtFeatFusionDecoder", out_ch=3, main_ch=16,
                            block_mid_ch=8, num_blocks=1, use_tanh=False,
                            feat_layer_name="block1",
                            fusion_layer_dict={"block1": "block_1_8", "block2": "block_1_4",
                                               "block3": "block_1_2"}, **film),
            "hyperencoder": {"type": "Minnen20HyperEncoder", "bottleneck_z": 16},
            "hyperdecoder": {"type": "Minnen20HyperDecoder", "hyper_out_ch": 32},
            "context_model": {"type": "Minnen20CharmContextModel", "num_slices": 6,
                              "max_support_slices": 4, "slice_mid_ch": (16, 16)},
            "entropy_model_z": {"type": "SteEntropyBottleneck", "channels": 16},
            "entropy_model_y": {"type": "SteGaussianMeanScaleConditional", "scale_bound": 0.11},
            "fusion_module": {"fuse_type": "sft", "fuse_scedule_dict": {
                "block_1_8": {"dec_ch": 16, "cond_ch": 16, "mid_ch": 16},
                "block_1_4": {"dec_ch": 8, "cond_ch": 16, "mid_ch": 8},
                "block_1_2": {"dec_ch": 8, "cond_ch": 16, "mid_ch": 8}}},
            "vq_estimator": {"type": "DualBlockSwinVqEstimator", "main_ch": 16,
                             "num_swin_blocks": 1, "blk_depth": 1, "num_heads": 2,
                             "window_size": 4, "use_upsample": False},
            "vq_model": {"embed_dim": 4, "n_embed": 32, "ddconfig": {
                "double_z": False, "z_channels": 4, "resolution": 64, "in_channels": 3,
                "out_ch": 3, "ch": vq_ch, "ch_mult": [1, 1, 1, 2], "num_res_blocks": 1,
                "attn_resolutions": [8]}}})


def test_entropy_precision_default_is_scoped_and_self_consistent(dev):
    """On the card ``entropy_precision: default`` changes the entropy chain's
    floats (TF32 products) only inside the chain's methods, gives the same
    bits on a second call, and leaves the process-wide flag as it was."""
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    old = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = False, True
    try:
        out = {}
        for precision in ("high", "default"):
            spec = build_comp_model(_tiny_config(entropy_precision=precision))
            init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
            z = torch.randint(-4, 5, (2, 16, 6, 4), device=dev,
                              generator=torch.Generator(device=dev).manual_seed(1)).to(torch.int16)
            with torch.no_grad():
                out[precision] = spec.module.hyper_decode(z)[0]
                assert torch.equal(out[precision], spec.module.hyper_decode(z)[0])
            assert torch.backends.cudnn.allow_tf32 is False
        torch.testing.assert_close(out["default"], out["high"], atol=1e-2, rtol=1e-2)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = old


def test_portable_stream_decodes_in_any_grouping_on_the_card(dev):
    """The tiny model in the deployment numerics, portable, device backend:
    a batch-4 stream decodes bit-exactly as 4, 2 + 2 and 4 x 1."""
    import numpy as np
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    spec = build_comp_model(_tiny_config(vq_ch=64, codec_dtype="bfloat16",
                                         entropy_precision="default"))
    init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
    codec = Codec(spec, encode_backend="device", lanes=8, portable=True)
    img = np.random.default_rng(0).integers(0, 256, (4, 128, 192, 3), dtype=np.uint8)
    res = codec.compress(img, 0, debug=True)
    sls = [r["string_list"] for r in res]
    for group in ([0, 1, 2, 3], [0, 1], [2, 3], [0], [1], [2], [3]):
        assert codec.verify_roundtrip([res[b] for b in group], [sls[b] for b in group],
                                      (128, 192)), group


def test_compressai_codec_decodes_a_tpu_stream_on_the_card(dev):
    """A default compressai Codec keeps its entropy chain on the CPU, yet
    reads tpu-format streams through the model's own chain on the card,
    where their parameters were derived: latents and pixels bit-exact."""
    import numpy as np
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    spec = build_comp_model(_tiny_config())
    init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
    tpu = Codec(spec, encode_backend="device", lanes=8)
    img = np.random.default_rng(0).integers(0, 256, (2, 128, 192, 3), dtype=np.uint8)
    res = tpu.compress(img, 1, debug=True)
    sls = [r["string_list"] for r in res]
    reader = Codec(spec, stream_format="compressai")
    assert reader.params_backend == "cpu" and reader._chain_device.type == "cpu"
    assert reader.verify_roundtrip(res, sls, (128, 192))
    np.testing.assert_array_equal(reader.decompress(sls), tpu.decompress(sls))


# ------------------------------------------- R1, R2: the tpu format's coder

def _rans_case(dev, shape, S, lanes, factorised, big, seed):
    """Symbol and index planes on the card with 3% escapes (``big``: some
    past +-32768, which need tier-2 words and int32 planes), and the table."""
    import numpy as np
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional, get_scale_table
    from dc_vic_tpu_torch.ops import rans_device as rd
    host = GaussianConditional().build_cdf_table(get_scale_table())
    rng = np.random.default_rng(seed)
    idx = None if factorised else rng.integers(0, 64, shape).astype(np.uint8)
    sym = rng.integers(-3, 4, shape)
    sym = np.where(rng.random(shape) < 0.03, rng.integers(-20000, 20000, shape), sym)
    if big:
        sym = np.where(rng.random(shape) < 0.01, rng.integers(-40000, 40000, shape), sym)
    sym = torch.from_numpy(sym.astype(np.int32 if big else np.int16)).to(dev)
    return sym, (None if idx is None else torch.from_numpy(idx).to(dev)), \
        host, rd.DeviceCdfTable(host, dev)


@pytest.mark.parametrize("shape,S,lanes,factorised,big", [
    ((2, 12, 16, 32), 3, 128, False, False),
    ((2, 12, 16, 32), 3, 128, False, True),
    ((1, 8, 4, 4), 2, 4, False, False),          # fewer lanes than a warp
    ((2, 64, 8, 8), 1, 512, True, False),        # CDF row = channel
    ((1, 16, 64, 128), 1, 4096, False, True),    # more lanes than a block
    ((16, 8, 16, 32), 2, 32, False, True),       # batch 16, one warp of lanes
    ((1, 32, 48, 32), 1, 1024, False, False),    # one full block of lanes
    ((2, 16, 64, 128), 1, 2048, False, True)])   # two rounds of a block
def test_rans_kernels_match_plain_and_host_coder(dev, shape, S, lanes, factorised, big):
    """R1's words, counts and escape counts equal the plain version's and
    the host coder's bytes; R2's symbols, cursors and lane states equal the
    plain version's section by section; integers, no tolerance."""
    from dc_vic_tpu_torch.ops import rans_device as rd
    from dc_vic_tpu_torch.ops.rans_host import tpu_encode_sections
    sym, idx, host, table = _rans_case(dev, shape, S, lanes, factorised, big, shape[2])
    B, C, H, W = shape
    sc = C // S
    L = rd.section_lanes(sc * H * W, lanes)
    packed, offsets, counts, esc, t2 = rd.encode_pack(sym, idx, S, lanes, table)
    rows = rd.channel_rows(B, C, H, W, dev) if idx is None else idx
    sections = [(rd.to_stream(sym[:, s * sc:(s + 1) * sc], L),
                 rd.to_stream(rows[:, s * sc:(s + 1) * sc], L)) for s in range(S)]
    vals, mask, p_esc, p_t2 = rd.encode_stream_plain(sections, table)
    p_packed, p_counts = rd.pack_streams_plain(vals, mask)
    assert torch.equal(counts, p_counts) and torch.equal(esc, p_esc) and torch.equal(t2, p_t2)
    assert bool(t2.sum() > 0) == big
    words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
    assert torch.equal(words, p_packed[:words.numel()])
    base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    for b in range(B):
        data = tpu_encode_sections([(s[b].cpu().numpy(), i[b].cpu().numpy())
                                    for s, i in sections], host)
        o, n = int(base[b]), int(counts[b])
        assert words[o:o + n].cpu().numpy().tobytes() == data
    cur = p_cur = torch.zeros(B, dtype=torch.int32, device=dev)
    state = p_state = None
    for s in range(S):
        sec_idx = None if idx is None else idx[:, s * sc:(s + 1) * sc].contiguous()
        got, cur, state = rd.decode_section(words, base, cur, state, sec_idx, (B, sc, H, W),
                                            lanes, table, out_dtype=torch.int32)
        want, p_cur, p_state = rd.decode_section_plain(words, base, p_cur, p_state,
                                                       sections[s][1], table)
        assert torch.equal(got, rd.from_stream(want, sc, H, W))
        assert torch.equal(got, sym[:, s * sc:(s + 1) * sc].to(torch.int32))
        assert torch.equal(cur, p_cur) and torch.equal(state, p_state)
    assert torch.equal(cur, counts) and bool((state == rd.RANS_L).all())


@pytest.mark.parametrize("lanes", [128, 512])
def test_rans_kernels_read_a_wide_table_in_place(dev, lanes):
    """A factorised table of 192 x 323 bins, more than R2 copies into shared
    memory: R1's words equal the plain version's and the host coder's, R2's
    symbols, cursor and states the plain version's."""
    import numpy as np
    from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck, build_bottleneck_cdf
    from dc_vic_tpu_torch.models import init_weights
    from dc_vic_tpu_torch.ops import rans_device as rd
    from dc_vic_tpu_torch.ops.rans_host import tpu_encode_sections
    eb = EntropyBottleneck(192)
    init_weights(eb, torch.Generator().manual_seed(3))
    with torch.no_grad():
        eb.quantiles[:, 0, 0] = eb.quantiles[:, 0, 1] - 160
        eb.quantiles[:, 0, 2] = eb.quantiles[:, 0, 1] + 160
    host = build_bottleneck_cdf(eb)
    table = rd.DeviceCdfTable(host, dev)
    assert table.pair_packed.numel() > 44 * 1024
    B, C, H, W = 2, 192, 12, 8
    rng = np.random.default_rng(lanes)
    maxv = table.maxv.cpu().numpy()[None, :, None, None]
    sym = rng.integers(0, maxv, (B, C, H, W)) + table.offsets.cpu().numpy()[None, :, None, None]
    sym = np.where(rng.random(sym.shape) < 0.03, rng.integers(-20000, 20000, sym.shape), sym)
    sym = torch.from_numpy(sym.astype(np.int16)).to(dev)
    packed, offsets, counts, _, _ = rd.encode_pack(sym, None, 1, lanes, table)
    L = rd.section_lanes(C * H * W, lanes)
    rows = rd.channel_rows(B, C, H, W, dev)
    sections = [(rd.to_stream(sym, L), rd.to_stream(rows, L))]
    p_packed, p_counts = rd.pack_streams_plain(*rd.encode_stream_plain(sections, table)[:2])
    assert torch.equal(counts, p_counts)
    words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
    assert torch.equal(words, p_packed[:words.numel()])
    base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    for b in range(B):
        data = tpu_encode_sections([(sections[0][0][b].cpu().numpy(),
                                     sections[0][1][b].cpu().numpy())], host)
        o, n = int(base[b]), int(counts[b])
        assert words[o:o + n].cpu().numpy().tobytes() == data
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    got, cur, state = rd.decode_section(words, base, zero, None, None, (B, C, H, W), lanes,
                                        table, out_dtype=torch.int32)
    want, p_cur, p_state = rd.decode_section_plain(words, base, zero, None, sections[0][1], table)
    assert torch.equal(got, rd.from_stream(want, C, H, W)) and torch.equal(got, sym.int())
    assert torch.equal(cur, p_cur) and torch.equal(state, p_state)


def test_rans_decode_kernel_survives_a_truncated_stream(dev):
    """Reads past the buffer give zero words: no fault, and a cursor that
    the integrity check refuses."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.ops import rans_device as rd
    shape = (2, 8, 16, 16)
    sym, idx, _, table = _rans_case(dev, shape, 1, 128, False, False, 5)
    packed, offsets, counts, _, _ = rd.encode_pack(sym, idx, 1, 128, table)
    words = packed[:int(counts[0]) // 2].contiguous()
    base = torch.tensor([0, 10 ** 6], dtype=torch.int32, device=dev)
    zero = torch.zeros(2, dtype=torch.int32, device=dev)
    _, cur, _ = rd.decode_section(words, base, zero, None, idx, shape, 128, table)
    torch.cuda.synchronize()
    strs = [b"\0\0" * words.numel(), b""]
    with pytest.raises(RuntimeError):
        Codec._check_consumed(torch.stack([cur, cur]).cpu().numpy(), strs, strs)


def test_rans_wrappers_reject_bad_input(dev):
    from dc_vic_tpu_torch.ops import rans_device as rd
    sym, idx, _, table = _rans_case(dev, (1, 4, 4, 4), 1, 128, False, False, 1)
    with pytest.raises(TypeError):                      # indexes on another device
        rd.encode_pack(sym, idx.cpu(), 1, 128, table)
    words = torch.zeros(8, dtype=torch.int16, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                      # cursor of another type
        rd.decode_section(words, zero, zero.long(), None, idx, (1, 4, 4, 4), 128, table)
    with pytest.raises(TypeError):                      # state of another shape
        rd.decode_section(words, zero, zero, torch.zeros((1, 3), dtype=torch.int32, device=dev),
                          idx, (1, 4, 4, 4), 128, table)

"""The differentiable pieces under the training path, against the JAX
package: ``lower_bound``'s one-sided gradient, ``ste_round``, the kernel
Functions' backwards (K2 against ``jax.vjp`` of the JAX package's
``flash_attention``; K2 to K6 by ``torch.autograd.gradcheck`` in float64
through their Functions, which on the CPU run the plain forwards), the
eval forward, ``extract_y_hat``, ``encode_deterministic`` and the
categorical entropy model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from train_helpers import TOL, _nchw, jax_params

from dc_vic_tpu.codec.categorical import VqCategoricalEntropyModel as JaxCategorical
from dc_vic_tpu.codec.ops import lower_bound as jax_lower_bound
from dc_vic_tpu.codec.ops import ste_round as jax_ste_round
from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu.ops.attention import flash_attention as jax_flash_attention
from dc_vic_tpu_torch.codec.categorical import VqCategoricalEntropyModel
from dc_vic_tpu_torch.codec.ops import Noise, lower_bound, ste_round
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.ops import attention, conv3x3, gn

F64 = torch.float64


def test_lower_bound_gradient_matches_jax_vjp():
    """Values below, at and above the bound, gradients of both signs: the
    gradient passes where x >= bound or where it is negative."""
    x = np.array([-2.0, 0.05, 0.11, 0.2, 3.0, -0.5, 0.1, 0.11, 5.0, 0.0], np.float32)
    g = np.array([1.0, 2.0, -1.0, 0.5, -3.0, -1.5, -0.25, 4.0, 1.0, 0.7], np.float32)
    want_y, vjp = jax.vjp(lambda v: jax_lower_bound(v, 0.11), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    y = lower_bound(xt, 0.11)
    y.backward(torch.tensor(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert (xt.grad.numpy() == 0).sum() == 3     # below the bound with a positive gradient


def test_ste_round_matches_jax():
    x = np.random.default_rng(0).normal(0, 3, 64).astype(np.float32)
    want_y, vjp = jax.vjp(jax_ste_round, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = ste_round(xt)
    y.backward(torch.full_like(xt, 2.0))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.full(64, 2.0))[0]))


def test_flash_attention_backward_matches_jax_vjp():
    """K2's Function (the plain forward on the CPU, the hand-written
    backward) against jax.vjp of the JAX package's flash_attention (its
    custom VJP, XLA on the CPU)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(0, s, (2, 96, 128)).astype(np.float32) for s in (0.1, 1.0, 1.0))
    g = rng.normal(0, 1, (2, 96, 128)).astype(np.float32)
    want, vjp = jax.vjp(jax_flash_attention, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = attention.flash_attention(*leaves)
    assert out.grad_fn is not None
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for t, w in zip(leaves, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def _leaves(gen, *shapes):
    return [torch.randn(s, generator=gen, dtype=F64, requires_grad=True) for s in shapes]


@pytest.mark.parametrize("kernel", ["flash_attention", "gn_channel_sums", "gn_apply",
                                    "gn_apply_swish", "conv3x3_same", "conv3x3_gn_swish",
                                    "conv3x3_gn_swish_res"])
def test_kernel_functions_gradcheck(kernel):
    """Each kernel's Function in float64 on the CPU: the backward formula
    against finite differences."""
    gen = torch.Generator().manual_seed(2)
    cases = {
        "flash_attention": (attention.flash_attention, (2, 7, 5), (2, 7, 5), (2, 7, 5)),
        "gn_channel_sums": (gn.channel_sums, (2, 4, 3, 5)),
        "gn_apply": (lambda x, s, b: gn.apply_affine(x, s, b), (2, 4, 3, 5), (2, 4), (2, 4)),
        "gn_apply_swish": (lambda x, s, b: gn.apply_affine(x, s, b, "swish"), (2, 4, 3, 5),
                           (2, 4), (2, 4)),
        "conv3x3_same": (conv3x3.conv3x3_same, (2, 4, 5, 6), (3, 4, 3, 3)),
        "conv3x3_gn_swish": (lambda x, w, s, b, cb: conv3x3.conv3x3_gn_swish(x, w, s, b, cb),
                             (2, 4, 5, 6), (3, 4, 3, 3), (2, 4), (2, 4), (3,)),
        "conv3x3_gn_swish_res": (conv3x3.conv3x3_gn_swish, (2, 4, 5, 6), (3, 4, 3, 3), (2, 4),
                                 (2, 4), (3,), (2, 3, 5, 6)),
    }
    fn, *shapes = cases[kernel]
    inputs = _leaves(gen, *shapes)
    assert fn(*inputs).grad_fn is not None
    assert torch.autograd.gradcheck(fn, inputs)


def test_kernel_outputs_carry_a_gradient_from_the_modules():
    """The modules that route to K3/K4 (GroupNorm), K5 (Conv2d) and K6
    (VQResnetBlock) on the card give outputs with a grad_fn here too, and
    their Functions' gradients equal autograd of the modules' ordinary code
    (f32; the fused block's two-pass variance differs from GroupNorm's fast
    one by rounding)."""
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import GroupNorm, conv
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 6, 6, generator=gen)
    for make in (lambda: GroupNorm(4, 8, act="swish"), lambda: conv(8, 8, 3),
                 lambda: VQResnetBlock(8, 8)):
        ref, routed = make(), make()
        with torch.no_grad():
            for a, b in zip(ref.parameters(), routed.parameters()):
                a.copy_(torch.randn(a.shape, generator=gen) * 0.3)
                b.copy_(a)
        routed.recon_kernel = routed.fused = True
        routed.takes_kernel = lambda shape: True
        routed.takes_fused = lambda shape: True
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        outs = [ref(xs[0]), routed(xs[1])]
        assert outs[1].grad_fn is not None
        for o in outs:
            o.square().sum().backward()
        np.testing.assert_allclose(outs[1].detach().numpy(), outs[0].detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(xs[1].grad.numpy(), xs[0].grad.numpy(), rtol=1e-4,
                                   atol=1e-4)
        for a, b in zip(ref.parameters(), routed.parameters()):
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-4, atol=1e-4)


def test_categorical_model_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (2, 4, 5, 16)).astype(np.float32)
    idx = rng.integers(0, 16, (2, 4, 5)).astype(np.int32)
    _, want = JaxCategorical()(jnp.asarray(idx), jnp.asarray(logits))
    _, got = VqCategoricalEntropyModel()(torch.tensor(idx), _nchw(logits))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-6)


@pytest.fixture(scope="module")
def eval_models():
    cfg = tiny_config()
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    port = build_comp_model(cfg, device="cpu").module.eval()
    load_reference_state_dict(port, export_state_dict(params))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return m, params, port, x


def test_eval_forward_and_extract_y_hat_match_jax(eval_models):
    """is_train=False: hard rounds, no noise drawn, eval likelihoods."""
    m, params, port, x = eval_models
    b1, b2 = np.array([1.5, 0.4], np.float32), np.array([0.2, 3.1], np.float32)
    want = jax.jit(lambda p, x: m.apply(p, x, b1, b2, is_train=False))(params, x)
    with torch.no_grad():
        got = port(_nchw(x), torch.tensor(b1), torch.tensor(b2), is_train=False)
        y_hat = port.extract_y_hat(_nchw(x), torch.tensor(b1), torch.tensor(b2))
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(nhwc(got["fake_images"]), np.asarray(want["fake_images"]), **TOL)
    for key in ("bpp", "qbpp", "bpp_per_sample"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    for k in ("y", "z"):
        np.testing.assert_allclose(nhwc(got["likelihoods"][k]),
                                   np.asarray(want["likelihoods"][k]), **TOL)
    np.testing.assert_allclose(nhwc(y_hat), np.asarray(want["quantized_code"]["y"]), **TOL)
    np.testing.assert_array_equal(y_hat.numpy(), got["quantized_code"]["y"].numpy())
    with pytest.raises(ValueError, match="noise"):
        port(_nchw(x), torch.tensor(b1), torch.tensor(b2), is_train=True)
    with pytest.raises(ValueError, match="more draws"):
        port(_nchw(x), torch.tensor(b1), torch.tensor(b2), is_train=True, noise=Noise(draws=[]))


def test_encode_deterministic_matches_jax(eval_models):
    """Symbols, CDF indexes and the packed plane exact; bits within 1e-3."""
    m, params, port, x = eval_models
    img = ((x + 1) * 127.5).astype(np.uint8)
    b = np.array([2.29], np.float32), np.array([3.0], np.float32)
    want = jax.jit(lambda p, x: m.apply(p, x, *b, include_latents=True,
                                        method=m.encode_deterministic))(params, img)
    got = port.encode_deterministic(_nchw(img), *(torch.tensor(v) for v in b),
                                    include_latents=True)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(nhwc(got["y_symbols"]), np.asarray(want["y_symbols"]))
    np.testing.assert_array_equal(nhwc(got["z_symbols"]), np.asarray(want["z_symbols"]))
    np.testing.assert_array_equal(nhwc(got["y_indexes"]), np.asarray(want["y_indexes"]))
    np.testing.assert_array_equal(nhwc(got["y_packed"]).view(np.uint16),
                                  np.asarray(want["y_packed"]))
    for key in ("y_bits", "z_bits", "max_abs_y", "max_abs_sym"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    np.testing.assert_allclose(nhwc(got["y_hat"]), np.asarray(want["y_hat"]), **TOL)


def test_codec_leaves_the_backend_flags_as_it_found_them(eval_models):
    """A Codec runs its calls with TF32 off and deterministic cuDNN
    algorithms, and puts the caller's settings back: constructing one
    changes nothing, a compress sees the codec's flags inside and leaves the
    caller's (here the opposite ones) behind, also after an error."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import CompModelSpec
    _, _, port, x = eval_models
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = lambda: (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
                     cudnn.benchmark)
    before, theirs = flags(), (True, True, False, True)
    seen = []
    hook = port.hyperencoder.register_forward_pre_hook(lambda m, a: seen.append(flags()))
    try:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = theirs
        codec = Codec(CompModelSpec(port, [2.29], [3.0]))
        assert flags() == theirs
        img = ((x[:1] + 1) * 127.5).astype(np.uint8)
        res = codec.compress(img, 0, debug=True)
        assert flags() == theirs and seen and all(f == (False, False, True, False)
                                                  for f in seen)
        with pytest.raises(ValueError):       # a batch-1 stream decoded as batch 2
            codec.decompress([res[0]["string_list"]] * 2)
        assert flags() == theirs
        assert codec.verify_roundtrip(res, [r["string_list"] for r in res], img.shape[1:3])
    finally:
        hook.remove()
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = before

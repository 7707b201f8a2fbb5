"""The port's tiny DC-VIC model against the JAX model on the same weights:
encode_front, hyper_decode, the ChARM slice chain and decode_from_y_hat.

Weights: seeded torch init plus noise, carried into flax with the JAX
package's convert_state_dict, then back into a fresh torch model through
export_state_dict -> load_reference_state_dict (the path under test).
Floats agree within atol = rtol = 1e-3 (XLA:CPU vs oneDNN summation order,
compounded through the stacks). Integers must be equal, except elements
whose pre-round value lies within 1e-4 of a rounding boundary (or a CDF
index whose scale lies within 1e-4 relative of a table entry, or a VQ index
whose top-two distances are within 1e-5): those are counted and must stay
under 0.1%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from train_helpers import flax_template

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
from dc_vic_tpu.models.dc_vic import to_model_range as jax_range
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.models.dc_vic import to_model_range

TOL = dict(atol=1e-3, rtol=1e-3)
BETAS = (2.29, 3.0)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _near_boundary_ok(got, want, pre_round, label):
    """Integers equal except where the pre-round value is within 1e-4 of a
    .5 boundary; the exceptions stay under 0.1%."""
    bad = got != want
    frac = np.abs(np.abs(pre_round - np.floor(pre_round)) - 0.5)
    assert np.all(frac[bad] < 1e-4), f"{label}: mismatch away from a boundary"
    assert bad.sum() <= 1e-3 * bad.size, f"{label}: {bad.sum()} near-boundary mismatches"


@pytest.fixture(scope="module")
def models():
    spec = jax_build(tiny_config())
    m = spec.module
    template = flax_template(m, tiny_config())
    seed_model = build_comp_model(tiny_config(), device="cpu").module
    init_weights(seed_model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sd = {k: v.numpy() + rng.normal(0, 0.02, v.shape).astype(np.float32)
          for k, v in seed_model.state_dict().items()}
    params, _ = convert_state_dict(sd, template, strict=True)
    port = build_comp_model(tiny_config(), device="cpu").module
    load_reference_state_dict(port, export_state_dict(params))
    return m, params, port.eval()


@pytest.fixture(scope="module")
def jax_run(models):
    """The JAX model's codec stages on a seeded batch (eager: no compile)."""
    m, params, _ = models
    img = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    b1, b2 = jnp.array([BETAS[0]]), jnp.array([BETAS[1]])
    out = {"img": img}
    out["vq"] = m.apply(params, jax_range(jnp.asarray(img)), method=m.vq_encode)
    y, z_sym = m.apply(params, jnp.asarray(img), b1, b2, method=m.encode_front)
    out["y"], out["z_sym"] = y, z_sym
    out["hyper_out"], out["z_hat"] = m.apply(params, z_sym, method=m.hyper_decode)
    prev = jnp.zeros(y.shape[:3] + (0,), jnp.float32)
    mu, idx = m.apply(params, 0, out["hyper_out"], prev, method=m.charm_slice_params)
    steps = []
    for i in range(6):
        sym = m.apply(params, i, y, mu, method=m.charm_symbolize)
        steps.append((mu, idx, sym, prev))
        prev, mu, idx = m.apply(params, i, out["hyper_out"], prev, sym, mu,
                                method=m.charm_decode_step)
    out["steps"], out["y_hat"] = steps, prev
    out["decode"] = m.apply(params, prev, b1, b2, method=m.decode_from_y_hat)
    out["recon"] = m.apply(params, prev, b1, b2, method=m.reconstruct_uint8)
    return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def test_reference_state_dict_loads_strictly(models):
    """export_state_dict output loads with strict=True; a missing key, an
    extra key or a wrong shape raises."""
    _, params, port = models
    sd = export_state_dict(params)
    assert set(sd) == set(port.state_dict())
    fresh = build_comp_model(tiny_config(), device="cpu").module
    load_reference_state_dict(fresh, sd)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.ascontiguousarray(sd[k]), err_msg=k)
    key = "vq_model.decoder.mid.attn_1.q.weight"
    with pytest.raises(KeyError):
        load_reference_state_dict(fresh, {k: v for k, v in sd.items() if k != key})
    with pytest.raises(KeyError):
        load_reference_state_dict(fresh, dict(sd, extra=np.zeros(1, np.float32)))
    with pytest.raises(ValueError):
        load_reference_state_dict(fresh, dict(sd, **{key: sd[key][:1]}))


def test_vq_encode_matches_jax(models, jax_run):
    """VQ indices from the K1 call site (plain version on the CPU)."""
    _, _, port = models
    x = to_model_range(_nchw(jax_run["img"]))
    with torch.no_grad():
        h = port.vq_model.encode(x)
        lat, idx = port.vq_encode(x)
    lat_j, idx_j = jax_run["vq"]
    cb = port.vq_model.quantize.embedding.weight.detach()
    d = ((cb * cb).sum(-1)[None] - 2 * h.permute(0, 2, 3, 1).reshape(-1, 4) @ cb.t()).numpy()
    top2 = np.sort(d, axis=1)[:, :2]
    bad = (idx.numpy() != idx_j).reshape(-1)
    assert np.all(top2[bad, 1] - top2[bad, 0] < 1e-5)
    assert bad.sum() <= 1e-3 * bad.size
    np.testing.assert_allclose(_nhwc(lat), lat_j, **TOL)


def test_encode_front_matches_jax(models, jax_run):
    _, _, port = models
    with torch.no_grad():
        y, z_sym = port.encode_front(_nchw(jax_run["img"]), torch.tensor([BETAS[0]]),
                                     torch.tensor([BETAS[1]]))
        z_pre = port.hyperencoder(y) - port.entropy_model_z.medians()[None, :, None, None]
    assert y.dtype == torch.float32 and z_sym.dtype == torch.int16
    np.testing.assert_allclose(_nhwc(y), jax_run["y"], **TOL)
    _near_boundary_ok(_nhwc(z_sym), jax_run["z_sym"], _nhwc(z_pre), "z symbols")


def test_entropy_chain_matches_jax(models, jax_run):
    """hyper_decode and the ChARM chain, driven in lockstep with the JAX
    chain's symbols: mu, CDF indexes, symbols and y_hat per slice."""
    from dc_vic_tpu_torch.codec.gaussian import get_scale_table
    _, _, port = models
    table = get_scale_table()[:-1].astype(np.float32)
    with torch.no_grad():
        ho, z_hat = port.hyper_decode(_nchw(jax_run["z_sym"]))
        np.testing.assert_allclose(_nhwc(ho), jax_run["hyper_out"], **TOL)
        np.testing.assert_array_equal(_nhwc(z_hat), jax_run["z_hat"])
        y = _nchw(jax_run["y"])
        for i, (mu_j, idx_j, sym_j, prev_j) in enumerate(jax_run["steps"]):
            prev = _nchw(prev_j)
            mu, idx = port.charm_slice_params(i, ho, prev)
            _, sigma = port.context_model.slice_params(i, ho, prev)
            np.testing.assert_allclose(_nhwc(mu), mu_j, **TOL)
            bad = _nhwc(idx) != idx_j
            s = np.maximum(_nhwc(sigma), 0.11)
            near = np.min(np.abs(s[..., None] / table - 1), axis=-1) < 1e-4
            assert np.all(near[bad]) and bad.sum() <= 1e-3 * bad.size
            sym = port.charm_symbolize(i, y, mu)
            sc = y.shape[1] // 6
            _near_boundary_ok(_nhwc(sym), sym_j,
                              _nhwc(y[:, i * sc:(i + 1) * sc] - mu), f"slice {i}")
            nxt, _, _ = port.charm_decode_step(i, ho, prev, _nchw(sym_j), _nchw(mu_j))
            np.testing.assert_allclose(
                _nhwc(nxt), jax_run["steps"][i + 1][3] if i < 5 else jax_run["y_hat"],
                **TOL)


def test_pad_and_crop_match_jax():
    """Reflect padding to the 64-pixel stride, and the crop back."""
    from dc_vic_tpu.models.dc_vic import crop_image as jax_crop
    from dc_vic_tpu.models.dc_vic import pad_image as jax_pad
    from dc_vic_tpu_torch.models.dc_vic import crop_image, pad_image
    x = np.random.default_rng(3).standard_normal((2, 70, 100, 3)).astype(np.float32)
    got = pad_image(_nchw(x))
    want = np.asarray(jax_pad(jnp.asarray(x)))
    assert want.shape == (2, 128, 128, 3)
    np.testing.assert_array_equal(_nhwc(got), want)
    np.testing.assert_array_equal(_nhwc(crop_image(got, 70, 100)),
                                  np.asarray(jax_crop(jnp.asarray(want), 70, 100)))


def test_decode_from_y_hat_matches_jax(models, jax_run):
    """ELIC get_feats -> Swin VQ estimator -> fused VQGAN decoder (the K2
    call sites), and the uint8 reconstruction."""
    _, _, port = models
    b1, b2 = torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]])
    y_hat = _nchw(jax_run["y_hat"])
    with torch.no_grad():
        fake, pred, logits, indices = port.decode_from_y_hat(y_hat, b1, b2)
        recon = port.reconstruct_uint8(y_hat, b1, b2)
    fake_j, pred_j, logits_j, indices_j = jax_run["decode"]
    np.testing.assert_allclose(_nhwc(logits), logits_j, **TOL)
    np.testing.assert_allclose(_nhwc(pred), pred_j, **TOL)
    # strict: a flipped index would change the whole decode below it
    np.testing.assert_array_equal(indices.numpy(), indices_j)
    np.testing.assert_allclose(_nhwc(fake), fake_j, **TOL)
    diff = np.abs(_nhwc(recon).astype(int) - jax_run["recon"].astype(int))
    assert recon.dtype == torch.uint8 and diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3

"""The port's initial weights (``models/__init__.py::init_weights``) against
the JAX package's seeded init (flax's ``module.init``), by distribution.

The port cannot draw the JAX init's bits, but it must draw from the same
laws. For ``tiny_config()`` and for the soak's small RD configuration
(``tests/test_torch_soak.py::_small_configs``), SEEDS seeds of both inits
(one jitted ``module.init`` on the JAX side) are grouped by the law the
port's ``init_weights`` gives each weight: lecun-normal convs, transposed
convs and dense layers by fan-in, the codebook's U(-1/n, 1/n), the index
embedding's N(0, 1), Swin's truncated N(0, 0.02) relative-position biases
and the entropy bottleneck's U(-0.5, 0.5) biases. Each group's pooled mean
and standard deviation agree between the packages within ``Z`` standard
errors of their difference, and every draw lies within the law's
truncation or support. Every other weight is a constant of the init (zero
biases, unit norm scales, the bottleneck's matrices, factors and
quantiles, GDN's parameters) and equals the JAX weight exactly at every
seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_threads  # noqa: F401
from helpers import tiny_config

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models.subnets import IndexEmbedding
from dc_vic_tpu_torch.nn.swin import WindowAttention

SEEDS = 8
Z = 5.0                               # standard errors a pooled statistic may differ by
TRUNC = 0.87962566103423978           # std of N(0, 1) truncated at +-2


def _laws(model: nn.Module) -> dict:
    """The random weights of ``model`` by name: the law ``init_weights``
    draws each from, as (kind, scale, bound of |value|)."""
    laws = {}
    for prefix, m in model.named_modules():
        p = f"{prefix}." if prefix else ""

        def lecun(fan_in):
            std = 1.0 / np.sqrt(fan_in) / TRUNC
            laws[p + "weight"] = ("lecun-normal", int(fan_in), 2 * std)
        if isinstance(m, nn.Conv2d):
            lecun(m.weight[0].numel())
        elif isinstance(m, nn.ConvTranspose2d):
            lecun(m.weight.shape[0] * m.weight[0, 0].numel())
        elif isinstance(m, nn.Linear):
            lecun(m.in_features)
        elif isinstance(m, IndexEmbedding):
            laws[p + "weight"] = ("normal", 1.0, np.inf)
        elif isinstance(m, nn.Embedding):
            n = m.num_embeddings
            laws[p + "weight"] = ("uniform", 1.0 / n, 1.0 / n)
        elif isinstance(m, WindowAttention):
            laws[p + "relative_position_bias_table"] = ("truncated normal", 0.02, 0.04)
        elif isinstance(m, EntropyBottleneck):
            for i in range(m.num_layers):
                laws[f"{p}_bias{i}"] = ("uniform", 0.5, 0.5)
    return laws


def _soak_rd(tmp):
    from dc_vic_tpu_torch.utils.config import load_config
    from test_torch_soak import _small_configs
    return load_config(_small_configs(str(tmp))["rd"], is_train=True)


CONFIGS = {"tiny": lambda tmp: tiny_config(), "soak_rd": _soak_rd}


def _inits(cfg):
    """SEEDS draws of each package's init: lists of {name: array}."""
    m = jax_build(cfg).module
    b = (jnp.array([0.0]),) * 2 if m.use_beta else ()
    init = jax.jit(lambda r: m.init({"params": r}, jnp.zeros((1, 64, 64, 3)), *b,
                                    is_train=False))
    want = [export_state_dict(jax.device_get(init(jax.random.PRNGKey(s))))
            for s in range(SEEDS)]
    port = build_comp_model(cfg, device="cpu").module
    got = []
    for s in range(SEEDS):
        init_weights(port, torch.Generator().manual_seed(s))
        got.append({k: v.detach().numpy().copy() for k, v in port.named_parameters()})
    return port, want, got


def _moments(arrays):
    """n, mean, variance and fourth central moment of the values of
    ``arrays`` pooled, from float64 power sums taken tensor by tensor."""
    n, sums = 0, np.zeros(4)
    for a in arrays:
        x = np.asarray(a, np.float64).ravel()
        x2 = x * x
        n += x.size
        sums += (x.sum(), x2.sum(), (x2 * x).sum(), (x2 * x2).sum())
    m1, m2, m3, m4 = sums / n
    var = m2 - m1 * m1
    return n, m1, var, m4 - 4 * m1 * m3 + 6 * m1 * m1 * m2 - 3 * m1 ** 4


def _z(a, b):
    """The differences of the means and of the standard deviations of two
    pooled samples, in standard errors of the difference; both standard
    deviations."""
    def errors(arrays):
        n, mean, var, m4 = _moments(arrays)
        # the standard error of the standard deviation (delta method)
        return mean, var / n, np.sqrt(var), (m4 - var ** 2) / (4 * n * var)
    ma, va, sa, vsa = errors(a)
    mb, vb, sb, vsb = errors(b)
    return (ma - mb) / np.sqrt(va + vb), (sa - sb) / np.sqrt(vsa + vsb), sa, sb


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def inits(request, tmp_path_factory):
    return (request.param,) + _inits(CONFIGS[request.param](tmp_path_factory.mktemp("init")))


def test_random_weights_follow_the_jax_laws(inits):
    """Each law's pooled draws: mean and standard deviation within Z
    standard errors of the JAX package's, every value within the law's
    bound, in both packages."""
    name, port, want, got = inits
    laws = _laws(port)
    groups = {}
    for k, law in laws.items():
        groups.setdefault(law, []).append(k)
    assert groups
    report, bad = [], []
    for law, keys in sorted(groups.items()):
        a = [d[k] for d in got for k in keys]
        b = [np.asarray(d[k]) for d in want for k in keys]
        z_mean, z_std, sa, sb = _z(a, b)
        report.append(f"{law[0]} {law[1]:g}: {len(keys)} tensors, "
                      f"{sum(x.size for x in a)} values, std {sa:.5g} against {sb:.5g}, "
                      f"z(mean) {z_mean:+.2f}, z(std) {z_std:+.2f}")
        if max(abs(z_mean), abs(z_std)) > Z:
            bad.append(f"{report[-1]} ({', '.join(keys[:3])}...)")
        for pkg, xs in (("port", a), ("jax", b)):
            assert max(np.abs(x).max() for x in xs) <= law[2] * (1 + 1e-6), \
                f"{pkg} {law} {keys[:3]}"
    print(f"\n{name}:\n  " + "\n  ".join(report))
    assert not bad, "\n".join(bad)


def test_every_other_weight_is_the_jax_constant(inits):
    """The weights that no law covers are constants of the init, equal to
    the JAX weights bit for bit at every seed; the two inits cover the
    same weights."""
    name, port, want, got = inits
    laws = _laws(port)
    assert set(got[0]) == set(want[0])
    constants = sorted(set(got[0]) - set(laws))
    assert constants
    for s in range(SEEDS):
        for k in constants:
            np.testing.assert_array_equal(got[s][k], np.asarray(want[s][k]).reshape(got[s][k].shape),
                                          err_msg=f"{name} seed {s}: {k}")

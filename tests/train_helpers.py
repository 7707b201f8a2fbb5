"""Shared pieces of the training parity tests (tests/test_torch_train_*.py):
weights carried from the port into flax, layouts, and the recorder of the
JAX forward's noise draws."""
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dc_vic_tpu.models.convert import convert_state_dict
from dc_vic_tpu_torch.models import build_comp_model, init_weights

TOL = dict(atol=1e-3, rtol=1e-3)     # the model tests' tolerance
GRAD_TOL = 1e-3                      # relative L2 per parameter tensor (+1e-7 absolute)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _port_layout(a):
    """A JAX draw in the port's layout: NHWC maps to NCHW; the bottleneck's
    [C, 1, N] draw is the same in both."""
    a = np.array(a)
    return _nchw(a) if a.ndim == 4 else torch.from_numpy(a)


_TEMPLATES = {}


def _frozen(cfg):
    if isinstance(cfg, Mapping):
        return tuple(sorted((k, _frozen(v)) for k, v in cfg.items()))
    if isinstance(cfg, (list, tuple)):
        return tuple(_frozen(v) for v in cfg)
    return cfg


def flax_template(m, cfg):
    """The shapes of the flax parameters of ``m``, the JAX model built from
    ``cfg`` (``jax.eval_shape`` of its init: seconds of tracing), traced
    once per configuration in a process and shared by the port's test
    files."""
    key = _frozen(cfg)
    if key not in _TEMPLATES:
        x0, b = jnp.zeros((1, 64, 64, 3)), jnp.array([1.0])
        _TEMPLATES[key] = jax.eval_shape(
            lambda r: m.init({"params": r}, x0, b, b, is_train=False), jax.random.PRNGKey(0))
    return _TEMPLATES[key]


def jax_params(m, cfg):
    """Seeded port weights plus noise, carried into flax."""
    template = flax_template(m, cfg)
    seed = build_comp_model(cfg, device="cpu").module
    init_weights(seed, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sd = {k: v.numpy() + rng.normal(0, 0.02, v.shape).astype(np.float32)
          for k, v in seed.state_dict().items()}
    return convert_state_dict(sd, template, strict=True)[0]


# the functions whose draws are the forward's noise (parameter initialisers,
# which flax traces lazily, draw too, and are left out)
_NOISE_SITES = {("codec/bottleneck.py", "__call__"), ("codec/gaussian.py", "__call__"),
                ("models/dc_vic.py", "decode_from_y_hat")}


def recording(monkeypatch, draws):
    """Wrap jax.random.uniform and jax.random.gumbel to append each noise
    draw of the forward."""
    for name in ("uniform", "gumbel"):
        orig = getattr(jax.random, name)

        def wrapped(*a, _orig=orig, **k):
            v = _orig(*a, **k)
            code = sys._getframe(1).f_code
            if any(code.co_filename.endswith(f) and code.co_name == fn
                   for f, fn in _NOISE_SITES):
                draws.append(v)
            return v
        monkeypatch.setattr(jax.random, name, wrapped)


def zero_by_construction(module) -> set:
    """Names of the conv biases whose gradient is zero in exact arithmetic:
    the bias of a conv whose output goes straight into a GroupNorm of one
    channel per group (the tiny config's 8- and 16-channel blocks), which
    subtracts it again. Both packages give them rounding noise only."""
    from dc_vic_tpu_torch.nn.layers import FemasrResBlock, GNResBlock
    names = set()
    for prefix, m in module.named_modules():
        if isinstance(m, GNResBlock) and m.norm2.num_groups == m.norm2.weight.numel():
            names.add(f"{prefix}.conv1.bias")
        elif isinstance(m, FemasrResBlock):
            norm = m.conv[3].norm
            if norm.num_groups == norm.weight.numel():
                names.add(f"{prefix}.conv.2.bias")
    return names


def check_gradients(module, want, trained, zero=()):
    """Each trained parameter's .grad against ``want`` (numpy by name):
    relative L2 error within GRAD_TOL (+1e-7 absolute). A bias in ``zero``
    must instead be below GRAD_TOL times its conv weight's gradient in both
    packages (rounding noise). Untrained parameters have no gradient.
    Returns the number of tensors checked."""
    grads = dict(module.named_parameters())
    checked = 0
    for n, p in grads.items():
        if not trained.get(n, True):
            assert p.grad is None, n
            continue
        got = p.grad.numpy()
        w = np.asarray(want[n]).reshape(got.shape)
        if n in zero:
            scale = np.linalg.norm(grads[n[:-len("bias")] + "weight"].grad.numpy().ravel())
            assert max(np.linalg.norm(got), np.linalg.norm(w)) <= GRAD_TOL * scale, n
        else:
            err, ref = np.linalg.norm((got - w).ravel()), np.linalg.norm(w.ravel())
            assert err <= GRAD_TOL * ref + 1e-7, f"{n}: relative L2 error {err / ref:.3e}"
        checked += 1
    return checked

"""The port's multi-device codec against the JAX package's on the CPU: the
tiny model with the same weights, six images on a mesh of four in both
packages (``Codec(spec, mesh=["cpu"] * 4)`` and the JAX ``Codec(spec,
params, mesh=make_mesh(4))``), so both pad the batch to eight.

Held: the streams' bytes equal in both formats, the tpu format's headers
field by field (``encode_batch`` the padded batch); each package decodes
the other's streams to its own encoder's latents; and a non-portable tpu
stream of the mesh is refused by the other package's single-device codec,
which runs batch six."""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import flax_template

from dc_vic_tpu.codec.container import HeaderHandler as JaxHeader
from dc_vic_tpu.codec.driver import Codec as JaxCodec
from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
from dc_vic_tpu.parallel import make_mesh as jax_mesh
from dc_vic_tpu_torch.codec.container import HeaderHandler
from dc_vic_tpu_torch.codec.driver import Codec
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models.convert import load_reference_state_dict

MESH = 4
BATCH = 6                 # padded to 8 on a mesh of four
H, W = 64, 64
FORMATS = ("compressai", "tpu")


def _images():
    """tests/test_codec_mesh.py's images: a ramp plus noise."""
    rng = np.random.default_rng(3)
    base = np.linspace(0, 255, W, dtype=np.float32)[None, None, :, None]
    return np.clip(base + rng.normal(0, 25, (BATCH, H, W, 3)), 0, 255).astype(np.uint8)


def _strings(res):
    return [r["string_list"] for r in res]


@pytest.fixture(scope="module")
def models():
    """(port spec, JAX spec, JAX params) with the same weights: the port's
    seeded init carried into flax and back (strict)."""
    cfg = tiny_config()
    jspec = jax_build(cfg)
    seed = build_comp_model(cfg, device="cpu").module
    init_weights(seed, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict({k: v.numpy() for k, v in seed.state_dict().items()},
                                   flax_template(jspec.module, cfg), strict=True)
    spec = build_comp_model(cfg, device="cpu")
    load_reference_state_dict(spec.module, export_state_dict(params))
    return spec, jspec, params


@pytest.fixture(scope="module")
def runs(models):
    """Per format, both packages' mesh codecs and their round trips of the
    same six images."""
    spec, jspec, params = models
    imgs = _images()
    out = {}
    for fmt in FORMATS:
        codec = Codec(spec, stream_format=fmt, mesh=["cpu"] * MESH)
        jcodec = JaxCodec(jspec, params, stream_format=fmt, mesh=jax_mesh(MESH))
        out[fmt] = dict(codec=codec, jcodec=jcodec,
                        res=codec.compress(imgs, 1, debug=True),
                        jres=jcodec.compress(imgs, quality_ind=1, debug=True))
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_mesh_streams_equal_the_jax_mesh_codec_s(runs, fmt):
    """The same bytes; the tpu format's headers record the padded batch."""
    res, jres = runs[fmt]["res"], runs[fmt]["jres"]
    assert len(res) == len(jres) == BATCH
    assert _strings(res) == _strings(jres)
    if fmt == "tpu":
        for got, want in zip(_strings(res), _strings(jres)):
            header = HeaderHandler.decode(got[0])
            assert header == JaxHeader.decode(want[0])
            assert header["encode_batch"] == 8


@pytest.mark.parametrize("fmt", FORMATS)
def test_mesh_codecs_decode_each_other_s_streams(runs, fmt):
    """Each package's mesh codec decodes the other's streams to its own
    encoder's latents."""
    run = runs[fmt]
    assert run["codec"].verify_roundtrip(run["res"], _strings(run["jres"]), (H, W))
    assert run["jcodec"].verify_roundtrip(run["jres"], _strings(run["res"]), (H, W))


def test_non_portable_mesh_stream_refused_across_packages(runs, models):
    """A tpu stream recorded at the padded batch eight: the other package's
    single-device codec, at batch six, refuses it."""
    spec, jspec, params = models
    with pytest.raises(ValueError, match="encoded at batch 8"):
        JaxCodec(jspec, params).decompress(_strings(runs["tpu"]["res"]))
    with pytest.raises(ValueError, match="encoded at batch 8"):
        Codec(spec).decompress(_strings(runs["tpu"]["jres"]))

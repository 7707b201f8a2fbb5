"""The port's own Codec on the tiny config on the CPU: compress -> bitstream
-> decompress, bit-exact y_hat, and the port's import boundary."""
import ast
import os

import numpy as np
import pytest
import torch

from helpers import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    spec = build_comp_model(tiny_config(), device="cpu")
    init_weights(spec.module, torch.Generator().manual_seed(0))
    return Codec(spec)


@pytest.mark.parametrize("batch,H,W", [(2, 96, 80), (1, 96, 80), (1, 64, 64)])
def test_roundtrip_bit_exact(codec, batch, H, W):
    """96x80 is reflect-padded to 128x128; at 64x64 z is 1x1, whose tensors
    read as channels-last once permuted (the layout trap the entropy chain
    guards against). The decoder's y_hat and z_hat equal the encoder's
    bitwise, and the decoded images are reconstruct_uint8 of the encoder's
    y_hat."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    img = np.random.default_rng(batch + H).integers(0, 256, (batch, H, W, 3),
                                                     dtype=np.uint8)
    res = codec.compress(img, 1, debug=True)
    strings = [r["string_list"] for r in res]
    assert len(res) == batch
    for r in res:
        header = HeaderHandler.decode(r["string_list"][0])
        assert len(r["string_list"][0]) == 6
        assert header["img_size"] == (H, W) and header["quality_ind"] == 1
        assert header["stream_format"] == "compressai"
        assert header["max_sample"] == min(255, int(np.abs(
            np.stack([q["y_hat"] for q in res])).max()))
        assert r["bpp"] == 8 * sum(4 + len(s) for s in r["string_list"]) / (H * W)
    assert codec.verify_roundtrip(res, strings, (H, W))
    out = codec.decompress(strings)
    assert out.shape == (batch, H, W, 3) and out.dtype == np.uint8

    b1, b2 = codec._betas(1)
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2)))
    with torch.no_grad():
        recon = codec.module.reconstruct_uint8(y_hat, b1, b2)
    np.testing.assert_array_equal(out, recon.permute(0, 2, 3, 1).numpy()[:, :H, :W])


def test_corrupt_roundtrip_is_detected(codec):
    """verify_roundtrip compares real latents: a y stream from another image
    fails it."""
    rng = np.random.default_rng(7)
    a = codec.compress(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8), 0, debug=True)
    b = codec.compress(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8), 0, debug=True)
    swapped = [[a[0]["string_list"][0], a[0]["string_list"][1], b[0]["string_list"][2]]]
    assert codec.verify_roundtrip(a, [a[0]["string_list"]], (64, 64))
    assert not codec.verify_roundtrip(a, swapped, (64, 64))


def test_decompress_rejects_tpu_format(codec):
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    header = HeaderHandler.encode((64, 64), 0, 0, tpu_format=True, encode_batch=1)
    with pytest.raises(ValueError):
        codec.decompress([[header, b"", b""]])


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax or
    the JAX package: the machine with the card has none of them."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dc_vic_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "dc_vic_tpu"), (path, mod)

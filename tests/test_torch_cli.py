"""The port's compress CLI (``dc_vic_tpu_torch/tools/compress.py``) on the
tiny config on the CPU: one run as a subprocess with the files and CSV
columns that ``scripts/compress.py`` writes, its bucket planning against
that script's, and checkpoint loading from a ``.pth.tar``."""
import csv
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = ["img_name", "header_bit", "z_bit", "y_bit", "real_bit", "real_bpp", "pred_bpp",
          "num_pixel"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    """The tiny model with seeded weights that went through the JAX
    package's parameter tree and back (export_state_dict ->
    load_reference_state_dict)."""
    import jax
    import jax.numpy as jnp
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    m = jax_build(tiny_config()).module
    x0, b = jnp.zeros((1, 64, 64, 3)), jnp.array([1.0])
    template = jax.eval_shape(
        lambda r: m.init({"params": r}, x0, b, b, is_train=False), jax.random.PRNGKey(0))
    seed_model = build_comp_model(tiny_config(), device="cpu").module
    init_weights(seed_model, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, template, strict=True)
    out = build_comp_model(tiny_config(), device="cpu")
    load_reference_state_dict(out.module, export_state_dict(params))
    return out


def _write_yaml(path):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(tiny_config())), f)


def _image(rng, h, w):
    yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 3, w), indexing="ij")
    base = (np.stack([np.sin(yy + p) * np.cos(xx + p) for p in (0.0, 1.1, 2.2)], -1) + 1) * 100
    return np.clip(base + rng.normal(0, 10, (h, w, 3)), 0, 255).astype(np.uint8)


def test_compress_cli_writes_the_reference_outputs(tmp_path):
    """Three PNGs of two sizes at batch 2 with --selfcheck --decompress on
    the CPU: a .bin and a decoded .png per image, _bitrates.csv with
    scripts/compress.py's columns, _avg_bitrate.json with their mean."""
    from PIL import Image
    cfg = tmp_path / "tiny.yaml"
    _write_yaml(cfg)
    img_dir, save_dir = tmp_path / "imgs", tmp_path / "out"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    sizes = {"a0.png": (64, 80), "a1.png": (64, 80), "b0.png": (64, 64)}
    for name, (h, w) in sizes.items():
        Image.fromarray(_image(rng, h, w)).save(img_dir / name)
    # two threads, as the tests in this process take: the suite runs in parallel workers
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "dc_vic_tpu_torch.tools.compress", "--config_path", str(cfg),
         "--img_dir", str(img_dir), "--save_dir", str(save_dir), "-q", "1", "--decompress",
         "--selfcheck", "--batch_size", "2", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "selfcheck ok (2 images)" in proc.stdout and "2 padded-shape buckets" in proc.stdout
    with open(save_dir / "_bitrates.csv") as f:
        rows = list(csv.DictReader(f))
    assert sorted(r["img_name"] for r in rows) == sorted(sizes)
    assert list(rows[0]) == SCHEMA
    for r in rows:
        h, w = sizes[r["img_name"]]
        assert int(r["num_pixel"]) == h * w
        assert int(r["real_bit"]) == (int(r["header_bit"]) + int(r["z_bit"]) + int(r["y_bit"])
                                      + 3 * 32)
        assert float(r["real_bpp"]) == pytest.approx(int(r["real_bit"]) / (h * w))
        assert float(r["pred_bpp"]) > 0
    with open(save_dir / "_avg_bitrate.json") as f:
        assert json.load(f)["avg_bpp"] == pytest.approx(
            np.mean([float(r["real_bpp"]) for r in rows]))
    for name, (h, w) in sizes.items():
        assert (save_dir / name.replace(".png", ".bin")).exists()
        with Image.open(save_dir / name) as im:
            assert im.size == (w, h)


@pytest.fixture(scope="module")
def reference_plan_buckets():
    path = os.path.join(REPO, "scripts", "compress.py")
    mod_spec = importlib.util.spec_from_file_location("reference_compress_script", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.plan_buckets


@pytest.mark.parametrize("sizes,batch", [
    ([(500, 375), (512, 384), (500, 375), (768, 512)], 2),
    ([(64, 64)] * 5 + [(80, 96)] * 3, 2),
    ([(2048, 1365), (1365, 2048), (2048, 1365)], 1),
    ([(100, 100), (129, 64), (128, 64), (100, 100)], 0)])
def test_plan_buckets_is_the_script_s(reference_plan_buckets, sizes, batch):
    from dc_vic_tpu_torch.tools.compress import plan_buckets
    named = [(f"img{i}.png", s) for i, s in enumerate(sizes)]
    assert plan_buckets(named, batch) == reference_plan_buckets(named, batch)


def test_checkpoint_loads_and_codes_as_the_model_in_memory(spec, tmp_path):
    """A .pth.tar holding the weights under 'comp_model' with DataParallel's
    'module.' prefixes (and an entropy coder's table buffer, which the codec
    builds itself) loads strictly through build_codec and writes the strings
    of the model in memory."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.tools.compress import build_codec, load_checkpoint
    sd = {f"module.{k}": v.clone() for k, v in spec.module.state_dict().items()}
    sd["module.entropy_model_z._quantized_cdf"] = torch.zeros(16, 8, dtype=torch.int32)
    ckpt = tmp_path / "model.pth.tar"
    torch.save({"comp_model": sd, "iter": 7}, ckpt)
    cfg = tmp_path / "tiny.yaml"
    _write_yaml(cfg)
    loaded = build_codec(str(cfg), str(ckpt), device="cpu", stream_format="compressai")
    got = loaded.module.state_dict()
    for k, v in spec.module.state_dict().items():
        assert torch.equal(got[k], v), k
    img = _image(np.random.default_rng(1), 64, 64)[None]
    want = Codec(spec, stream_format="compressai", portable=True).compress(img, 2)
    assert [r["string_list"] for r in loaded.compress(img, 2)] == \
        [r["string_list"] for r in want]
    sd["module.extra.weight"] = torch.zeros(1)
    torch.save({"comp_model": sd}, ckpt)
    with pytest.raises(KeyError):
        load_checkpoint(loaded.module, str(ckpt))

"""The cells at the tiny size on the CPU: a sound run of the program comes
out correct against the plain reference, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell can
have. The harness's look for a card is skipped; everything else is the
benchmark's own run. The control (the reference a precision step below,
in the program's place) fails the tiny limits too."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, run
from portbench.tests.tiny import tiny_cell

ROUNDTRIP = "patchgan_bf16.roundtrip_768x512_b16"
DECODE = "patchgan_bf16.decode_768x512_b1"
TRAIN = "stage1_2_f32.rd_256_b6"
TRAIN_LIMITS = {"loss_gap": {"limit": 1e-4}, "grad_gap": {"limit": 1e-3},
                "update_gap": {"limit": 0.2}}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def measure(cell, hooks=None, seed=4_000_000_007, seconds=0.5):
    line, checks = run.measure(cell, seed, seconds, False, "cpu",
                               harness.SetupClock(time.time()), hooks)
    return harness.json.loads(line), {c.name: c for c in checks}


def flip_word(codec):
    """A token altered where it is produced: one word of each batch's
    first y stream."""
    finalize = codec.compress_finalize

    def broken(handle):
        res = finalize(handle)
        s = res[0]["string_list"]
        y = bytearray(s[2])
        y[len(y) // 2] ^= 0x5A
        res[0]["string_list"] = [s[0], s[1], bytes(y)]
        return res
    codec.compress_finalize = broken


def dim_pixels(codec):
    """An answer altered where it is produced: the decoded pixels."""
    decompress = codec.decompress

    def broken(strings, defer_fetch=False):
        out = decompress(strings, defer_fetch=defer_fetch)
        if not defer_fetch:
            return out // 2
        fetch = out.fetch
        out.fetch = lambda: fetch() // 2
        return out
    codec.decompress = broken


@pytest.mark.parametrize("workload", [ROUNDTRIP, DECODE])
def test_codec_sound_run_is_correct(workload):
    res, checks = measure(tiny_cell(workload))
    assert res["correct"], checks
    assert checks["stream_bad"].value == 0 and checks["token_flips"].value == 0


@pytest.mark.parametrize("workload,fault", [(ROUNDTRIP, flip_word), (ROUNDTRIP, dim_pixels),
                                            (DECODE, dim_pixels)])
def test_codec_fault_is_caught(workload, fault):
    res, checks = measure(tiny_cell(workload), hooks=fault)
    assert not res["correct"]


def frozen_state(trainer):
    """A step that returns its state unchanged."""
    for opt in (trainer.state.g_opt, trainer.state.aux_opt):
        opt.step = lambda grads=None, ok=None: None


def half_batch(trainer):
    """Half of the batch left out, the mean taken over the rest."""
    step = trainer.step
    trainer.step = lambda batch: step(batch[:batch.shape[0] // 2])


def test_training_sound_run_is_correct():
    res, checks = measure(tiny_cell(TRAIN, TRAIN_LIMITS), seconds=0.1)
    assert res["correct"], checks


@pytest.mark.parametrize("fault", [frozen_state, half_batch])
def test_training_fault_is_caught(fault):
    res, checks = measure(tiny_cell(TRAIN, TRAIN_LIMITS), hooks=fault, seconds=0.1)
    assert not res["correct"]


def test_codec_control_fails():
    from portbench import codec_cell
    from portbench.reference.codec_judge import CodecReference, judge_control
    cell = tiny_cell(ROUNDTRIP)
    w = codec_cell.make_weights(cell.config, 7, "cpu")
    imgs = np.random.default_rng(0).integers(0, 255, (2, 128, 128, 3), dtype=np.uint8)
    ref = CodecReference(cell.config["model_config"], w, "cpu")
    ctrl = CodecReference(cell.config["model_config"], w, "cpu", quant="fp8")
    nums = judge_control(ref, ctrl, imgs, 2)
    checks = [c for c in harness.checks_from(nums, cell.limits) if c.name in nums]
    assert len(checks) >= 4 and not all(c.ok for c in checks)


@pytest.mark.cuda
def test_cells_run_on_the_card():
    """Each cell briefly on the card, as the benchmark runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in (ROUNDTRIP, TRAIN, DECODE):
        res, checks = run.measure(harness.load_cell(w), 5_000_000_011, 3.0, False, "cuda",
                                  harness.SetupClock(time.time()))
        assert harness.json.loads(res)["correct"], checks

"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the environment, builds the CUDA kernels and the host rANS coder.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and times both: K1 vq_argmin, K2 flash attention, K3
   gn_channel_sums, K4 gn_apply, K5 conv3x3_same, K6 conv3x3_gn_swish. The
   conv kernels are also compared on the one-pixel border alone, and K2 to
   K6 are run twice on the same input and must give the same bits. K1 is
   held at the four latents it quantizes (training's batch 6 of 256x256,
   batch 4 of 768x512, the tiled 2048x1365 canvas, the contract's batch 16)
   through its NCHW entry and its flat entry, at codebooks of 1000 and 11,622
   entries, on exact ties in other lanes' slices and at ragged shapes, and
   timed at each of those latents by device time (graph replay of 100 calls,
   and the kernel's own duration under torch.profiler) and by the host's
   microseconds a call.
3. Drives the codec of the flagship model (config/dc_vic_patchgan.yaml,
   full width, random weights from a seed) on its default path: a batch of
   four 768x512 images through Codec.compress -> bitstreams ->
   Codec.decompress in the compressai format with the entropy chain on the
   card (params_backend "accel"), then one 500x740 image. It checks that the decoder's
   y_hat equals the encoder's bitwise, that the decoded images equal the
   reconstruction of the encoder's y_hat, and that the path launched K1 and
   K2.
4. Drives the same batch through a second model with the same weights built
   with recon_kernels = gn, conv3x3, fused_resblock: the same checks, all six
   kernels launched as often as the shape rules say for the modules that
   ran, and the reconstruction held against the default model's. The
   distinct shapes of the K5 and K6 launches of that round trip are printed
   with their counts, and K5 is timed beside F.conv2d at each of its shapes.

5. Holds the tpu stream format's coder kernels, R1 (rANS encode + pack) and
   R2 (decode of one section), against their plain versions on the card and
   against the host coder, at the main path's section shapes (six chained y
   sections of [4, 32, 48, 32] and one z section [4, 192, 12, 8]) for lane
   caps 128 and 512, with symbol mixes without escapes, with tier-1 escapes
   and with tier-2 escapes: equal bytes, symbols, cursors and lane states,
   all lanes back at 2^16 after the last section, equal bits on a second
   run; a stream that breaks a header guarantee must fail the integrity
   check. The same at the edges of the kernels' partitions
   (RANS_EDGE_CASES): batch 1 and 16, lane counts 32 to 4096 (R2's rounds),
   dense escapes and escapes on the first and last lane of every warp; and
   the z section on a factorised table too wide for R2's shared-memory copy
   of the pair table (WIDE_Z_QUANTILE), which R2 then reads from global
   memory. Integers: no tolerance. Then both timed at batch 4 and 16, lane caps
   128 and 512 (R1's four launches apart under torch.profiler, R2's time a
   step against its single-warp step), and the pair K3 + K4 beside
   F.group_norm and F.silu (item 2).
6. Drives the flagship model in the tpu format, host and device encode
   backends (identical strings), lanes 128 and 512, default model and
   reconstruction kernels on: R1 launches twice per compress (y and z), R2
   seven times per decompress (z and six ChARM slices). A batch-4 stream
   decoded as batch 2 must raise, and the decode chain must run under
   torch.cuda.set_sync_debug_mode("error"). Warm encode and decode seconds of both
   formats are printed.
7. Holds K3 to K6 in bf16 at the path's largest plane, [4, 128, 768, 512]
   (128 output channels), against their plain versions (K4 to K6 within one
   bf16 step), with times, the bf16 bounds (half the bytes; one product per
   multiply over the 989 TFLOP/s dense bf16 rate) and the library calls in
   bf16: F.conv2d for K5, F.silu(F.group_norm(.)) for the pair K3 + K4, K4's
   apply then F.conv2d as K6's unfused route. K5's and K6's bf16 kernels
   (csrc/conv3x3_bf16.cu) repack the weights first; that repack is held to
   its plain version bit for bit. K1 and K2 are also held to
   their plain versions at the deployment batch (M = 98304; [16, 6144, 512]).
8. Drives the deployment configuration: codec_dtype bfloat16,
   entropy_precision default, tpu format, device backend, lanes 512, a batch
   of sixteen 768x512 images (smooth content plus noise, from
   numpy.random.default_rng(0)), encoder weights scaled by 0.55, with the
   reconstruction kernels off and on: compress -> decompress -> bit-exact
   latents and pixels, consumed words checked, launch counts held against the
   shape rules (K1 1, K2 7, R1 2, R2 7), bpp and peak memory printed, the
   f32 model's round trip at the same batch beside it, and the entropy chain
   timed with the TF32 allowance on and off. The bf16 reconstruction with the kernels on and the one
   with the kernels off, of the same y_hat and codeword indices, are both
   held against the f32 model's: image by image the kernels' route may be at
   most BF16_NOISE_RATIO times as far from it as the default route.
9. Runs the pipelined cycle for three batches (dispatch k + 1, fetch k - 1,
   finalize k, decompress k with the fetch deferred), prints its seconds and
   holds every decoded batch against a plain round trip of the same images.
10. Portable streams of the same configuration: a batch-16 stream decoded as
   16, as 4 x 4 and as 16 x 1, and by another Codec, latents bit-exact in
   every grouping. Pixels are not part of the guarantee (the reconstruction
   runs at the decode batch, and the estimator's argmax turns rounding into
   other codewords): their distance between groupings is printed, and with
   the batch-16 codeword indices fed, a batch-1 reconstruction must be no
   further from the f32 model's than BF16_NOISE_RATIO times the batch-16
   reconstruction's distance. The header's portable bit is set; a non-portable batch-16 stream decoded as batch 4 raises; the
   portable decode chain runs under torch.cuda.set_sync_debug_mode("error").
11. Holds K3 to K6 in bf16 against their plain versions at every distinct
   shape that round trip launched them with, at batch 16, image by image,
   and times K5 and K6 at each of those shapes beside their bound, F.conv2d
   bf16 and (K6) the unfused route.
12. Images over 1024 px and the rest of the Codec surface, on the f32 model
   with the workload's weights: one 2048x1365 image (smooth content plus
   noise, seed 0; it pads to 2048x1408: 35 encode tiles and 35
   reconstruction tiles, 3 chunks of 16 each) round-trips through the tiled
   VQGAN encode and the tiled reconstruction in the tpu format (device
   backend, lanes 512, the decode chain under
   torch.cuda.set_sync_debug_mode("error")) and in the compressai format
   (params_backend "cpu"): latents bit-exact, pixels equal to
   _split_reconstruct of the encoder's y_hat, consumed words checked (the
   tpu stream's latents also through a default compressai Codec, whose
   tpu-format decode runs on the model's own chain), K1
   launched once per compress and K2 as often as the chunks give; encode
   and decode seconds and peak memory printed. The same image with the
   reconstruction kernels on: K3 to K6 at the tile shapes, each shape held
   against the plain version image by image, and one chunk's
   reconstruction against the kernels-off model's. A batch-4 768x512
   compressai stream encoded on the card (params_backend "cpu") decodes
   bit-exactly on a model built on the CPU from the same weights, at
   another thread count; its latents as 4, 2 x 2 and 4 x 1 are printed.
   Quality 2's betas given as betas write quality 2's strings with quality
   0 in the header, and decompress_raw with them gives quality 2's pixels.
   The compress CLI's array function (tools/compress.py) runs on two
   768x512 images with selfcheck and decompress. Last, attention with C = 64
   and a VQ with D = 8 take the plain versions on the card.
13. The training path of the flagship (f32, batch 6 of 256x256 crops of
   synthetic .npy images written from seed 0 to a temporary directory,
   random weights from seed 0 with the encoder x 0.55): (1) one RD step of
   config/exp1_stage1_2.yaml with every kernel that has a plain route off,
   then on, on the same batch, betas, noise and (pinned) VQ targets: every
   parameter main_mask trains, and the quantiles, has a finite gradient, no
   frozen one has any, and each tensor's gradient with the kernels on is
   within GRAD_TOL relative L2 (+1e-7) of the one with them off; the
   launches and the kernel Functions' backwards are held against the shape
   rules. (2) TRAIN_STEPS timed RD steps off and on, a checkpoint; stage 1_3
   (the GAN step, the PatchGAN of its config) boots it with the shipped
   knobs, TRAIN_STEPS GAN steps off and on, a checkpoint; stage 3 boots
   that with its optimizer (schedule reset, Adam's count kept) and its
   discriminator, two steps, one validation on two 768x512 images at the
   four beta corners. The frozen prior stays bit-identical, the GAN stages
   leave the encoder and move the decoder, every loss is finite. (3) Each
   kernel Function at the path's largest shape: its output has a grad_fn
   and its gradients are within GRAD_TOL of autograd of the plain version;
   forward and backward timed with CUDA events. Prints seconds per step,
   images/s, peak memory and launches per step; the kernels line carries
   the training keys (train_*).
14. The evaluation and calibration path on the f32 flagship with the
   workload's weights and every reconstruction kernel on: (1) fifty
   768x512 images (smooth content plus noise, seed 0; fifty is FID's
   minimum) through the compress CLI's body (tools/compress.py
   compress_arrays: tpu format, device backend, lanes 512, batch 16,
   selfcheck and decompress), K1 to K6, R1 and R2 launches held against the
   shape rules; (2) seeded random LPIPS(alex), DISTS and InceptionV3 weights
   (tools/workload.py metric_state_dicts) written to .pth files and loaded
   through the loaders on the card and on the host CPU: LPIPS and DISTS of
   two pairs within METRIC_TOL, the pool3 features of their patches within
   POOL3_RTOL; Inception's patches per second (host clock around the FID
   feature function) and LPIPS's and DISTS's milliseconds per image (CUDA
   events) timed, then calc_metrics over the
   fifty pairs (PSNR, MS-SSIM, LPIPS, DISTS, FID, all finite, none skipped);
   (3) build_val_dataset's crops and token maps of the fifty images, the
   rate search over CALIB_IMAGES crops on both paths (token maps and the
   eval forward) for two beta_vq and two target rates: every target within
   TOL, the two paths' results equal to rtol 1e-5, and each path's probe
   launches held against the shape rules; (4) beta_selection of two of the
   search's candidates over the fifty crops with FID, one selected; (5) a
   stage 1_2 trainer with the LPIPS file as lpips_weights: RD steps timed,
   and the LPIPS loss's forward and backward on the same batch by CUDA
   events, its share of the step. The kernels line
   carries this phase's launches (launches_eval_*).
15. The rest of the model family, random weights from seed 0: (a) stage
   1_1 of the curriculum (config/exp1_stage1_1.yaml: HyperpriorCharmVicModel,
   no betas) at full width and depth, batch 6 of 256x256, f32, the encoder
   not scaled (at 0.55 stage 1_1's y_hat is 0 everywhere; check_stage1_1
   says why that fails): one RD step's gradients with K3 to K6 off and on
   (K2, which carries no gradient here, on in both) under deterministic
   cuDNN algorithms (GRAD_TOL, as item 13),
   TRAIN_STEPS timed steps off and on (encoder and decoder move, the VQGAN
   prior does not), seconds per step and peak memory, a checkpoint; stage
   1_2 boots it with the shipped knobs (strict false): every stage 1_1
   tensor carried bit for bit, the beta FiLM (FILM_KEYS) at its
   initialisation, one 1_2 step. (b) Two codecs with every reconstruction
   kernel on, encoder x 0.55, batch 4 768x512 (smooth content plus noise):
   the stage 1_1 model (it selects no beta pairs, so it is driven at
   VARIANT_BETAS and decoded with decompress_raw) and
   config/dc_vic_patchgan.yaml as a HyperpriorDualCondVicModel
   (hyper_out_ch 384), each in the compressai format (the chain on the card
   for the ChARM model, on the host CPU for the other) and the tpu format
   (device backend, lanes 512, the decode chain under
   torch.cuda.set_sync_debug_mode("error")): latents bit-exact, pixels equal
   to reconstruct_uint8 of the encoder's y_hat, launches held to the shape
   rules and to the flagship's (K1 to K6 the same, R1 2, R2 7 with ChARM
   and 2 without: z and the one y section). (c) R1 and R2 on that one
   section, [4, 192, 48, 32] (294,912 symbols an image, six times a ChARM
   slice), at lanes 128 and 512 and the three symbol mixes: bytes, symbols,
   cursors and lane states against the plain versions and the host coder,
   R2's symbols and consumed words against the host decoder; R2 timed there
   beside its dependent chain. The kernels line carries the launches of
   these paths (launches_<model>_<format>, train_launches_stage1_1_step)
   and the one section's times (*_one_section_lanes512).
16. The OASIS GAN stage and the codec profiler: (a) the flagship at full
   width and depth, batch 6 of 256x256, f32, random weights from seed 0, the
   encoder not scaled, trained by DualBetaCondOasisGanDistortionVqFusionTrainer
   with the discriminator block of config/dc_vic_oasis.yaml (257 classes on
   the 32 x 32 token grid) and OasisGANLoss (OASIS_LOSS): one step's
   gradients, the generator's and the discriminator's, with K3 to K6 off and
   on under DETERMINISTIC (GRAD_TOL); TRAIN_STEPS timed steps off, on, and on
   with mc_sampling (the reals keyed on their own vq_encode); losses finite
   and no step skipped, the frozen parameters bit-identical, the decoder
   moved; a checkpoint whose discriminator a second trainer boots bit for
   bit. (b) One step each of OasisDualBetaCondTamingNLayerDiscriminator at
   n_layers 2 (its 64 x 64 logits resized nearest to the token grid) and of
   DualBetaFtTamingNLayerDiscriminator in stage 1_3's vanilla GAN step; each
   discriminator moves. (c) tools/profile_codec.py's profile over the
   contract configuration (item 8's, every reconstruction kernel on):
   PROFILE_ROUNDS rounds after a warm-up, launches held to that many of item
   8's round trip, each stage's mean and images/s printed. (d) One warm
   OASIS step with the kernels on under torch.profiler: device time, the
   share of K1 to K6 and of their Functions' backwards, the top kernels.
   The kernels line carries the OASIS step's launches and Function
   backwards (train_launches_oasis_step, train_backwards_oasis_step).
17. The training soak (dc_vic_tpu_torch/tools/soak.py): K2 at the soak's
   shapes, [6, 1024, 128] (a training step at batch 6 of 256x256) and
   [1, 1024, 128] (an eval image), against its plain version at item 2's
   tolerance; then the curriculum's four stages through the soak's own
   run_curriculum on docs/artifacts/soak_gan_config.yaml (the soak's
   widths, its synthetic data from seed 0, every reconstruction kernel on)
   at SOAK_ITERS iterations a stage, an eval every SOAK_EVAL_STEP, every
   counter set to 0 just before and read just after. Each stage's trainer
   is built again from its options for one step under the shape rules; the
   soak's own launches and Function backwards of every step must equal
   theirs (K1 once; K2 five times, its attention blocks all before the
   first SFT tap, so no K2 backward; K3 and K4 twice with their backwards,
   on the two [6, 128, 64, 64] GroupNorms, the VQGAN decoder's
   up.2.block.0.norm1 and the block_1_4 SFT tap's norm1; K5 and K6 off,
   4,096 positions under their 12,288), and K3/K4 are held against their
   plain versions at those GroupNorm shapes (f32, as item 12's tiles). No
   step skipped, every logged loss and d_loss finite, the hand-offs as
   their knobs say (s2 carries SOAK_S2_CARRIED tensors with the beta FiLM
   at its initialisation, s3 and s4 load strictly, s4 with the optimizer
   states and the discriminator), checkpoints and CSV rows written. The
   gates are printed, not held: at this length they show the mechanics;
   the quality is the full runs' (PERF.md). The kernels line carries a
   soak step's launches and Function backwards (train_launches_soak_step,
   train_backwards_soak_step).
18. The last modules and model options (tools/workload.py's variants at
   full width, random weights from seed 0, the codecs' encoders scaled by
   0.55): (a) variant A (config/dc_vic_patchgan.yaml with long_indices into
   ElicDualBetaFtVqEmbCatEncoder, the VQGAN recon beside the image, the
   image in [0, 1], pixel-shuffle decoder, light SFT fusion, gelu
   estimator), batch 4 of 768x512 in the tpu format (device backend, lanes
   512), f32 with entropy_precision high and bf16 with default, the
   reconstruction kernels off and all on: each round trip bit-exact with
   its launches held to the shape rules (the recon runs the VQGAN decoder,
   and with it K2 and K6, on the encode side too; every kernel launches in
   the f32 kernels-on run), the kernels-on pixels held against the
   kernels-off ones (f32: RECON_TOL; bf16: BF16_NOISE_RATIO against the f32
   model's), warm encode and decode seconds, bpp and peak memory printed;
   (b) variant B (config/exp1_stage1_1.yaml with norm_indices into
   ElicVqScEncoder, double_z, leaky-ReLU estimator), f32, tpu and
   compressai formats, kernels off and on, bit-exact, launches held; (c)
   one RD step of variant A on stage 1_2's config, batch 6 of 256x256,
   kernels on: finite, not skipped, launches and Function backwards held to
   the rules and printed; (d) the standalone transforms at full width
   (ElicEncoder -> ElicDecoder with transposed-conv and pixel-shuffle
   upsampling, Balle'18, Cheng'20, Test): one batch-4 768x512 forward each
   on the card, its first image held against the same module on the host
   CPU (f32, TF32 off) within STANDALONE_TOL (relative, and absolute over
   the output's largest magnitude; decoders before their tanh). The
   kernels line carries each variant's launches per round trip
   (launches_variant_a_f32_tpu_on, ...).
19. More than one device (parallel/mesh.py): (a) data-parallel training of
   the flagship with the kernels on, batch 6 of 256x256: stage 1_2's RD step
   and stage 1_3's GAN step (fresh weights from seed 0), each once in this
   process, then again from the same state through an nccl process group of
   world 1, which must give the same bits, then in 2 ranks on this one card
   joined by gloo (spawned processes, 3 images each): every rank starts from
   the bits this process started from, the gradients the optimizers used
   are within GRAD_TOL relative L2 of the 1-process step's taken in
   micro-batches of the ranks' shape (each rank's rows and slice of the
   global draws in turn, _Microbatch), and the ranks hold the same bits
   after the step. Against the 1-process step of the whole batch at once
   the terms are held within WHOLE_BATCH_TERM_TOL of max(|term|, 1) and
   every gradient within WHOLE_BATCH_GRAD_TOL relative L2: on random
   weights the batch shapes' cuDNN algorithms flip the rounding of y and
   the estimator's argmax at near-ties, which moves whole gradients by
   percents, and the eval forward on the batch against its halves (nothing
   sliced) prints how far y moves before rounding and how many roundings
   and argmaxes flip. With two or more cards the same again
   with nccl, one card a rank. Every step runs under DETERMINISTIC and its
   launches and Function backwards are held to the shape rules in its own
   process; a second, warm step is timed (host clock, ending in a
   synchronize). (b) The contract configuration (bf16, entropy_precision
   default, kernels on, tpu format, device backend, lanes 512, batch 16) on
   make_mesh(["cuda:0", "cuda:0"]) (and on every card when there are two or
   more): bit-exact round trips, decoded images equal to each shard's
   reconstruct_uint8, batch 15 padded to 16, launches equal to twice a
   single-device round trip's at batch 8, portable streams decoding
   bit-exactly between the mesh codec and a single-device one in both
   directions; the wall time of a round trip of the mesh against the
   single-device codec at batch 16.
20. Fully sharded training (parallel/fsdp.py, ``fsdp: true``), stages 1_2
   (RD) and 1_3 (GAN) at item 19's batch and ranks: (b) over an nccl group
   of world 1 the trainer shards nothing and its step is the plain step bit
   for bit; (e) data_parallel_eval of the flagship's eval forward over
   ["cuda:0", "cuda:0"] against one call on the batch of 6, each output
   within item 19's WHOLE_BATCH_GRAD_TOL; (a) 2 gloo ranks on this card
   (nccl, a card a rank, with two or more), each running the data-parallel
   step and then the FSDP step from the same bits under DETERMINISTIC: the
   terms and the launches equal (and equal to item 19's ranks'), every
   slice a rank holds and every whole tensor (weights, both Adam moments,
   counters) within FSDP_TOL of the data-parallel rank's (the JAX FSDP
   test's tolerance; the bit-equal count and the largest difference
   printed), the gathered states bit-equal across the ranks; (c) a rank's
   bytes of parameters and moments between steps, FSDP against data
   parallel, the bytes a step all-gathers, reduce-scatters and
   all-reduces, the peak over a warm step and the warm step's seconds
   (host clock); (d) the FSDP ranks' stage 1_3 save (gathered on every
   rank, written by rank 0) boots a 1-process trainer bit for bit: model,
   discriminator and the optimizer states. The kernels line carries each
   rank's launches of the FSDP steps (train_launches_fsdp_*_ranks).
A Codec constructed and called with the caller's TF32 and cuDNN benchmark
on leaves them so and round-trips bit-exactly (after item 3).

For every kernel it prints the least time the card could take for the same
work: each input read once and each output written once over 3.35 TB/s, or
the operations over the rate of the unit a correct kernel can use, whichever
is larger. For K1, K3 and K4 that unit is the 67 TFLOP/s f32 rate outside the
tensor cores. K2, K5 and K6 need f32-class results from matrix products,
which the tensor cores give as an error-compensated split in three TF32
products: three times the operations over the 495 TFLOP/s dense TF32 rate
(bound_ms); the f32 figure is kept beside it (bound_ffma_ms). A kernel faster
than its bound fails the run: the bound or the timing would be wrong. Where
one PyTorch call computes the same function, that call's time is printed too.
K1 is one launch of a few microseconds, which a loop of Python calls cannot
time: its entry is timed at the contract's M by graph replay (ms, plain_ms)
and by the profiler (profiled_ms), with the host's microseconds a call
(host_us_per_call), the same at each of the four latents in per_m (with
each one's bound), the launch-to-finish time of an empty kernel by both
methods (launch_floor_ms, launch_floor_profiled_ms) and the larger of that
and the operation bound (bound_with_launch_ms). The bf16 entries
(names ending in _bf16) are bound by bytes or by their operations over the
bf16 rate; their launches are those of the deployment configuration's round
trip with the reconstruction kernels on, which the other entries carry as
launches_bf16_batch16. R1 and R2 are bound by
neither bytes nor operations but by their dependent chain: their entries
carry chain_ms, the steps of the longest chain times the time of one step as
measured with a single warp (batch 1, 32 lanes), where nothing but latency
is left; "timed" holds it at every batch and lane count timed. The printed
lines also give the same steps times a fixed step latency (R1_STEP_FIXED_US,
R2_STEP_FIXED_US) that does not move with the kernel under test; that
yardstick is not measured here, so it stays out of the kernels line.

Any failure raises and the script exits non-zero. It needs CUDA and fails
without it. The last line is a JSON object naming the device.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _time_ms(fn, *args, reps=10):
    import torch
    fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM data sheet, dense bf16 on the tensor cores


def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
    """(ms, what binds): the larger of bytes over the memory rate and
    operations over the given rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bounds(nbytes, flops, split_tf32=False):
    """The bound keys of a kernel entry. ``split_tf32``: the kernel's
    products can run as three TF32 products each on the tensor cores."""
    ffma_ms, _ = bound(nbytes, flops)
    if split_tf32:
        ms, by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    else:
        ms, by = bound(nbytes, flops)
    return {"bound_ms": ms, "bound_by": by, "bound_ffma_ms": ffma_ms}


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _border(t):
    """The one-pixel frame of the last two dims, flattened."""
    import torch
    return torch.cat([t[..., 0, :].flatten(), t[..., -1, :].flatten(),
                      t[..., :, 0].flatten(), t[..., :, -1].flatten()])


def _vq_held(vq, got, z, book, label):
    """(rows that differ, max distance gap) of K1's indices ``got`` for rows
    z [M, 4] against the plain version; rows that differ must be near ties
    (top-two gap < 1e-6*max(1,|d|))."""
    import torch
    want = vq.vq_argmin_plain(z, book)
    dist = (book * book).sum(-1)[None] - 2.0 * (z @ book.t())
    d_got = dist.gather(1, got.long()[:, None])[:, 0]
    d_want = dist.gather(1, want.long()[:, None])[:, 0]
    gap = (d_got - d_want).abs()
    bad = got != want
    tol = 1e-6 * torch.clamp(d_want.abs(), min=1.0)
    if bool((bad & (gap >= tol)).any()):
        raise AssertionError(f"vq_argmin disagrees beyond near-ties: {label}")
    return int(bad.sum()), float(gap.max())


def check_vq(vq, dev, gen):
    """K1 against its plain version: random latents at the port's four M
    (VQ_SHAPES: training, batch 4, the tiled 2048x1365 canvas, the
    contract's batch 16) through the NCHW entry the quantizer calls and
    through the flat entry, which must agree; a ragged M; codebooks of 1000
    and 11,622 entries (the most shared memory takes; not a multiple of the
    kernel's four lanes); exact duplicates in other lanes' slices and in one
    slice, whose rows must go to the lower index; the NCHW entry at B > 1
    with H W no multiple of a block's rows, contiguous and channels-last.
    Then timed at each M by device time (graph replay of 100 calls; the
    kernel's own duration under torch.profiler) and by the host's
    microseconds a call, beside its bound. Returns the kernel entry, timed
    at the contract's M."""
    import torch
    from dc_vic_tpu_torch.tools.vq_time import VQ_SHAPES
    from dc_vic_tpu_torch.utils.profiling import graph_ms, host_us_per_call, profiled_ms
    worst, near_ties = 0.0, 0
    cb = torch.randn(256, 4, generator=gen, device=dev) * 0.05

    def held(got, z, book, label):
        nonlocal worst, near_ties
        n, gap = _vq_held(vq, got, z, book, label)
        near_ties += n
        worst = max(worst, gap)

    latents = {}
    for label, B, h, w in VQ_SHAPES:
        z = torch.randn(B, 4, h, w, generator=gen, device=dev) * 0.05
        flat = z.permute(0, 2, 3, 1).reshape(-1, 4).contiguous()
        got = vq.vq_argmin_nchw(z, cb)
        if not torch.equal(got.reshape(-1), vq.vq_argmin(flat, cb)):
            raise AssertionError(f"vq_argmin: the NCHW and flat entries differ, {label}")
        held(got.reshape(-1), flat, cb, label)
        latents[label] = z
    z = torch.randn(1037, 4, generator=gen, device=dev) * 0.05
    held(vq.vq_argmin(z, cb), z, cb, "M = 1037")
    for N in (1000, 11622):
        book = torch.randn(N, 4, generator=gen, device=dev) * 0.05
        z = torch.randn(3001, 4, generator=gen, device=dev) * 0.05
        held(vq.vq_argmin(z, book), z, book, f"N = {N}")
    dup = cb.clone()
    pairs = ((100, 7), (255, 0), (13, 6), (12, 4))    # other lanes' slices, then one slice
    for hi, lo in pairs:
        dup[hi] = dup[lo]
    z = dup.repeat_interleave(8, 0)
    got = vq.vq_argmin(z, dup)
    held(got, z, dup, "exact ties")
    if any(bool((got[hi * 8:hi * 8 + 8] != lo).any()) for hi, lo in pairs):
        raise AssertionError("vq_argmin tie rows must resolve to the lower index")
    for shape in ((3, 37, 29), (2, 1, 45)):
        z = torch.randn(shape[0], 4, *shape[1:], generator=gen, device=dev) * 0.05
        for zz in (z, z.contiguous(memory_format=torch.channels_last)):
            flat = zz.permute(0, 2, 3, 1).reshape(-1, 4).contiguous()
            if not torch.equal(vq.vq_argmin_nchw(zz, cb).reshape(-1), vq.vq_argmin(flat, cb)):
                raise AssertionError(f"vq_argmin: NCHW entry differs from flat at {shape}")
    print(f"K1 vq_argmin: indices equal to plain except {near_ties} near-tie rows "
          f"(top-two gap < 1e-6*max(1,|d|)); max distance gap {worst:.3e}; NCHW entry equal "
          f"to the flat entry; ties to the lower index across lane slices")

    per_m = []
    for label, B, h, w in VQ_SHAPES:
        z = latents[label]
        M = B * h * w
        flat = z.permute(0, 2, 3, 1).reshape(-1, 4).contiguous()
        # per row and codeword: 4 multiply-adds for the cross term, 2 more flops
        row = {"shape": label, "M": M, "device_ms": graph_ms(vq.vq_argmin_nchw, z, cb),
               "profiled_ms": profiled_ms(vq.vq_argmin_nchw, z, cb, kernel="vq_argmin"),
               "host_us_per_call": host_us_per_call(vq.vq_argmin_nchw, z, cb),
               "flat_device_ms": graph_ms(vq.vq_argmin, flat, cb),
               "plain_ms": graph_ms(vq.vq_argmin_plain, flat, cb),
               **bounds(_nbytes(z, cb) + M * 4, M * cb.shape[0] * 10)}
        per_m.append(row)
        print(f"K1 at M={M} ({label}): device {row['device_ms'] * 1e3:.3f} us by graph "
              f"replay, {row['profiled_ms'] * 1e3:.3f} us by the profiler (flat entry "
              f"{row['flat_device_ms'] * 1e3:.3f} us), host {row['host_us_per_call']:.2f} us a "
              f"call, plain {row['plain_ms'] * 1e3:.3f} us; bound {row['bound_ms'] * 1e3:.3f} "
              f"us ({row['bound_by']}), {row['bound_ms'] / row['profiled_ms']:.1%} of it")
    top = per_m[-1]
    return {"name": "vq_argmin", "route": "cuda",
            "source": "dc_vic_tpu_torch/csrc/vq_argmin.cu",
            "replaces": "dc_vic_tpu/ops/vq.py:21", "max_abs_err": worst,
            "shape": [VQ_SHAPES[-1][1], 4, *VQ_SHAPES[-1][2:]],
            "ms": top["device_ms"], "profiled_ms": top["profiled_ms"],
            "host_us_per_call": top["host_us_per_call"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "bound_ffma_ms": top["bound_ffma_ms"], "library_ms": None, "per_m": per_m}


ATTENTION_CASES = [((4, 6144, 512), 1.0), ((2, 6144, 512), 1.0), ((1, 1000, 512), 1.0),
                   ((1, 1024, 128), 3.0),
                   ((1, 1037, 512), 1.0),      # N a multiple of no tile
                   ((1, 2048, 512), 0.728),    # scores over about +-60
                   ((16, 6144, 512), 1.0)]     # the deployment configuration's batch
ATTENTION_TIMED = ((16, 6144, 512),)             # timed beside the first case


def _attention_float64(q, k, v):
    """softmax(q k^T) v with every step in float64, one image at a time."""
    import torch
    out = torch.empty_like(q)
    lo = hi = 0.0
    for b in range(q.shape[0]):
        s = q[b].double() @ k[b].double().t()
        lo, hi = min(lo, float(s.min())), max(hi, float(s.max()))
        out[b] = (torch.softmax(s, dim=-1) @ v[b].double()).float()
    return out, lo, hi


def check_attention(attention, dev, gen):
    """K2 against its plain version and against the same function in
    float64 (atol = rtol = 1e-4: the summation order differs and the
    products are three TF32 products each), first at the main path's shape
    [4, 6144, 512], where it is also timed, beside
    F.scaled_dot_product_attention on the same f32 operands. A scale other
    than 1 multiplies q and k (instead of q's C^-1/2): 0.728 spreads the
    scores of 512 channels over about +-60, where the running maximum moves
    most and the rescale works hardest; 3.0 at C = 128 spreads them over
    +-500, where an f32 score is only good to 1e-4 and the f32 plain version
    itself leaves the tolerance against float64 on some inputs. So the
    kernel is held to float64 always, and to the plain version wherever the
    plain version is itself within the tolerance of float64; where it is
    not, the line says how far off it is. Each case twice: equal bits. The
    contract's [16, 6144, 512] (ATTENTION_TIMED) is timed the same way; its
    numbers go into the entry's ``per_shape`` beside the first shape's."""
    import torch
    import torch.nn.functional as F
    from dc_vic_tpu_torch.ops import native
    smem = {C: native.kernels().dcvic_flash_attn_f32_smem(C) for C in (128, 256, 384, 512)}
    print("K2 dynamic shared memory a block: "
          + ", ".join(f"C={C} {n} bytes" for C, n in smem.items()))
    worst = 0.0
    per_shape = []
    tol = dict(atol=1e-4, rtol=1e-4)
    for (B, N, C), scale in ATTENTION_CASES:
        pre = C ** -0.5 if scale == 1.0 else scale
        q = torch.randn(B, N, C, generator=gen, device=dev) * pre
        k = torch.randn(B, N, C, generator=gen, device=dev) * scale
        v = torch.randn(B, N, C, generator=gen, device=dev)
        got = attention.flash_attention(q, k, v)
        want = attention.attention_plain(q, k, v)
        exact, s_lo, s_hi = _attention_float64(q, k, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention gave non-finite values at {(B, N, C)}")
        torch.testing.assert_close(got, exact, **tol)
        err = float((got - want).abs().max())
        plain_off = float((want - exact).abs().max())
        if torch.allclose(want, exact, **tol):
            torch.testing.assert_close(got, want, **tol)
            note = ""
        else:
            note = (f"; the f32 plain version is {plain_off:.3e} from float64, outside the "
                    f"tolerance: held to float64 alone")
        if not torch.equal(got, attention.flash_attention(q, k, v)):
            raise AssertionError(f"flash_attention is not repeatable at {(B, N, C)}")
        print(f"K2 flash_attention [{B},{N},{C}] q,k x{scale}, scores in [{s_lo:.1f}, "
              f"{s_hi:.1f}]: max abs err {err:.3e} to plain, "
              f"{float((got - exact).abs().max()):.3e} to float64; repeatable{note}")
        worst = max(worst, err)
        del exact
        if not per_shape or (B, N, C) in ATTENTION_TIMED:
            lib = lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0)
            torch.testing.assert_close(lib(), want, atol=1e-4, rtol=1e-4)
            # two products of 2*N*N*C flops per image
            row = {"shape": [B, N, C], "ms": _time_ms(attention.flash_attention, q, k, v),
                   "plain_ms": _time_ms(attention.attention_plain, q, k, v),
                   **bounds(_nbytes(q, k, v, got), 4 * B * N * N * C, split_tf32=True),
                   "library_ms": _time_ms(lib)}
            per_shape.append(row)
            print(f"K2 at [{B},{N},{C}]: kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} "
                  f"ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}, 3xTF32; "
                  f"{row['bound_ms'] / row['ms']:.1%} of it), "
                  f"F.scaled_dot_product_attention {row['library_ms']:.3f} ms")
        del got, want, q, k, v
        torch.cuda.empty_cache()
    top = {key: val for key, val in per_shape[0].items() if key != "shape"}
    return {"name": "flash_attention", "route": "cuda",
            "source": "dc_vic_tpu_torch/csrc/flash_attn_f32.cu",
            "replaces": "dc_vic_tpu/ops/attention.py:25", "max_abs_err": worst,
            "shape": per_shape[0]["shape"], **top, "per_shape": per_shape}


GN_SHAPES = [((4, 128, 768, 512), "float32"), ((4, 256, 384, 256), "float32"),
             ((4, 512, 96, 64), "float32"), ((2, 24, 37, 53), "float32"),
             ((4, 128, 192, 128), "bfloat16")]


def check_gn(gn, dev, gen):
    """K3 and K4 at the main path's planes, a ragged plane and a bf16 plane.
    K3 and its plain version are both held to a float64 sum of the same
    input within 1e-5 of sum|x| (for the sums) and of sum x^2 (for the sums
    of squares): f32 accumulation over up to 393,216 values. K4 is held to
    its plain version at atol = rtol = 1e-6 in f32 (the affine has the
    plain version's bits; the sigmoid may differ in the last place) and
    1e-2 in bf16 (one step of the output type). Both twice: equal bits.
    Timed at [4, 128, 768, 512] f32, the largest plane of the path."""
    import torch
    k3 = k4 = None
    for shape, dtype_name in GN_SHAPES:
        dtype = getattr(torch, dtype_name)
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        scale = torch.rand(shape[:2], generator=gen, device=dev) * 1.5 + 0.5
        bias = torch.randn(shape[:2], generator=gen, device=dev)
        sums = gn.channel_sums(x)
        plain = gn.channel_sums_plain(x)
        want = torch.empty(shape[0], 2, shape[1], dtype=torch.float64, device=dev)
        ref_scale = torch.empty_like(want)
        for b in range(shape[0]):                     # float64 one image at a time
            xd = x[b].double().flatten(1)
            sq = (xd * xd).sum(-1)
            want[b, 0], want[b, 1] = xd.sum(-1), sq
            ref_scale[b, 0], ref_scale[b, 1] = xd.abs().sum(-1), sq
            del xd
        torch.cuda.synchronize()
        rel = {}
        for name, val in (("kernel", sums), ("plain", plain)):
            rel[name] = float(((val.double() - want).abs() / ref_scale).max())
            if not rel[name] <= 1e-5:
                raise AssertionError(f"gn_channel_sums {name} off float64 by {rel[name]:.2e} "
                                     f"of the scale at {shape}")
        if not torch.equal(sums, gn.channel_sums(x)):
            raise AssertionError(f"gn_channel_sums is not repeatable at {shape}")
        err3 = float((sums - plain).abs().max())
        print(f"K3 gn_channel_sums {list(shape)} {dtype_name}: against float64, in units of "
              f"sum|x| / sum x^2: kernel {rel['kernel']:.2e}, plain {rel['plain']:.2e}; "
              f"max abs diff to plain {err3:.3e}; repeatable")
        err4 = 0.0
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        for act in (None, "swish"):
            got = gn.apply_affine(x, scale, bias, act)
            ref = gn.apply_affine_plain(x, scale, bias, act)
            torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
            if not torch.equal(got, gn.apply_affine(x, scale, bias, act)):
                raise AssertionError(f"gn_apply is not repeatable at {shape}")
            err4 = max(err4, float((got.float() - ref.float()).abs().max()))
            del got, ref
        print(f"K4 gn_apply {list(shape)} {dtype_name}: max abs err {err4:.3e} "
              f"(act none and swish, tolerance {tol:g}); repeatable")
        if k3 is None:
            n = x.numel()
            b3 = bounds(_nbytes(x, sums), 3 * n)                # add, multiply-add
            b4 = bounds(2 * _nbytes(x) + _nbytes(scale, bias), 6 * n)
            k3 = {"name": "gn_channel_sums", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/gn.cu",
                  "replaces": "dc_vic_tpu/ops/gn.py:52", "max_abs_err": err3,
                  "ms": _time_ms(gn.channel_sums, x),
                  "plain_ms": _time_ms(gn.channel_sums_plain, x),
                  **b3, "library_ms": None}
            k4 = {"name": "gn_apply", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/gn.cu",
                  "replaces": "dc_vic_tpu/ops/gn.py:117", "max_abs_err": err4,
                  "ms": _time_ms(gn.apply_affine, x, scale, bias, "swish"),
                  "plain_ms": _time_ms(gn.apply_affine_plain, x, scale, bias, "swish"),
                  **b4, "library_ms": None}
            # no single PyTorch call computes K3's or K4's function; the pair
            # is F.group_norm, then F.silu for the swish variant
            gamma = torch.rand(shape[1], generator=gen, device=dev) + 0.5
            beta = torch.randn(shape[1], generator=gen, device=dev) * 0.1
            pairs = group_norm_pairs(gn, x, gamma, beta, 2e-5)
            k3.update(pairs)
            k4.update(pairs)
        del x, sums, plain, want, ref_scale
    print(f"K3 at {list(GN_SHAPES[0][0])}: kernel {k3['ms']:.3f} ms, plain "
          f"{k3['plain_ms']:.3f} ms, bound {k3['bound_ms']:.3f} ms ({k3['bound_by']})")
    print(f"K4 at {list(GN_SHAPES[0][0])}: kernel {k4['ms']:.3f} ms, plain "
          f"{k4['plain_ms']:.3f} ms, bound {k4['bound_ms']:.3f} ms ({k4['bound_by']})")
    return k3, k4


def group_norm_pairs(gn, x, gamma, beta, tol):
    """K3 + K4 with the glue between them, as nn/layers.py::GroupNorm runs
    them (32 groups, eps 1e-6, without and with swish), against the library
    route on the same input: F.group_norm, then F.silu. Held within ``tol``
    of each other; returns the four times."""
    import torch
    import torch.nn.functional as F
    g, b = gamma.to(x.dtype), beta.to(x.dtype)
    out = {}
    for act, lib in ((None, lambda: F.group_norm(x, 32, g, b, 1e-6)),
                     ("swish", lambda: F.silu(F.group_norm(x, 32, g, b, 1e-6)))):
        pair = lambda: gn.group_norm(x, gamma, beta, 32, 1e-6, act)
        torch.testing.assert_close(pair(), lib(), atol=tol, rtol=tol)
        key = "" if act is None else "_swish"
        out[f"pair{key}_ms"], out[f"pair{key}_library_ms"] = _time_ms(pair), _time_ms(lib)
    print(f"K3+K4 with the GroupNorm glue at {list(x.shape)} {str(x.dtype)[6:]}: "
          f"{out['pair_ms']:.3f} ms, with swish {out['pair_swish_ms']:.3f} ms; F.group_norm "
          f"{out['pair_library_ms']:.3f} ms, F.silu(F.group_norm(.)) "
          f"{out['pair_swish_library_ms']:.3f} ms ({tol:g} apart at most)")
    return out


CONV_SHAPES = [((4, 128, 128, 768, 512), "float32"), ((4, 256, 256, 384, 256), "float32"),
               ((4, 256, 128, 192, 128), "float32"), ((2, 128, 64, 13, 37), "float32"),
               ((4, 128, 128, 192, 128), "bfloat16"),
               ((4, 512, 512, 192, 128), "float32")]    # the path's deepest reduction


def check_conv(conv3x3, dev, gen):
    """K5 and K6 (with and without the residual) at four planes of the main
    path, an odd-sized plane whose tiles are ragged, and a bf16 plane,
    against their plain versions (F.conv2d with TF32 off): atol = rtol =
    1e-4 in f32 (another summation order over up to 4608 taps, each product
    three TF32 products), 1e-2 in bf16
    (one step of the output type: kernel and plain version both round an f32
    sum once), over the whole tensor and over the one-pixel
    border alone. K6's affine has a bias near 2, so a halo that was not
    zeroed after the swish would show in the border. Each twice: equal
    bits. Timed at every f32 plane; the first is the one reported."""
    import torch
    import torch.nn.functional as F
    k5 = k6 = None
    for (B, C, Cout, H, W), dtype_name in CONV_SHAPES:
        dtype = getattr(torch, dtype_name)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        x = torch.randn(B, C, H, W, generator=gen, device=dev).to(dtype)
        w = (torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
        scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
        bias = torch.randn(B, C, generator=gen, device=dev) + 2.0
        cbias = torch.randn(Cout, generator=gen, device=dev)
        res = torch.randn(B, Cout, H, W, generator=gen, device=dev).to(dtype)
        label = f"[{B},{C},{H},{W}]->{Cout} {dtype_name}"
        cases = [("K5 conv3x3_same", lambda: conv3x3.conv3x3_same(x, w),
                  lambda: conv3x3.conv3x3_same_plain(x, w)),
                 ("K6 conv3x3_gn_swish", lambda: conv3x3.conv3x3_gn_swish(
                     x, w, scale, bias, cbias, None),
                  lambda: conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, None)),
                 ("K6 conv3x3_gn_swish +res", lambda: conv3x3.conv3x3_gn_swish(
                     x, w, scale, bias, cbias, res),
                  lambda: conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res))]
        errs, times = [], []
        for name, kernel, plain in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            whole = float((got.float() - want.float()).abs().max())
            edge = float((_border(got).float() - _border(want).float()).abs().max())
            torch.testing.assert_close(_border(got), _border(want), atol=tol, rtol=tol)
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
            if not torch.equal(got, kernel()):
                raise AssertionError(f"{name} is not repeatable at {label}")
            del got, want
            line = (f"{name} {label}: max abs err {whole:.3e} whole, {edge:.3e} border "
                    f"(tolerance {tol:g}); repeatable")
            if dtype == torch.float32 and H * W > 1000:
                times.append((_time_ms(kernel, reps=3), _time_ms(plain, reps=3)))
                line += f"; kernel {times[-1][0]:.3f} ms, plain {times[-1][1]:.3f} ms"
            print(line)
            errs.append(max(whole, edge))
        if k5 is None:
            flops = 2 * 9 * C * Cout * B * H * W
            b5 = bounds(_nbytes(x, w) + _nbytes(res), flops, split_tf32=True)
            # K6 also reads the residual, scale, bias and the conv bias; the
            # affine and swish add about 6 flops per input element
            b6 = bounds(_nbytes(x, w, scale, bias, cbias, res) + _nbytes(res),
                        flops + 6 * x.numel() + 2 * res.numel(), split_tf32=True)
            k5 = {"name": "conv3x3_same", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/conv3x3.cu",
                  "replaces": "dc_vic_tpu/ops/conv3x3.py:59", "max_abs_err": errs[0],
                  "ms": times[0][0], "plain_ms": times[0][1], **b5,
                  "library_ms": _time_ms(lambda: F.conv2d(x, w, padding=1), reps=3)}
            k6 = {"name": "conv3x3_gn_swish", "route": "cuda",
                  "source": "dc_vic_tpu_torch/csrc/conv3x3.cu",
                  "replaces": "dc_vic_tpu/ops/conv3x3.py:220",
                  "max_abs_err": max(errs[1:]), "ms": times[2][0],
                  "plain_ms": times[2][1], **b6, "library_ms": None}
        del x, w, res
    for k in (k5, k6):
        print(f"{k['name']} at [4,128,768,512]->128: kernel {k['ms']:.3f} ms, plain "
              f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.3f} ms ({k['bound_by']}, "
              f"3xTF32; {k['bound_ffma_ms']:.3f} ms at the f32 rate), "
              f"library {k['library_ms']}")
    return k5, k6


def time_conv_shapes(conv3x3, shapes, dev, gen):
    """K5 beside F.conv2d (TF32 off) at each distinct shape the main path
    launched it with: one printed line per shape, with its launch count."""
    import torch
    import torch.nn.functional as F
    rows = []
    for (B, C, Cout, H, W), count in sorted(shapes.items()):
        x = torch.randn(B, C, H, W, generator=gen, device=dev)
        w = torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05
        ms = _time_ms(conv3x3.conv3x3_same, x, w, reps=3)
        lib = _time_ms(lambda: F.conv2d(x, w, padding=1), reps=3)
        rows.append({"shape": [B, C, Cout, H, W], "launches": count, "ms": ms,
                     "library_ms": lib})
        print(f"K5 at [{B},{C},{H},{W}]->{Cout}: {count} launches per round trip, kernel "
              f"{ms:.3f} ms, F.conv2d {lib:.3f} ms")
        del x, w
    return rows


def launch_floor_ms(native):
    """(graph replay ms, profiled ms) of an empty kernel's launch to finish,
    by the same two methods as K1's device time."""
    import torch
    from dc_vic_tpu_torch.utils.profiling import graph_ms, profiled_ms
    lib = native.kernels()

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        native.check(lib.dcvic_launch_floor(1, 32, stream), "launch_floor")
    return graph_ms(launch), profiled_ms(launch, kernel="launch_floor_kernel")


Y_PLANES = (4, 192, 48, 32)     # y of four 768x512 images: six sections of 32 channels
Z_PLANES = (4, 192, 12, 8)      # z of the same: one section, CDF row = channel
RANS_MIXES = ("no escapes", "tier-1 escapes", "tier-2 escapes")
# mixes whose payloads pass 0xFFFF: int32 planes and tier-2 words
RANS_WIDE = ("tier-2 escapes", "escape-heavy", "edge escapes")
# (planes, sections, lane cap, mix) at the partition edges of R1 and R2:
# batch 1 and 16; one warp of lanes, 256, and the rounds of R2 at 1024,
# 2048 and 4096 lanes; escapes dense, or on the first and last lane of every
# warp (and so of every 64-lane block of R1's state kernel)
RANS_EDGE_CASES = [((1, 192, 48, 32), 6, 512, "edge escapes"),
                   ((16, 192, 48, 32), 6, 512, "escape-heavy"),
                   ((4, 192, 48, 32), 6, 32, "edge escapes"),
                   ((4, 192, 48, 32), 6, 256, "escape-heavy"),
                   ((4, 192, 48, 32), 6, 1024, "edge escapes"),
                   ((2, 192, 48, 32), 1, 2048, "escape-heavy"),
                   ((2, 192, 48, 32), 1, 4096, "edge escapes")]


def _rans_planes(rng, table, shape, mix, factorised, S=1, L=32):
    """Symbol and index planes on the host: each symbol drawn inside its
    row's range; then 2% of them up to +-20000 (one tier-1 word each), then
    0.5% of them up to +-40000 (payloads past 0xFFFF: two tier-2 words).
    "escape-heavy": 30% and 3% instead. "edge escapes": every symbol on the
    first or last lane of a 32-lane group (S sections, L lanes) escapes,
    tier-1 on even steps and tier-2 on odd ones."""
    B, C, H, W = shape
    rows = len(table.offsets)
    if factorised:
        idx = np.broadcast_to(np.arange(C).reshape(1, C, 1, 1), shape)
    else:
        idx = rng.integers(0, rows, shape)
    maxv = (np.asarray(table.cdf_lengths) - 2)[idx]
    width = np.maximum(maxv // 6, 1)
    centre = maxv // 2
    value = np.clip(np.round(centre + rng.normal(0, 1, shape) * width), 0, maxv - 1)
    sym = (value + np.asarray(table.offsets)[idx]).astype(np.int32)
    if mix in ("tier-1 escapes", "tier-2 escapes"):
        hot = rng.random(shape) < 0.02
        sym = np.where(hot, rng.integers(-20000, 20000, shape), sym)
    if mix == "tier-2 escapes":
        hot = rng.random(shape) < 0.005
        sym = np.where(hot, rng.integers(-40000, 40000, shape), sym)
        sym[0, 0, 0, 1], sym[-1, -1, -1, -2] = 40000, -40000
    if mix == "escape-heavy":
        sym = np.where(rng.random(shape) < 0.3, rng.integers(-20000, 20000, shape), sym)
        sym = np.where(rng.random(shape) < 0.03, rng.integers(-40000, 40000, shape), sym)
    if mix == "edge escapes":
        sc = C // S
        p = np.arange(H * W)[None, :] * sc + (np.arange(C) % sc)[:, None]    # stream position
        lane, step = p % L, p // L
        edge = (lane % 32 == 0) | (lane % 32 == 31)
        value = np.where(step % 2 == 0, 20000, 40000) * np.where(lane % 2 == 0, 1, -1)
        sym = np.where(edge.reshape(1, C, H, W), value.reshape(1, C, H, W), sym)
    return sym.astype(np.int32), (None if factorised else idx.astype(np.uint8))


def _rans_case(rd, rans_host, dev, host_table, table, shape, S, lanes, mix, rng, label,
               factorised=False):
    """One stream per image through R1 and R2 and through everything they
    are held against. Returns (sym, idx, packed words, base, counts) on the
    card for the timings."""
    import torch
    B, C, H, W = shape
    sc = C // S
    L = rd.section_lanes(sc * H * W, lanes)
    sym_np, idx_np = _rans_planes(rng, host_table, shape, mix, factorised, S, L)
    wide = mix in RANS_WIDE                 # +-40000 does not fit the model's int16 planes
    sym = torch.from_numpy(sym_np if wide else sym_np.astype(np.int16)).to(dev)
    idx = None if idx_np is None else torch.from_numpy(idx_np).to(dev)

    packed, offsets, counts, esc, big = rd.encode_pack(sym, idx, S, lanes, table)
    again = rd.encode_pack(sym, idx, S, lanes, table)
    torch.cuda.synchronize()
    rows = rd.channel_rows(B, C, H, W, dev) if idx is None else idx
    sections = [(rd.to_stream(sym[:, s * sc:(s + 1) * sc], L),
                 rd.to_stream(rows[:, s * sc:(s + 1) * sc], L)) for s in range(S)]
    vals, mask, p_esc, p_big = rd.encode_stream_plain(sections, table)
    p_packed, p_counts = rd.pack_streams_plain(vals, mask)
    if not (torch.equal(counts, p_counts) and torch.equal(esc, p_esc)
            and torch.equal(big, p_big)):
        raise AssertionError(f"{label}: R1 counts differ from the plain version")
    if not (torch.equal(again[2], counts) and all(
            torch.equal(again[0][int(o):int(o) + int(n)], packed[int(o):int(o) + int(n)])
            for o, n in zip(offsets, counts))):
        raise AssertionError(f"{label}: R1 is not repeatable")
    counts_np = counts.cpu().numpy()
    p_base = np.cumsum(counts_np) - counts_np
    words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
    if not torch.equal(words, p_packed[:words.numel()]):
        raise AssertionError(f"{label}: R1 bytes differ from the plain version")
    words_np = words.cpu().numpy().view(np.uint16)
    for b in range(B):
        secs = [(s[b].cpu().numpy(), i[b].cpu().numpy()) for s, i in sections]
        data, esc_max, has_t2 = rans_host.tpu_encode_sections(secs, host_table, True)
        if data != words_np[p_base[b]:p_base[b] + counts_np[b]].tobytes():
            raise AssertionError(f"{label}: R1 bytes differ from the host coder, image {b}")
        if esc_max != int(esc[b].max()) or has_t2 != bool(big[b] > 0):
            raise AssertionError(f"{label}: R1 escape counts differ from the host coder")
    if bool(esc.sum() > 0) != (mix != "no escapes") or bool(big.sum() > 0) != wide:
        raise AssertionError(f"{label}: the symbol mix is not what its name says")

    base = torch.from_numpy(p_base.astype(np.int32)).to(dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    runs = []
    for _ in range(2):
        cur, state, p_cur, p_state, outs = zero, None, zero, None, []
        for s in range(S):
            sec_idx = None if idx is None else idx[:, s * sc:(s + 1) * sc].contiguous()
            got, cur, state = rd.decode_section(words, base, cur, state, sec_idx,
                                                (B, sc, H, W), lanes, table,
                                                out_dtype=torch.int32)
            want, p_cur, p_state = rd.decode_section_plain(
                words, base, p_cur, p_state, sections[s][1], table)
            if not (torch.equal(got, rd.from_stream(want, sc, H, W))
                    and torch.equal(cur, p_cur) and torch.equal(state, p_state)):
                raise AssertionError(f"{label}: R2 differs from the plain version, section {s}")
            if not torch.equal(got, sym[:, s * sc:(s + 1) * sc].to(torch.int32)):
                raise AssertionError(f"{label}: R2 does not return the symbols, section {s}")
            outs.append(got)
        if not torch.equal(cur, counts) or not bool((state == rd.RANS_L).all()):
            raise AssertionError(f"{label}: the last section leaves words or lane states over")
        runs.append(outs)
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{label}: R2 is not repeatable")
    print(f"{label}: R1 bytes equal to plain and host coder ({int(counts.sum())} words, "
          f"{int(esc.sum())} escapes, {int(big.sum())} tier-2), R2 symbols, cursors and "
          f"states equal to plain over {S} sections, lanes back at 2^16; repeatable")
    return sym, idx, words, base, counts


def _rans_poison_cases(rd, Codec, dev, host_table, table):
    """A stream that breaks what the flag promises must fail the integrity
    check; without the flag the same stream passes it."""
    import torch
    B, C, H, W = 2, 32, 48, 32
    rng = np.random.default_rng(7)
    cases = {"escfree": ("tier-1 escapes", dict(escfree=True)),
             "t2free": ("tier-2 escapes", dict(tier2=False)),
             "esc_cap": (None, dict(sparse_esc=True))}
    for name, (mix, flags) in cases.items():
        if mix is None:
            sym_np, idx_np = _rans_planes(rng, host_table, (B, C, H, W), "no escapes", False)
            sym_np[1] = rng.integers(3000, 9000, sym_np[1].shape)    # every symbol escapes
        else:
            sym_np, idx_np = _rans_planes(rng, host_table, (B, C, H, W), mix, False)
        sym, idx = torch.from_numpy(sym_np).to(dev), torch.from_numpy(idx_np).to(dev)
        packed, offsets, counts, _, _ = rd.encode_pack(sym, idx, 1, 128, table)
        words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
        base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        strs = [b"\0\0" * int(n) for n in counts]
        _, cur, _ = rd.decode_section(words, base, zero, None, idx, (B, C, H, W), 128, table)
        Codec._check_consumed(torch.stack([cur, cur]).cpu().numpy(), strs, strs)
        _, cur, _ = rd.decode_section(words, base, zero, None, idx, (B, C, H, W), 128, table,
                                      **flags)
        try:
            Codec._check_consumed(torch.stack([cur, cur]).cpu().numpy(), strs, strs)
        except RuntimeError:
            continue
        raise AssertionError(f"R2 did not poison the cursor of a stream that breaks {name}")
    print("R2 poison: a stream with an escape under escfree, with a tier-2 marker under "
          "t2free, and with more escapes than esc_cap each fail the integrity check")


# Quantile half-width of the wide z table: 323 bins a channel, 61,824 over
# 192 channels, past the 45,056 that R2 copies into shared memory (the seed
# weights' z table has 23 bins a channel)
WIDE_Z_QUANTILE = 160


def _wide_z_table():
    """The host table of a factorised bottleneck of Z_PLANES' channels with
    seeded weights and quantiles WIDE_Z_QUANTILE either side of the median,
    as a trained model with a wide z could have."""
    import torch
    from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck, build_bottleneck_cdf
    from dc_vic_tpu_torch.models import init_weights
    eb = EntropyBottleneck(Z_PLANES[1])
    init_weights(eb, torch.Generator().manual_seed(2))
    with torch.no_grad():
        eb.quantiles[:, 0, 0] = eb.quantiles[:, 0, 1] - WIDE_Z_QUANTILE
        eb.quantiles[:, 0, 2] = eb.quantiles[:, 0, 1] + WIDE_Z_QUANTILE
    return build_bottleneck_cdf(eb)


def check_rans(rd, rans_host, Codec, dev):
    """R1 and R2 against their plain versions and the host coder (see the
    module docstring, item 5), also at the edges of their partitions
    (RANS_EDGE_CASES), then ``time_rans``. Returns the two kernel
    entries."""
    import torch
    from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck, build_bottleneck_cdf
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional, get_scale_table
    from dc_vic_tpu_torch.models import init_weights
    from dc_vic_tpu_torch.utils.profiling import graph_ms
    y_host = GaussianConditional().build_cdf_table(get_scale_table())
    eb = EntropyBottleneck(Z_PLANES[1])
    init_weights(eb, torch.Generator().manual_seed(1))
    z_host = build_bottleneck_cdf(eb)
    y_table, z_table = rd.DeviceCdfTable(y_host, dev), rd.DeviceCdfTable(z_host, dev)
    rng = np.random.default_rng(1)
    kept = {}
    for lanes in (128, 512):
        for mix in RANS_MIXES:
            kept[lanes, mix] = _rans_case(
                rd, rans_host, dev, y_host, y_table, Y_PLANES, 6, lanes, mix, rng,
                f"R1/R2 y {list(Y_PLANES)} six sections, lanes {lanes}, {mix}")
        kept[lanes, "z"] = _rans_case(
            rd, rans_host, dev, z_host, z_table, Z_PLANES, 1, lanes, "tier-1 escapes", rng,
            f"R1/R2 z {list(Z_PLANES)}, lanes {lanes}, tier-1 escapes", factorised=True)
    _rans_case(rd, rans_host, dev, y_host, y_table, (2, 12, 6, 8), 3, 4, "tier-1 escapes", rng,
               "R1/R2 a small stream, three sections, lanes 4, tier-1 escapes")
    _rans_case(rd, rans_host, dev, y_host, y_table, (1, 64, 96, 128), 1, 4096,
               "tier-1 escapes", rng, "R1/R2 one wide section, lanes 4096, tier-1 escapes")
    _rans_poison_cases(rd, Codec, dev, y_host, y_table)

    rng = np.random.default_rng(12)
    for shape, S, lanes, mix in RANS_EDGE_CASES:
        L = rd.section_lanes(shape[1] // S * shape[2] * shape[3], lanes)
        _rans_case(rd, rans_host, dev, y_host, y_table, shape, S, lanes, mix, rng,
                   f"R1/R2 at a partition edge: {list(shape)} in {S} section(s), lanes {L}, "
                   f"{mix}")
    wide_host = _wide_z_table()
    wide_table = rd.DeviceCdfTable(wide_host, dev)
    rng = np.random.default_rng(13)
    for lanes in (128, 512):
        wide = _rans_case(rd, rans_host, dev, wide_host, wide_table, Z_PLANES, 1, lanes,
                          "tier-1 escapes", rng, f"R1/R2 z {list(Z_PLANES)} on a table of "
                          f"{wide_table.pair_packed.numel()} bins (R2 reads it from global "
                          f"memory), lanes {lanes}, tier-1 escapes", factorised=True)
    # R2 on the z section at lanes 512, its pair table in shared memory (the
    # seed weights' table) and in global memory (the wide one); 36 steps, too
    # short for a Python loop of launches to time, so also by graph replay
    z_ms = []
    for table, (_, _, words, base, _) in ((z_table, kept[512, "z"]), (wide_table, wide)):
        zero = torch.zeros(Z_PLANES[0], dtype=torch.int32, device=dev)
        args = (words, base, zero, None, None, Z_PLANES, 512, table)
        z_ms.append((_time_ms(rd.decode_section, *args), graph_ms(rd.decode_section, *args)))
    print(f"R2 on the z section {list(Z_PLANES)}, lanes 512: {z_ms[0][0]:.4f} ms with the pair "
          f"table in shared memory ({z_table.pair_packed.numel()} bins), {z_ms[1][0]:.4f} ms from "
          f"global memory ({wide_table.pair_packed.numel()} bins); device time by graph replay "
          f"{z_ms[0][1]:.4f} ms and {z_ms[1][1]:.4f} ms")
    return time_rans(rd, y_host, y_table, kept, dev)


# Single-warp step latencies (batch 1, 32 lanes) of the earlier design of R1
# and R2, one block per image, measured on an NVIDIA H100 80GB HBM3 at
# 700 W: a fixed yardstick for the dependent chain, since a design that
# shortens its step also shortens the chain measured with its own step.
R1_STEP_FIXED_US = 0.50
R2_STEP_FIXED_US = 1.03
RANS_TIMED = ((4, 128), (4, 512), (16, 128), (16, 512))     # (batch, lane cap)
R1_PHASES = ("rans_encode_symbols_kernel", "rans_encode_states_kernel",
             "rans_encode_scan_kernel", "rans_encode_scatter_kernel")


def time_rans(rd, y_host, y_table, kept, dev):
    """R1 over the six-section y stream and R2 over its first section, at
    the batches and lane caps of RANS_TIMED, beside their dependent chains:
    the steps times the fixed single-warp step (R1_STEP_FIXED_US,
    R2_STEP_FIXED_US) and times this build's own single-warp step. R1's four
    launches are timed apart under torch.profiler; R2's time a step is held
    against its single-warp step. The plain versions at batch 4, lanes 128.
    Returns the two kernel entries (ms: batch 4, lanes 128)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dc_vic_tpu_torch.utils.profiling import kernel_times
    _, C, H, W = Y_PLANES
    S, sc = 6, C // 6
    n_sec = sc * H * W
    sym1, idx1 = (t[:1].contiguous() for t in kept[128, "no escapes"][:2])
    p1, _, c1, _, _ = rd.encode_pack(sym1, idx1, S, 32, y_table)
    z1 = torch.zeros(1, dtype=torch.int32, device=dev)
    r1_step = _time_ms(rd.encode_pack, sym1, idx1, S, 32, y_table) / (S * n_sec // 32)
    r2_step = _time_ms(rd.decode_section, p1[:int(c1[0])].contiguous(), z1, z1, None,
                       idx1[:, :sc].contiguous(), (1, sc, H, W), 32, y_table) / (n_sec // 32)
    print(f"one step of the chain with a single warp (batch 1, 32 lanes): R1 "
          f"{r1_step * 1e3:.3f} us, R2 {r2_step * 1e3:.3f} us; the fixed yardstick R1 "
          f"{R1_STEP_FIXED_US} us, R2 {R2_STEP_FIXED_US} us")
    s16, i16 = _rans_planes(np.random.default_rng(16), y_host, (16, C, H, W), "no escapes",
                            False)
    planes = {4: kept[128, "no escapes"][:2],
              16: (torch.from_numpy(s16.astype(np.int16)).to(dev), torch.from_numpy(i16).to(dev))}
    timed = {}
    for B, lanes in RANS_TIMED:
        sym, idx = planes[B]
        L = rd.section_lanes(n_sec, lanes)
        steps = n_sec // L
        packed, offsets, counts, _, _ = rd.encode_pack(sym, idx, S, lanes, y_table)
        words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
        base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        idx0 = idx[:, :sc].contiguous()

        def enc():
            return rd.encode_pack(sym, idx, S, lanes, y_table)

        def dec():
            return rd.decode_section(words, base, zero, None, idx0, (B, sc, H, W), lanes, y_table)
        t = {"batch": B, "lanes": L, "steps": steps, "words": int(counts.sum()),
             "r1": _time_ms(enc, reps=20), "r2": _time_ms(dec, reps=20)}
        enc()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                enc()
            torch.cuda.synchronize()
        times = kernel_times(prof)
        t["r1_phases"] = {ph: sum(us for k, (us, _) in times.items() if ph in k) / 1e4
                          for ph in R1_PHASES}
        if (B, lanes) == (4, 128):
            sections = [(rd.to_stream(sym[:, s * sc:(s + 1) * sc], L),
                         rd.to_stream(idx[:, s * sc:(s + 1) * sc], L)) for s in range(S)]
            t["r1_plain"] = _time_ms(lambda: rd.pack_streams_plain(
                *rd.encode_stream_plain(sections, y_table)[:2]), reps=1)
            t["r2_plain"] = _time_ms(rd.decode_section_plain, words, base, zero, None,
                                     sections[0][1], y_table, reps=1)
        t["r1_chain"] = S * steps * r1_step
        t["r2_chain"] = steps * r2_step
        timed[B, lanes] = t
        r1_fixed = S * steps * R1_STEP_FIXED_US / 1e3     # printed only: not measured here
        r2_fixed = steps * R2_STEP_FIXED_US / 1e3
        ph = ", ".join(f"{k[len('rans_encode_'):-len('_kernel')]} {v:.4f}"
                       for k, v in t["r1_phases"].items())
        print(f"R1 rans_encode_pack y [{B}, {C}, {H}, {W}] six sections, lanes {L} "
              f"({S * steps} steps): kernel {t['r1']:.4f} ms (launches by device time: {ph} "
              f"ms); chain {r1_fixed:.4f} ms at the fixed step "
              f"({r1_fixed / t['r1']:.0%} of the kernel), {t['r1_chain']:.4f} ms at "
              f"its own ({t['r1_chain'] / t['r1']:.0%})")
        print(f"R2 rans_decode_section one section [{B}, {sc}, {H}, {W}], lanes {L} ({steps} "
              f"steps): kernel {t['r2']:.4f} ms, {t['r2'] / steps * 1e3:.3f} us a step against "
              f"{r2_step * 1e3:.3f} us with a single warp; chain {r2_fixed:.4f} ms at "
              f"the fixed step ({r2_fixed / t['r2']:.0%} of the kernel), "
              f"{t['r2_chain']:.4f} ms at its own ({t['r2_chain'] / t['r2']:.0%})")
    t = timed[4, 128]
    print(f"plain versions at batch 4, lanes 128: R1 {t['r1_plain']:.1f} ms, R2 "
          f"{t['r2_plain']:.1f} ms")
    n_sym = Y_PLANES[0] * C * H * W
    rows = [{k: v for k, v in row.items() if k not in ("r1_plain", "r2_plain")}
            for row in timed.values()]
    # bytes: each symbol (2) and index (1) read once, each word written (R1)
    # or read (R2) once, R2's symbols written; operations: about 12 integer
    # operations a symbol, held against the f32 rate outside the tensor cores
    common = {"route": "cuda", "source": "dc_vic_tpu_torch/csrc/rans_device.cu",
              "max_abs_err": 0.0, "library_ms": None, "timed": rows}
    r1 = {"name": "rans_encode_pack", "replaces": "dc_vic_tpu/ops/rans_device.py:222",
          "ms": t["r1"], "plain_ms": t["r1_plain"],
          **bounds(3 * n_sym + 2 * t["words"], 12 * n_sym), "chain_ms": t["r1_chain"],
          "step_us": r1_step * 1e3,
          "ms_lanes512": timed[4, 512]["r1"], **common}
    r2 = {"name": "rans_decode_section", "replaces": "dc_vic_tpu/ops/rans_device.py:366",
          "ms": t["r2"], "plain_ms": t["r2_plain"],
          **bounds((3 * n_sym + 2 * t["words"]) // S, 12 * n_sym // S),
          "chain_ms": t["r2_chain"], "step_us": r2_step * 1e3, "ms_lanes512": timed[4, 512]["r2"], **common}
    return r1, r2


BF16_PLANE = (4, 128, 768, 512)     # the largest plane of the path; 128 output channels


def check_bf16_kernels(gn, conv3x3, dev, gen):
    """K3 to K6 in bf16 at the path's largest plane against their plain
    versions: K3 within 1e-5 of sum|x| and sum x^2 against float64 (f32
    sums of bf16 values), K4, K5 and K6 atol = rtol = 1e-2 (one step of the
    output type: K5's and K6's plain versions, like the kernels, round an f32
    sum once), whole tensor and border; each twice: equal bits. The bf16
    kernels' weight repack equals its plain version bit for bit. Times, bf16
    bounds, and the library calls in bf16; K6 also beside its unfused route
    (K4's apply with swish, then F.conv2d bf16 with the conv bias, then the
    residual add). Returns the four entries."""
    import torch
    import torch.nn.functional as F
    B, C, H, W = BF16_PLANE
    Cout = C
    bf = torch.bfloat16
    x = (torch.randn(B, C, H, W, generator=gen, device=dev) * 2 + 0.5).to(bf)
    scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
    bias = torch.randn(B, C, generator=gen, device=dev)
    label = f"{list(BF16_PLANE)} bfloat16"

    sums, plain = gn.channel_sums(x), gn.channel_sums_plain(x)
    want = torch.empty(B, 2, C, dtype=torch.float64, device=dev)
    ref_scale = torch.empty_like(want)
    for b in range(B):
        xd = x[b].double().flatten(1)
        sq = (xd * xd).sum(-1)
        want[b, 0], want[b, 1] = xd.sum(-1), sq
        ref_scale[b, 0], ref_scale[b, 1] = xd.abs().sum(-1), sq
        del xd
    rel = float(((sums.double() - want).abs() / ref_scale).max())
    if not rel <= 1e-5 or not torch.equal(sums, gn.channel_sums(x)):
        raise AssertionError(f"gn_channel_sums bf16: {rel:.2e} of the scale off float64, "
                             f"or not repeatable, at {label}")
    err3 = float((sums - plain).abs().max())
    print(f"K3 gn_channel_sums {label}: {rel:.2e} of sum|x| / sum x^2 off float64; max abs "
          f"diff to plain {err3:.3e}; repeatable")
    err4 = 0.0
    for act in (None, "swish"):
        got, ref = gn.apply_affine(x, scale, bias, act), gn.apply_affine_plain(x, scale, bias, act)
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)
        if not torch.equal(got, gn.apply_affine(x, scale, bias, act)):
            raise AssertionError(f"gn_apply bf16 is not repeatable at {label}")
        err4 = max(err4, float((got.float() - ref.float()).abs().max()))
        del got, ref
    print(f"K4 gn_apply {label}: max abs err {err4:.3e} (act none and swish, tolerance "
          f"0.01); repeatable")
    n = x.numel()
    b3, _ = bound(_nbytes(x, sums), 3 * n)
    b4, _ = bound(2 * _nbytes(x) + _nbytes(scale, bias), 6 * n)
    common = {"route": "cuda", "library_ms": None, "dtype": "bfloat16",
              "shape": list(BF16_PLANE)}
    k3 = {"name": "gn_channel_sums_bf16", "source": "dc_vic_tpu_torch/csrc/gn.cu",
          "replaces": "dc_vic_tpu/ops/gn.py:52", "max_abs_err": err3,
          "ms": _time_ms(gn.channel_sums, x), "plain_ms": _time_ms(gn.channel_sums_plain, x),
          "bound_ms": b3, "bound_by": "bytes", **common}
    k4 = {"name": "gn_apply_bf16", "source": "dc_vic_tpu_torch/csrc/gn.cu",
          "replaces": "dc_vic_tpu/ops/gn.py:117", "max_abs_err": err4,
          "ms": _time_ms(gn.apply_affine, x, scale, bias, "swish"),
          "plain_ms": _time_ms(gn.apply_affine_plain, x, scale, bias, "swish"),
          "bound_ms": b4, "bound_by": "bytes", **common}
    gamma = torch.rand(C, generator=gen, device=dev) + 0.5
    beta = torch.randn(C, generator=gen, device=dev) * 0.1
    # 0.05 apart at most: the library rounds to bf16 twice
    pairs = group_norm_pairs(gn, x, gamma, beta, 5e-2)
    k3.update(pairs)
    k4.update(pairs)

    x = torch.randn(B, C, H, W, generator=gen, device=dev).to(bf)
    w = (torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05).to(bf)
    bias = torch.randn(B, C, generator=gen, device=dev) + 2.0
    cbias = torch.randn(Cout, generator=gen, device=dev)
    res = torch.randn(B, Cout, H, W, generator=gen, device=dev).to(bf)
    if not torch.equal(conv3x3.repack_weights_bf16(w), conv3x3.repack_weights_bf16_plain(w)):
        raise AssertionError(f"the bf16 weight repack differs from its plain version at "
                             f"{list(w.shape)}")
    print(f"bf16 weight repack {list(w.shape)}: equal to its plain version bit for bit")
    cases = [("K5 conv3x3_same", lambda: conv3x3.conv3x3_same(x, w),
              lambda: conv3x3.conv3x3_same_plain(x, w)),
             ("K6 conv3x3_gn_swish +res", lambda: conv3x3.conv3x3_gn_swish(
                 x, w, scale, bias, cbias, res),
              lambda: conv3x3.conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res))]
    out = []
    for name, kernel, plain_fn in cases:
        got, ref = kernel(), plain_fn()
        torch.testing.assert_close(_border(got), _border(ref), atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(got, ref, atol=1e-2, rtol=1e-2)
        if not torch.equal(got, kernel()):
            raise AssertionError(f"{name} bf16 is not repeatable at {label}")
        err = float((got.float() - ref.float()).abs().max())
        del got, ref
        ms, plain_ms = _time_ms(kernel, reps=5), _time_ms(plain_fn, reps=5)
        print(f"{name} {label}->{Cout}: max abs err {err:.3e} (tolerance 0.01, whole and "
              f"border); repeatable; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        out.append((err, ms, plain_ms))
    flops = 2 * 9 * C * Cout * B * H * W
    b5, by5 = bound(_nbytes(x, w) + _nbytes(res), flops, BF16_FLOPS_PER_S)
    b6, by6 = bound(_nbytes(x, w, scale, bias, cbias, res) + _nbytes(res),
                    flops + 6 * x.numel() + 2 * res.numel(), BF16_FLOPS_PER_S)
    k5 = {"name": "conv3x3_same_bf16", "source": "dc_vic_tpu_torch/csrc/conv3x3_bf16.cu",
          "replaces": "dc_vic_tpu/ops/conv3x3.py:59", "max_abs_err": out[0][0],
          "ms": out[0][1], "plain_ms": out[0][2], "bound_ms": b5, "bound_by": by5,
          **common, "library_ms": _time_ms(lambda: F.conv2d(x, w, padding=1), reps=5)}
    k6 = {"name": "conv3x3_gn_swish_bf16", "source": "dc_vic_tpu_torch/csrc/conv3x3_bf16.cu",
          "replaces": "dc_vic_tpu/ops/conv3x3.py:220", "max_abs_err": out[1][0],
          "ms": out[1][1], "plain_ms": out[1][2], "bound_ms": b6, "bound_by": by6, **common,
          "unfused_ms": _time_ms(_unfused_k6(gn, x, w, scale, bias, cbias, res), reps=5)}
    for k in (k3, k4, k5, k6):
        unfused = f", unfused route {k['unfused_ms']:.3f} ms" if "unfused_ms" in k else ""
        print(f"{k['name']} at {label}: kernel {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.3f} ms ({k['bound_by']}), library {k['library_ms']}"
              f"{unfused}")
    return k3, k4, k5, k6


def _unfused_k6(gn, x, w, scale, bias, cbias, res):
    """K6's function as the unfused route computes it: K4's apply with
    swish, F.conv2d with the conv bias, then the residual add, in x's type."""
    import torch.nn.functional as F

    def run():
        y = F.conv2d(gn.apply_affine(x, scale, bias, "swish"), w, cbias.to(x.dtype), padding=1)
        return y if res is None else y + res
    return run


def _held_per_image(got, plain_one, tol, what):
    """``got`` [B, ...] of one launch over the whole batch against
    ``plain_one(b)`` [1, ...], the plain version of image b alone, whole and
    border, atol = rtol = ``tol``. Returns the largest absolute error."""
    import torch
    worst = 0.0
    for b in range(got.shape[0]):
        ref = plain_one(b)[0]
        try:
            torch.testing.assert_close(_border(got[b]), _border(ref), atol=tol, rtol=tol)
            torch.testing.assert_close(got[b], ref, atol=tol, rtol=tol)
        except AssertionError as e:
            raise AssertionError(f"{what}, image {b} of the batch: {e}") from None
        worst = max(worst, float((got[b].float() - ref.float()).abs().max()))
    return worst


def _repeatable(kernel, first, what):
    import torch
    if not torch.equal(first, kernel()):
        raise AssertionError(f"{what} is not repeatable")


# (K4, K5 and K6) tolerances of a kernel against its plain version, by dtype:
# one step of bf16 (kernel and plain version each round an f32 value once);
# in f32 the affine's last place and another summation order of three TF32
# products per product
PATH_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-6, 1e-4)}


def check_path_shapes(gn, conv3x3, shapes, dev, gen, dtype_name="bfloat16"):
    """K3 to K6 in ``dtype_name`` at every distinct shape a round trip
    launched them with (``shapes`` as expected_launch_recorder tallied them:
    the deployment configuration's batch 16, or the tiles of an image over
    1024 px). The kernel takes the whole batch in one launch; its plain
    version takes one image at a time, so the reference never forms a batch
    offset and an index that wraps beyond the first images (a [16, 256, 768,
    512] plane has 1.6 G elements) shows as a mismatch in the later ones.
    Tolerances: K3 1e-5 of sum|x| and sum x^2 against float64, K4 and K5/K6
    (with and without the residual) PATH_TOL, whole and border; each launch
    twice: equal bits. In bf16 K5 and K6 (without the residual) are also
    timed at each shape beside their bf16 bound, F.conv2d bf16 of the same
    shape and, for K6, its unfused route (K4's apply, then F.conv2d with the
    conv bias); the rows are returned."""
    import torch
    import torch.nn.functional as F
    dtype = getattr(torch, dtype_name)
    rows = []
    tol4, tol_conv = PATH_TOL[dtype_name]
    for (B, C, H, W), count in sorted(shapes["gn"].items()):
        label = f"[{B},{C},{H},{W}] {dtype_name} ({count} launches per round trip)"
        x = torch.randn(B, C, H, W, generator=gen, device=dev, dtype=dtype) * 2 + 0.5
        scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
        bias = torch.randn(B, C, generator=gen, device=dev)
        sums = gn.channel_sums(x)
        rel = 0.0
        for b in range(B):
            xd = x[b].double().flatten(1)
            sq = (xd * xd).sum(-1)
            off = torch.stack([(sums[b, 0].double() - xd.sum(-1)).abs() / xd.abs().sum(-1),
                               (sums[b, 1].double() - sq).abs() / sq])
            rel = max(rel, float(off.max()))
            del xd, sq
        if not rel <= 1e-5:
            raise AssertionError(f"gn_channel_sums off float64 by {rel:.2e} of the scale "
                                 f"at {label}")
        _repeatable(lambda: gn.channel_sums(x), sums, f"gn_channel_sums at {label}")
        got = gn.apply_affine(x, scale, bias, "swish")
        err4 = _held_per_image(got, lambda b: gn.apply_affine_plain(
            x[b:b + 1], scale[b:b + 1], bias[b:b + 1], "swish"), tol4, f"gn_apply at {label}")
        _repeatable(lambda: gn.apply_affine(x, scale, bias, "swish"), got,
                    f"gn_apply at {label}")
        print(f"K3, K4 at {label}: sums {rel:.2e} of the scale off float64; apply max abs "
              f"err {err4:.3e} to plain (tolerance {tol4:g}); every image; repeatable")
        del x, got, sums
    for name in ("conv3x3_same", "conv3x3_gn_swish"):
        for (B, C, Cout, H, W), count in sorted(shapes[name].items()):
            label = f"[{B},{C},{H},{W}]->{Cout} {dtype_name} ({count} launches per round trip)"
            x = torch.randn(B, C, H, W, generator=gen, device=dev, dtype=dtype)
            w = (torch.randn(Cout, C, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
            if name == "conv3x3_same":
                scale = bias = cbias = None
                cases = [("K5 conv3x3_same", lambda: conv3x3.conv3x3_same(x, w),
                          lambda b: conv3x3.conv3x3_same_plain(x[b:b + 1], w))]
            else:
                scale = torch.rand(B, C, generator=gen, device=dev) * 1.5 + 0.5
                bias = torch.randn(B, C, generator=gen, device=dev) + 2.0
                cbias = torch.randn(Cout, generator=gen, device=dev)
                res = torch.randn(B, Cout, H, W, generator=gen, device=dev, dtype=dtype)
                cases = [(f"K6 conv3x3_gn_swish{'' if r is None else ' +res'}",
                          lambda r=r: conv3x3.conv3x3_gn_swish(x, w, scale, bias, cbias, r),
                          lambda b, r=r: conv3x3.conv3x3_gn_swish_plain(
                              x[b:b + 1], w, scale[b:b + 1], bias[b:b + 1], cbias,
                              None if r is None else r[b:b + 1]))
                         for r in (None, res)]
            for what, kernel, plain_one in cases:
                got = kernel()
                err = _held_per_image(got, plain_one, tol_conv, f"{what} at {label}")
                _repeatable(kernel, got, f"{what} at {label}")
                print(f"{what} at {label}: max abs err {err:.3e} to plain (atol = rtol = "
                      f"{tol_conv:g}, whole and border, every image); repeatable")
                del got
            if dtype == torch.bfloat16:
                rows.append(_time_path_shape(gn, name, cases[0][1], x, w, scale, bias, cbias,
                                             label))
            del x, w, cases
            scale = bias = cbias = res = None
            torch.cuda.empty_cache()
    return rows


def _time_path_shape(gn, name, kernel, x, w, scale, bias, cbias, label):
    """One bf16 K5 or K6 (no residual) launch shape of the path: the
    kernel's time, its bound, F.conv2d bf16 and, for K6, the unfused route."""
    import torch.nn.functional as F
    B, C, H, W = x.shape
    Cout = w.shape[0]
    flops = 2 * 9 * C * Cout * B * H * W
    nbytes = _nbytes(x, w) + B * Cout * H * W * x.element_size()
    if name == "conv3x3_gn_swish":
        nbytes += _nbytes(scale, bias, cbias)
        flops += 6 * x.numel() + B * Cout * H * W
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    row = {"name": f"{name}_bf16", "shape": [B, C, Cout, H, W], "ms": _time_ms(kernel, reps=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": _time_ms(lambda: F.conv2d(x, w, padding=1), reps=3)}
    line = (f"{name} bf16 at {label}: kernel {row['ms']:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}, {bound_ms / row['ms']:.0%} of it), F.conv2d bf16 "
            f"{row['library_ms']:.3f} ms")
    if name == "conv3x3_gn_swish":
        row["unfused_ms"] = _time_ms(_unfused_k6(gn, x, w, scale, bias, cbias, None), reps=3)
        line += f", unfused route (K4 apply + F.conv2d) {row['unfused_ms']:.3f} ms"
    print(line)
    return row


def pipelined_cycle(codec, images, n_batches=3):
    """The serving loop: per cycle k dispatch batch k + 1's encode, fetch
    batch k - 1's decoded images, finalize batch k's streams and dispatch its
    decode with the fetch deferred. Returns the cycles' seconds (the drain of
    the last fetch folded into the last) and checks every decoded batch
    against a plain round trip of the same images."""
    import torch
    batches = [np.ascontiguousarray(np.roll(images, i, axis=0)) for i in range(n_batches)]
    want = [codec.decompress([r["string_list"] for r in codec.compress(b, 0)])
            for b in batches]
    torch.cuda.synchronize()
    handle = codec.compress_dispatch(batches[0], 0)
    pending, outs, cycles = None, [], []
    for k in range(n_batches):
        t0 = time.perf_counter()
        nxt = codec.compress_dispatch(batches[k + 1], 0) if k + 1 < n_batches else None
        if pending is not None:
            outs.append(pending.fetch())
        res = codec.compress_finalize(handle)
        pending = codec.decompress([r["string_list"] for r in res], defer_fetch=True)
        handle = nxt
        cycles.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs.append(pending.fetch())
    cycles[-1] += time.perf_counter() - t0
    for k in range(n_batches):
        if not np.array_equal(outs[k], want[k]):
            raise AssertionError(f"the pipelined cycle decoded batch {k} to other pixels than "
                                 f"a plain round trip of the same images")
    return cycles


def entropy_chain_ms(codec, images):
    """The entropy-parameter chain of one encode (hyper_decode, slice
    parameters, six decode steps, batch as given) with the module's
    entropy_precision as built and with "high", on the same y and z symbols:
    (ms as built, ms with "high")."""
    import torch
    m = codec.module
    x = torch.from_numpy(np.ascontiguousarray(images)).to(codec.device)
    with torch.no_grad():
        y, z_sym = m.encode_front(x.permute(0, 3, 1, 2), *codec._betas(0))
        built = m.entropy_precision
        out = []
        for precision in (built, "high"):
            m.entropy_precision = precision
            out.append(_time_ms(codec._encode_param_chain, y, z_sym, reps=5))
        m.entropy_precision = built
    return tuple(out)


def check_portable(spec, fresh_spec, plain_codec, plain_strings, images, parts16, ref):
    """Portable streams of the deployment configuration (module docstring,
    item 10). ``fresh_spec``: a second model built from the same weights,
    for the decoder that never saw the encoder. ``plain_codec`` /
    ``plain_strings``: the non-portable codec of ``spec`` and its batch-16
    streams. ``parts16``, ``ref``: what bf16_against_f32 returned for
    ``spec``'s model."""
    import torch
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.tools.workload import DEPLOYMENT
    B, H, W = images.shape[:3]
    codec = Codec(spec, encode_backend="device", lanes=DEPLOYMENT["lanes"], portable=True)
    res = codec.compress(images, 0, debug=True)
    strings = [r["string_list"] for r in res]
    hdr = HeaderHandler.decode(strings[0][0])
    if not (hdr["portable"] and hdr["bf16"] and hdr["fast_entropy"]
            and hdr["lanes"] == DEPLOYMENT["lanes"] and hdr["encode_batch"] == B):
        raise AssertionError(f"portable header {hdr}")
    fresh = Codec(fresh_spec, lanes=128)     # built non-portable: the header decides
    whole = codec.decompress(strings)
    if not np.array_equal(fresh.decompress(strings), whole):
        raise AssertionError("another codec decoded the same batch to other pixels")
    differing = {}
    for name, size in (("16", B), ("4 x 4", 4), ("16 x 1", 1)):
        for dec in (codec, fresh):
            for lo in range(0, B, size):
                if not dec.verify_roundtrip(res[lo:lo + size], strings[lo:lo + size], (H, W)):
                    raise AssertionError(f"portable stream decoded as {name}: latents differ "
                                         f"from the encoder's (images {lo}..{lo + size - 1})")
        parts = np.concatenate([codec.decompress(strings[lo:lo + size])
                                for lo in range(0, B, size)])
        diff = np.abs(parts.astype(np.int16) - whole.astype(np.int16))
        differing[name] = (float((diff > 1).mean()), float(diff.mean()))
    if differing["16"] != (0.0, 0.0):
        raise AssertionError("decoding the same batch twice gave other pixels")
    # where the groupings' pixels part: the VQ estimator, in the batch of 16
    # and alone, on the same y_hat. With the batch's estimator indices fed to
    # the batch-1 reconstruction, what is left is rounding: for the first, a
    # middle and the last image it must be within BF16_NOISE_RATIO of the
    # batch-16 reconstruction's distance to the f32 model's
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2))).to(codec.device)
    b1, b2 = codec._betas(0)
    logits16, idx16, img16 = parts16
    flips = gap = spread = 0.0
    fed = []
    with torch.no_grad():
        for b in (0, B // 2, B - 1):
            one = slice(b, b + 1)
            logits1, idx1, img1 = recon_parts(codec.module, y_hat[one].clone(), b1, b2,
                                              indices=idx16[one].clone())
            flips = max(flips, float((idx16[one] != idx1).float().mean()))
            gap = max(gap, float((logits16[one].float() - logits1.float()).abs().max()))
            spread = float(logits1.float().std())
            fed.append((b, float(_per_image_mean(img1, ref[one])),
                        float(_per_image_mean(img16[one], ref[one])),
                        float(_per_image_mean(img1, img16[one])) * 127.5))
    del y_hat, logits1, img1
    for b, e1, e16, _ in fed:
        if not e1 <= BF16_NOISE_RATIO * e16:
            raise AssertionError(f"image {b} reconstructed alone with the batch-16 codeword "
                                 f"indices is {e1:.5f} from the f32 model's, the batch-16 "
                                 f"reconstruction {e16:.5f}: more than rounding explains")
    print(f"portable, batch {B} lanes {DEPLOYMENT['lanes']}: header {hdr}; decoded as 16, 4 x 4 "
          f"and 16 x 1 by the encoding codec and by another one: y_hat and z_hat equal the "
          f"encoder's bitwise in every grouping, and the same grouping gives the same pixels. "
          f"Pixels against the batch-16 decode (share over one step apart, mean steps apart): "
          + "; ".join(f"{k}: {a:.4f}, {b:.3f}" for k, (a, b) in differing.items())
          + " (the reconstruction is not part of the guarantee: it runs at the decode batch, "
            "another batch picks other bf16 kernels, and with random weights the estimator's "
            "argmax turns such differences into other codewords: for images 0, "
            f"{B // 2} and {B - 1} the estimator's logits differ by at most {gap:.3e} between "
            f"batch 16 and batch 1, against a spread of {spread:.3e}, and up to {flips:.4f} of "
            f"an image's indices differ; with the batch-16 indices fed to the batch-1 "
            f"reconstruction, (image, its mean distance to the f32 model's reconstruction "
            f"on the [-1, 1] scale, the batch-16 reconstruction's, mean uint8 steps between "
            f"the two): {[(b, round(a, 5), round(c, 5), round(d, 3)) for b, a, c, d in fed]}, "
            f"ratio allowed {BF16_NOISE_RATIO:g})")
    try:
        plain_codec.decompress(plain_strings[:4])
    except ValueError as e:
        print(f"a non-portable batch-16 stream decoded as batch 4 raises: {str(e)[:80]}...")
    else:
        raise AssertionError("a non-portable batch-16 stream decoded as batch 4 did not raise")
    try:
        codec.decompress([strings[0], plain_strings[1]])
    except ValueError as e:
        print(f"a portable and a non-portable stream in one batch raise: {str(e)[:60]}...")
    else:
        raise AssertionError("mixed portable and non-portable streams did not raise")
    calls = []
    with sync_free_decode(codec, calls):
        again = codec.decompress(strings)
    if [c.get("portable") for c in calls] != [True] or not np.array_equal(again, whole):
        raise AssertionError("the portable decode chain did not run, or is not repeatable")
    print("portable: the decode chain (16 per-image parameter chains, 7 batched section "
          "decodes) ran with torch.cuda.set_sync_debug_mode('error') and gave the same pixels")
    return codec, float(np.mean([r["bpp"] for r in res]))


@contextlib.contextmanager
def sync_free_decode(codec, calls=None):
    """Inside the block the codec's tpu-format decode chain runs under
    torch.cuda.set_sync_debug_mode("error"), where PyTorch raises on any
    synchronising call; ``calls`` collects each chain's keyword arguments."""
    import torch
    pipeline = codec._decode_pipeline

    def no_sync(*args, **kwargs):
        if calls is not None:
            calls.append(kwargs)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return pipeline(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    codec._decode_pipeline = no_sync
    try:
        yield
    finally:
        codec._decode_pipeline = pipeline


def decompress_at(codec, strings, betas):
    """Codec.decompress at given betas instead of the header's quality (a
    model whose config selects no beta pairs): the header's stream fields,
    then decompress_raw."""
    hdr = codec._parse(strings)
    tpu = hdr["stream_format"] == "tpu"
    return codec.decompress_raw(
        [s[1] for s in strings], [s[2] for s in strings], hdr["img_size"], *betas,
        stream_format=hdr["stream_format"], lanes=hdr["lanes"],
        esc_dense=tpu and hdr["esc_dense"], portable=bool(hdr["portable"]),
        t2free=tpu and hdr["t2free"], escfree=tpu and hdr["escfree"])


def drive(codec, images, betas=None):
    """The main path: compress -> bitstreams -> decompress, at quality 0 or
    at ``betas`` (beta_rate, beta_vq). Returns (results, decoded images,
    encode s, decode s)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if betas is None:
        res = codec.compress(images, 0, debug=True)
    else:
        res = codec.compress(images, beta_rate=betas[0], beta_vq=betas[1], debug=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    strings = [r["string_list"] for r in res]
    out = codec.decompress(strings) if betas is None else decompress_at(codec, strings, betas)
    torch.cuda.synchronize()
    return res, out, t1 - t0, time.perf_counter() - t1


def verify(codec, images, res, out, enc_s, dec_s, label, betas=None):
    """The decoder's y_hat equals the encoder's bitwise, and the decoded
    images are the reconstruction of the encoder's y_hat (at quality 0's
    betas, or at ``betas``). Returns y_hat on the device."""
    import torch
    B, H, W = images.shape[:3]
    if out.shape != (B, H, W, 3) or out.dtype != np.uint8:
        raise AssertionError(f"{label}: decoded {out.shape} {out.dtype}")
    y_hat = np.stack([r["y_hat"] for r in res])
    if not np.isfinite(y_hat).all():
        raise AssertionError(f"{label}: non-finite y_hat")
    if not codec.verify_roundtrip(res, [r["string_list"] for r in res], (H, W)):
        raise AssertionError(f"{label}: decode-side y_hat differs from the encoder's")
    y_hat = torch.from_numpy(np.ascontiguousarray(y_hat.transpose(0, 3, 1, 2))).to(codec.device)
    b1, b2 = codec._betas(0) if betas is None else codec._beta_tensors(*betas)
    with torch.no_grad():
        recon = codec.module.reconstruct_uint8(y_hat, b1, b2)
        recon = recon[:, :, :H, :W].permute(0, 2, 3, 1).cpu().numpy()
    if not np.array_equal(out, recon):
        raise AssertionError(f"{label}: decoded images differ from reconstruct_uint8(y_hat)")
    bpp = float(np.mean([r["bpp"] for r in res]))
    print(f"{label}: y_hat round trip bit-exact, decoded images equal "
          f"reconstruct_uint8(y_hat), {bpp:.4f} bpp, encode {enc_s:.3f} s, "
          f"decode {dec_s:.3f} s")
    return y_hat


def expected_launch_recorder(module):
    """Forward hooks that apply the shape rules to the shapes the modules
    are really called with: the launches the rules give for this run,
    counted apart from the wrappers' own counters. A module inside a block
    that took the fused route is never called, so it counts nothing."""
    import torch
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock, VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import Conv2d, GroupNorm
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn, vq
    want = {"vq_argmin": 0, "flash_attention": 0, "gn_channel_sums": 0, "gn_apply": 0,
            "conv3x3_same": 0, "conv3x3_gn_swish": 0}
    # (B, C, Cout, H, W) -> launches of the two conv kernels, (B, C, H, W) ->
    # launches of the GroupNorm pair
    shapes = {"conv3x3_same": {}, "conv3x3_gn_swish": {}, "gn": {}}

    def tally(kernel, key):
        shapes[kernel][key] = shapes[kernel].get(key, 0) + 1

    def hook(m, args):
        shape = tuple(args[0].shape)
        if isinstance(m, VQAttnBlock):                 # f32 tokens whatever the conv dtype
            B, C, H, W = shape
            want["flash_attention"] += attention.use_kernel((B, H * W, C), torch.float32)
        elif isinstance(m, GroupNorm):
            if m.recon_kernel and gn.use_kernel(shape):
                want["gn_channel_sums"] += 1
                want["gn_apply"] += 1
                tally("gn", shape)
        elif isinstance(m, Conv2d):
            B, C, H, W = shape
            if (m.recon_kernel and m.kernel_size == (3, 3) and m.stride == (1, 1)
                    and conv3x3.use_kernel(B, C, m.out_channels, H, W)):
                want["conv3x3_same"] += 1
                tally("conv3x3_same", (B, C, m.out_channels, H, W))
        elif isinstance(m, VQResnetBlock):
            B, C, H, W = shape
            if m.fused and conv3x3.use_kernel(B, C, m.conv1.out_channels, H, W):
                want["conv3x3_gn_swish"] += 2
                Cout = m.conv1.out_channels
                tally("conv3x3_gn_swish", (B, C, Cout, H, W))       # conv1
                tally("conv3x3_gn_swish", (B, Cout, Cout, H, W))    # conv2
        else:                                          # the quantizer, on an f32 latent
            N, D = m.embedding.weight.shape
            want["vq_argmin"] += vq.use_kernel(D, N, torch.float32)

    kinds = (VQAttnBlock, GroupNorm, Conv2d, VQResnetBlock)
    handles = [m.register_forward_pre_hook(hook) for m in module.modules()
               if isinstance(m, kinds) or m is module.vq_model.quantize]
    return want, shapes, handles


def counted_round_trip(codec, images, label, betas=None, sync_free=False):
    """The main path (at quality 0, or at ``betas``) with every launch
    counter set to 0 just before it and read just after, held against what
    the shape rules give for the modules that ran in between; then the
    checks of what came out. ``sync_free``: the tpu decode chain runs under
    ``sync_free_decode``. Returns (y_hat, launches, the conv kernels' launch
    shapes)."""
    from dc_vic_tpu_torch.ops import counts
    want, shapes, handles = expected_launch_recorder(codec.module)
    # the coder kernels: y and z pack per compress on the device backend, z
    # and one section per ChARM slice (one without ChARM) per decompress
    tpu = codec.stream_format == "tpu"
    want["rans_encode_pack"] = 2 if tpu and codec.encode_backend == "device" else 0
    want["rans_decode_section"] = 1 + codec.y_sections if tpu else 0
    counts.reset()
    with sync_free_decode(codec) if sync_free else contextlib.nullcontext():
        res, out, enc_s, dec_s = drive(codec, images, betas)
    launches = counts.launches()
    for h in handles:
        h.remove()
    print(f"{label}: launches {launches}")
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, the shape rules "
                             f"give {want}")
    return verify(codec, images, res, out, enc_s, dec_s, label, betas), launches, shapes


def recon_parts(module, y_hat, b1, b2, indices=None):
    """decode_from_y_hat step by step: (logits, indices, image in [-1, 1]).
    With ``indices`` given, the VQGAN decoder is fed those instead of the
    estimator's own argmax."""
    feat, cond = module.decoder.get_feats(y_hat, b1, b2)
    _, logits = module.vq_estimator(feat)
    own = logits.argmax(1)
    idx = own if indices is None else indices
    latent = module.vq_model.post_quant_conv(module.vq_model.quantize.lookup(idx))
    image = module.vq_model.decoder(latent, module.fusion_module.fusion_modules, cond,
                                    1.0).float()
    if module.convert_img_range_to_01:
        image = image * 2.0 - 1.0
    return logits, own, image


RECON_TOL = 1e-3   # [-1, 1] scale; about a tenth of one uint8 step (2 / 255)


def compare_models(default, recon, images, y_hat):
    """The model with the reconstruction kernels on against the default
    model, same weights, same inputs. Decode side: the float reconstruction
    of the same y_hat, with the VQGAN decoder of both fed the default
    model's estimator indices (an argmax that flips on a near-tie would
    swap a codeword and say nothing about the kernels; flips are counted
    and printed). Encode side: how many VQ indices differ (printed only)."""
    import torch
    from dc_vic_tpu_torch.models.dc_vic import to_model_range
    compare_recon(default, recon, y_hat)
    with torch.no_grad():
        x = to_model_range(torch.from_numpy(images).to(default.device).permute(0, 3, 1, 2))
        _, vq0 = default.module.vq_encode(x)
        _, vq1 = recon.module.vq_encode(x)
        print(f"encode side: {int((vq0 != vq1).sum())} of {vq0.numel()} VQ indices differ "
              f"between the two models")


def compare_recon(default, recon, y_hat):
    """The decode side of compare_models: the float reconstructions of the
    same y_hat by both models, the VQGAN decoders fed the default model's
    estimator indices, within RECON_TOL."""
    import torch
    b1, b2 = default._betas(0)
    with torch.no_grad():
        logits0, idx0, img0 = recon_parts(default.module, y_hat, b1, b2)
        logits1, idx1, img1 = recon_parts(recon.module, y_hat, b1, b2, indices=idx0)
        diff = (img1 - img0).abs()
        flips = int((idx1 != idx0).sum())
        print(f"reconstruction kernels on vs default, same y_hat: image max abs diff "
              f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e} on the [-1, 1] "
              f"scale (tolerance {RECON_TOL:g}); estimator logits max abs diff "
              f"{float((logits1 - logits0).abs().max()):.3e}; {flips} of {idx0.numel()} "
              f"estimator indices differ")
        if not torch.isfinite(img1).all() or float(diff.max()) > RECON_TOL:
            raise AssertionError("the reconstruction with the kernels on is too far "
                                 "from the default model's")


# Two bf16 reconstructions of one y_hat and one set of codeword indices differ
# by rounding alone (every layer rounds to 8 bits, each route in its own
# order), which random weights carry to the pixels: no fixed tolerance says
# how far. The f32 model's reconstruction of the same inputs does: per image,
# a bf16 route may be at most this many times as far from it (mean absolute
# difference) as the bf16 default model at batch 16 is (measured: 0.99 to
# 1.01 for every image and route, all about 0.014 on the [-1, 1] scale).
BF16_NOISE_RATIO = 1.25


def _per_image_mean(a, b):
    return (a - b).abs().flatten(1).mean(1)


def bf16_against_f32(f32, off, on, y_hat):
    """The bf16 reconstruction with the kernels on, with the kernels off and
    the f32 model's, all of the same y_hat at batch 16 and all fed the
    codeword indices of the bf16 default model's estimator. Image by image
    the kernels' route must be within BF16_NOISE_RATIO of the default
    route's distance to the f32 reconstruction: a kernel that mixed up one
    image's planes would be off by the image's own scale. Returns the
    default route's (logits, indices, image) and the f32 image."""
    import torch
    with torch.no_grad():
        logits, idx, img_off = recon_parts(off.module, y_hat, *off._betas(0))
        _, own, img_on = recon_parts(on.module, y_hat, *on._betas(0), indices=idx)
        _, _, ref = recon_parts(f32.module, y_hat, *f32._betas(0), indices=idx)
    e_off, e_on = _per_image_mean(img_off, ref), _per_image_mean(img_on, ref)
    apart = _per_image_mean(img_on, img_off)
    print(f"bf16 reconstructions of one y_hat and one set of codeword indices, batch "
          f"{y_hat.shape[0]}, mean absolute distance per image on the [-1, 1] scale: kernels "
          f"off to the f32 model's {[round(float(v), 5) for v in e_off]}, kernels on to the "
          f"f32 model's {[round(float(v), 5) for v in e_on]}, on to off "
          f"{[round(float(v), 5) for v in apart]}; the largest ratio on / off is "
          f"{float((e_on / e_off).max()):.3f} (allowed {BF16_NOISE_RATIO:g}); "
          f"{int((own != idx).sum())} of {idx.numel()} estimator indices differ between the "
          f"two bf16 models")
    if not torch.isfinite(img_on).all() or bool((e_on > BF16_NOISE_RATIO * e_off).any()):
        raise AssertionError("the bf16 reconstruction with the kernels on is further from the "
                             "f32 model's than rounding explains")
    return (logits, idx, img_off), ref


TILED_SIZE = (2048, 1365)   # a CLIC-2020 professional photograph; pads to 2048 x 1408


def tile_chunks(codec, H, W):
    """(encode tiles, reconstruction tiles, encode chunks, reconstruction
    chunks) of one H x W image on the split paths."""
    from dc_vic_tpu_torch.codec.tiling import (DEC_STRIDE_Y, DEC_WINDOW_Y, ENC_STRIDE,
                                               ENC_WINDOW, tile_starts)
    pH, pW = -(-H // 64) * 64, -(-W // 64) * 64
    n_enc = len(tile_starts(pH, ENC_WINDOW, ENC_STRIDE)) * len(tile_starts(pW, ENC_WINDOW,
                                                                           ENC_STRIDE))
    n_dec = len(tile_starts(pH // 16, DEC_WINDOW_Y, DEC_STRIDE_Y)) * len(
        tile_starts(pW // 16, DEC_WINDOW_Y, DEC_STRIDE_Y))
    c = codec._TILE_CHUNK
    return n_enc, n_dec, -(-n_enc // c), -(-n_dec // c)


def tiled_round_trip(codec, images, label):
    """The main path on an image over 1024 px, counted as counted_round_trip
    counts (counters set to 0 just before, read just after, held against
    the shape rules for the modules that ran), with the tpu format's decode
    chain under torch.cuda.set_sync_debug_mode("error"). Then: latents
    bit-exact, the decoded image equal to _split_reconstruct of the
    encoder's y_hat (the consumed words were checked by the fetch). Returns
    (results, decoded images, launches, launch shapes, y_hat on the card)."""
    import torch
    from dc_vic_tpu_torch.ops import counts
    want, shapes, handles = expected_launch_recorder(codec.module)
    tpu = codec.stream_format == "tpu"
    want["rans_encode_pack"] = 2 if tpu and codec.encode_backend == "device" else 0
    want["rans_decode_section"] = 1 + codec.y_sections if tpu else 0
    counts.reset()
    try:
        with sync_free_decode(codec):
            res, out, _, _ = drive(codec, images)
    finally:
        for h in handles:
            h.remove()
    launches = counts.launches()
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, the shape rules give {want}")
    B, H, W = images.shape[:3]
    if out.shape != (B, H, W, 3) or not codec.verify_roundtrip(
            res, [r["string_list"] for r in res], (H, W)):
        raise AssertionError(f"{label}: decoded {out.shape}, or the decoder's latents differ "
                             f"from the encoder's")
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2))).to(codec.device)
    with torch.no_grad():
        recon = codec._split_reconstruct(y_hat, *codec._betas(0))
    if not np.array_equal(out, recon[:, :, :H, :W].permute(0, 2, 3, 1).cpu().numpy()):
        raise AssertionError(f"{label}: decoded images differ from _split_reconstruct(y_hat)")
    print(f"{label}: launches {launches}; y_hat and z_hat round trip bit-exact, decoded image "
          f"equals _split_reconstruct(y_hat), consumed words checked"
          f"{', decode chain under set_sync_debug_mode(error)' if tpu else ''}")
    return res, out, launches, shapes, y_hat


def timed_round_trip(codec, images):
    """One warm round trip on the host clock: (encode s, decode s, peak
    memory GiB, bpp)."""
    import torch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, _, enc, dec = drive(codec, images)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return enc, dec, peak, float(np.mean([r["bpp"] for r in res]))


def check_cpu_decoder(opt, sd, codec, images):
    """A compressai stream encoded on the card with the entropy chain on the
    CPU (params_backend "cpu") decodes to the encoder's latents on a model
    built on the CPU from the same weights, at another thread count; the
    latents of the card's decoder as 4, 2 x 2 and 4 x 1 are printed."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model
    B, H, W = images.shape[:3]
    res = codec.compress(images, 0, debug=True)
    strings = [r["string_list"] for r in res]
    cpu_spec = build_comp_model(opt, device="cpu")
    cpu_spec.module.load_state_dict({k: v.cpu() for k, v in sd.items()}, strict=True)
    cpu_codec = Codec(cpu_spec, stream_format="compressai")
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2 - 1))
    try:
        t0 = time.perf_counter()
        same = cpu_codec.verify_roundtrip(res, strings, (H, W))
        cpu_s = time.perf_counter() - t0
        cpu_threads = torch.get_num_threads()
    finally:
        torch.set_num_threads(threads)
    if not same:
        raise AssertionError("a card-encoded params_backend='cpu' stream did not decode to the "
                             "encoder's latents on a CPU-built model")
    groups = {}
    for name, size in (("4", 4), ("2 x 2", 2), ("4 x 1", 1)):
        groups[name] = all(codec.verify_roundtrip(res[lo:lo + size], strings[lo:lo + size],
                                                  (H, W)) for lo in range(0, B, size))
    if not groups["4"]:
        raise AssertionError("the card's decoder with the CPU chain disagrees with its encoder")
    print(f"params_backend cpu, compressai, batch {B} {H}x{W} encoded on the card: a model "
          f"built on the CPU decodes y_hat and z_hat bitwise equal to the encoder's "
          f"({cpu_threads} threads against the encoder's {threads}; {cpu_s:.2f} s for the "
          f"latents on the CPU); the card's decoder as 4, 2 x 2, 4 x 1 gives the encoder's "
          f"latents: {groups}")
    return groups


def check_betas(codec, images):
    """Quality 2's betas given as betas write quality 2's z and y strings
    with quality 0 in the header; decompress_raw with those betas gives
    quality 2's pixels."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    H, W = images.shape[1:3]
    br, bv = codec.spec.quality_betas(2)
    by_q = codec.compress(images, 2)
    by_b = codec.compress(images, beta_rate=br, beta_vq=bv)
    heads = [HeaderHandler.decode(r["string_list"][0]) for r in by_b]
    if any(q["string_list"][1:] != b["string_list"][1:] for q, b in zip(by_q, by_b)) or any(
            h["quality_ind"] != 0 for h in heads) or any(
            HeaderHandler.decode(r["string_list"][0])["quality_ind"] != 2 for r in by_q):
        raise AssertionError("betas given as betas wrote other strings or headers than the "
                             "quality level they equal")
    raw = codec.decompress_raw(
        [r["string_list"][1] for r in by_b], [r["string_list"][2] for r in by_b], (H, W), br, bv,
        stream_format=heads[0]["stream_format"], lanes=heads[0]["lanes"],
        esc_dense=any(h["esc_dense"] for h in heads), t2free=all(h["t2free"] for h in heads),
        escfree=all(h["escfree"] for h in heads))
    if not np.array_equal(raw, codec.decompress([r["string_list"] for r in by_q])):
        raise AssertionError("decompress_raw at quality 2's betas gave other pixels")
    print(f"custom betas ({br}, {bv}) = quality 2: the same z and y strings, quality 0 in the "
          f"header; decompress_raw with them gives quality 2's pixels")


def check_cli(images):
    """The compress CLI's body (tools/compress.py: compress_arrays, with
    selfcheck and decompress) on the flagship built as the CLI builds it,
    into a temporary directory."""
    import tempfile
    from dc_vic_tpu_torch.codec.container import load_byte_strings
    from dc_vic_tpu_torch.tools import compress as cli
    codec = cli.build_codec(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    named = [(f"photo{i}.png", a) for i, a in enumerate(images)]
    with tempfile.TemporaryDirectory() as tmp:
        rows, decoded = cli.compress_arrays(codec, named, 0, tmp, batch_size=2, selfcheck=True,
                                            decompress=True)
        files = sorted(os.listdir(tmp))
        again = codec.decompress([load_byte_strings(os.path.join(tmp, f"photo{i}.bin"))
                                  for i in range(len(images))])
    if (files != ["_avg_bitrate.json", "_bitrates.csv"] + [f"photo{i}.bin"
                                                           for i in range(len(images))]
            or [r["img_name"] for r in rows] != [n for n, _ in named]
            or not np.array_equal(np.stack([decoded[n] for n, _ in named]), again)):
        raise AssertionError(f"the CLI's outputs: {files}, {rows}")
    print(f"CLI compress_arrays, 2 images {images.shape[1]}x{images.shape[2]}, batch 2, tpu "
          f"format, portable, selfcheck and decompress: files {files}; "
          f"{[round(r['real_bpp'], 4) for r in rows]} bpp, pred "
          f"{[round(r['pred_bpp'], 4) for r in rows]}")


def check_codec_scope(codec, images):
    """A Codec leaves the process's backend settings as it found them, at
    construction and around its calls, and its round trip stays bit-exact
    whatever they are (the opposite of its own, here). The check's own
    reference reconstruction runs with the codec's settings: under the
    caller's TF32 it would be another computation."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    before, theirs = flags(), (True, True, False, True)
    try:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = theirs
        c = Codec(codec.spec, stream_format="compressai", params_backend="accel")
        after_init = flags()
        trip = drive(c, images)
        if (after_init, flags()) != (theirs, theirs):
            raise AssertionError(f"Codec changed the backend settings: {theirs} -> "
                                 f"{after_init} -> {flags()}")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = before
    verify(c, images, *trip, "compressai format, driven with the caller's TF32 and cuDNN "
           "benchmark on, batch 1 500x740")
    print("Codec: construction and calls leave TF32 and the cuDNN flags as the caller set "
          "them; the round trip stays bit-exact with the caller's TF32 on")


def check_predicates(attention, vq, dev, gen):
    """Outside their rules K1 and K2 take the plain versions on the card
    and do not raise: attention with C = 64, and with bf16 operands; a VQ
    of D = 8."""
    import torch
    before = (attention.launches, vq.launches)
    q, k, v = (torch.randn(2, 300, 64, generator=gen, device=dev) for _ in range(3))
    cases = [("attention C=64", attention.flash_attention(q, k, v),
              attention.attention_plain(q, k, v)),
             ("attention bf16", attention.flash_attention(q.bfloat16(), k.bfloat16(),
                                                          v.bfloat16()),
              attention.attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16()))]
    z, cb = torch.randn(1000, 8, generator=gen, device=dev), torch.randn(256, 8, generator=gen,
                                                                        device=dev)
    cases.append(("vq D=8", vq.vq_argmin(z, cb), vq.vq_argmin_plain(z, cb)))
    z = z[:990].reshape(2, 33, 15, 8).permute(0, 3, 1, 2)
    cases.append(("vq NCHW D=8", vq.vq_argmin_nchw(z, cb), vq.vq_argmin_nchw_plain(z, cb)))
    for name, got, want in cases:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not the plain version")
    if (attention.launches, vq.launches) != before:
        raise AssertionError("a shape outside the kernels' rules launched a kernel")
    print("K1/K2 outside their rules on the card: attention with C = 64 and with bf16 "
          "operands, VQ with D = 8 (flat and NCHW) take the plain versions (equal bits, no "
          "launch)")


def check_tiled(opt, sd, smi, dev, gen):
    """Item 12 of the module docstring. ``sd``: the f32 weights of the
    workload. Returns the launches of the tiled round trip with the
    reconstruction kernels on."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn, vq
    from dc_vic_tpu_torch.tools.workload import smooth_images
    t_phase = time.perf_counter()
    H, W = TILED_SIZE
    image = smooth_images(1, H, W)
    spec = build_comp_model(opt)
    spec.module.load_state_dict(sd, strict=True)
    tpu = Codec(spec, encode_backend="device", lanes=512)
    n_enc, n_dec, c_enc, c_dec = tile_chunks(tpu, H, W)
    vqm = spec.module.vq_model
    per_enc = sum(isinstance(m, VQAttnBlock) for m in vqm.encoder.modules())
    per_dec = sum(isinstance(m, VQAttnBlock) for m in vqm.decoder.modules())
    want_k2 = c_enc * per_enc + c_dec * per_dec
    print(f"tiled path, 1 image {H}x{W}: {n_enc} encode tiles in {c_enc} chunks, {n_dec} "
          f"reconstruction tiles in {c_dec} chunks of {tpu._TILE_CHUNK}; K2 launches "
          f"{c_enc} x {per_enc} + {c_dec} x {per_dec} = {want_k2}")
    times = {}
    for fmt, codec in (("tpu", tpu), ("compressai", Codec(spec, stream_format="compressai"))):
        label = (f"tiled {H}x{W}, f32, {fmt} format"
                 + (", device backend, lanes 512" if fmt == "tpu" else
                    f", params_backend {codec.params_backend}"))
        res, out, got, _, y_hat = tiled_round_trip(codec, image, label)
        if (got["vq_argmin"], got["flash_attention"]) != (1, want_k2):
            raise AssertionError(f"{label}: K1 {got['vq_argmin']}, K2 {got['flash_attention']}")
        times[fmt] = timed_round_trip(codec, image)
        print(f"{label}: warm encode {times[fmt][0]:.4f} s, decode {times[fmt][1]:.4f} s (host "
              f"clock, one run), peak memory {times[fmt][2]:.2f} GiB, {times[fmt][3]:.4f} bpp; "
              f"{smi}")
        if fmt == "tpu":
            kept = (out, y_hat)
            reader = Codec(spec, stream_format="compressai")
            if not reader.verify_roundtrip(res, [r["string_list"] for r in res], (H, W)):
                raise AssertionError(f"{label}: a compressai Codec (params_backend "
                                     f"{reader.params_backend}) decodes other latents")
            print(f"{label}: a compressai Codec (params_backend {reader.params_backend}) "
                  f"decodes the stream's latents bit-exactly")
            del reader
        del res, out, codec
    torch.cuda.empty_cache()

    spec_k = build_comp_model(opt, recon_kernels=RECON_KERNELS)
    spec_k.module.load_state_dict(sd, strict=True)
    tpu_k = Codec(spec_k, encode_backend="device", lanes=512)
    label = f"tiled {H}x{W}, f32, tpu format, reconstruction kernels on"
    _, out_k, launches_k, shapes_k, _ = tiled_round_trip(tpu_k, image, label)
    if any(launches_k[k] < 1 for k in (*gn.launches, *conv3x3.launches)) or (
            launches_k["vq_argmin"], launches_k["flash_attention"]) != (1, want_k2):
        raise AssertionError(f"{label}: launches {launches_k}")
    enc, dec, peak, _ = timed_round_trip(tpu_k, image)
    print(f"{label}: warm encode {enc:.4f} s, decode {dec:.4f} s, peak memory {peak:.2f} GiB")
    print(json.dumps({"tiled_launch_shapes": {
        name: [{"shape": list(shape), "launches": n} for shape, n in sorted(table.items())]
        for name, table in shapes_k.items()}}))
    check_path_shapes(gn, conv3x3, shapes_k, dev, gen, "float32")
    out, y_hat = kept
    from dc_vic_tpu_torch.codec.tiling import DEC_WINDOW_Y as w
    first = torch.cat([y_hat[:, :, t:t + w, l:l + w] for t, l in
                       ((0, 0), (0, 16), (16, 0), (16, 16))])
    compare_recon(tpu, tpu_k, first)
    diff = np.abs(out_k.astype(np.int16) - out.astype(np.int16))
    print(f"tiled decode, kernels on against off: {float((diff > 1).mean()):.4f} of the pixels "
          f"more than one step apart, mean {float(diff.mean()):.3f} steps (estimator argmax "
          f"flips included; the float reconstructions of four tiles fed one set of indices are "
          f"held above)")
    del spec_k, tpu_k, out_k, kept, out, y_hat, first
    torch.cuda.empty_cache()

    images = smooth_images(4, 768, 512)
    check_cpu_decoder(opt, sd, Codec(spec, stream_format="compressai"), images)
    check_betas(tpu, images)
    del tpu, spec
    torch.cuda.empty_cache()
    check_cli(images[:2])
    check_predicates(attention, vq, dev, gen)
    print(f"item 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches_k, times


def report_ptxas(log):
    """One line per kernel from the compiler's -Xptxas -v output: its name
    with the template arguments as mangled, registers, spills, and any
    warning that its wgmma products were serialized."""
    import re
    name = None
    facts = []
    for line in log.splitlines() + ["Compiling entry function ''"]:
        if "Compiling entry function" in line:
            if name:
                print(f"  ptxas: {name}: {'; '.join(facts)}")
            name = None
            for found in re.finditer(r"(?=(\d\d)([a-z][a-z0-9_]*?_kernel)(.*?)E(v|PK))", line):
                if int(found.group(1)) == len(found.group(2)):     # <length><name>
                    name = found.group(2) + found.group(3)
            facts = []
        elif "spill" in line or "wgmma" in line:
            facts.append(line.strip())
        elif "registers" in line:
            facts.append(line.split(":", 1)[1].strip())


def check_deployment(deployment_sd):
    """Items 8 to 10 of the module docstring. ``deployment_sd``: the f32
    weights of the workload (seed 0, encoder scaled). Returns the launch
    counts of the bf16 round trip with the reconstruction kernels on, and
    the shapes its reconstruction kernels were launched with."""
    import torch
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.ops import conv3x3, gn
    from dc_vic_tpu_torch.tools.workload import (DEPLOYMENT, deployment_config,
                                                 deployment_images)
    from dc_vic_tpu_torch.utils.config import load_config
    recon_names = (*gn.launches, *conv3x3.launches)
    opt = load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    images16 = deployment_images()
    B16, lanes = DEPLOYMENT["batch"], DEPLOYMENT["lanes"]
    opt16 = deployment_config(opt)
    kept = {}
    for dtype_name, o in (("bfloat16", opt16), ("float32", opt)):
        for names in ((), RECON_KERNELS):
            label = (f"{dtype_name}, entropy_precision {o.get('entropy_precision', 'high')}, "
                     f"recon_kernels {'on' if names else 'off'}, tpu format, device backend, "
                     f"lanes {lanes}, batch {B16} 768x512")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            spec_c = build_comp_model(o, recon_kernels=names)
            spec_c.module.load_state_dict(deployment_sd, strict=True)
            codec_c = Codec(spec_c, encode_backend="device", lanes=lanes)
            y_hat, got, shapes = counted_round_trip(codec_c, images16, label)
            if (got["vq_argmin"], got["flash_attention"], got["rans_encode_pack"],
                    got["rans_decode_section"]) != (1, 7, 2, 7):
                raise AssertionError(f"{label}: launches {got}")
            if names == RECON_KERNELS and any(got[k] < 1 for k in recon_names):
                raise AssertionError(f"{label}: a reconstruction kernel never launched: {got}")
            res, _, enc, dec = drive(codec_c, images16)
            strings16 = [r["string_list"] for r in res]
            bpp = float(np.mean([r["bpp"] for r in res]))
            if not bpp > 0.03:
                raise AssertionError(f"{label}: {bpp} bpp: a near-empty stream idles the coder")
            h = HeaderHandler.decode(strings16[0][0])
            want = dict(stream_format="tpu", lanes=lanes, encode_batch=B16, portable=False,
                        fast_entropy=dtype_name == "bfloat16", bf16=dtype_name == "bfloat16")
            if any(h[k] != v for k, v in want.items()):
                raise AssertionError(f"{label}: header {h}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"{label}: warm encode {enc:.4f} s, decode {dec:.4f} s (host clock, one "
                  f"run); {bpp:.4f} bpp"
                  f"{' (over the 0.8 the reference workload stays under)' if bpp > 0.8 else ''}"
                  f"; peak memory {peak:.2f} GiB; header {h}")
            if dtype_name == "bfloat16" or not names:
                kept[dtype_name, bool(names)] = (spec_c, codec_c, strings16, got, shapes, y_hat)
            del spec_c, codec_c, y_hat
    _, codec16k, _, launches16, shapes16, _ = kept["bfloat16", True]
    spec16, codec16, strings16, _, _, y_hat = kept["bfloat16", False]
    parts16, ref = bf16_against_f32(kept.pop(("float32", False))[1], codec16, codec16k, y_hat)
    del y_hat
    torch.cuda.empty_cache()
    fast_ms, high_ms = entropy_chain_ms(codec16, images16)
    print(f"entropy chain of one batch-{B16} encode (hyper_decode, slice parameters, six "
          f"decode steps): {fast_ms:.3f} ms with entropy_precision default (TF32 allowed in "
          f"its convs), {high_ms:.3f} ms with high")
    for on in (False, True):
        cycles = pipelined_cycle(kept["bfloat16", on][1], images16)
        print(f"pipelined cycle, recon_kernels {'on' if on else 'off'}, 3 batches of {B16}: "
              f"{', '.join(f'{c:.4f}' for c in cycles)} s per cycle (the first waits for no "
              f"decode and the last also drains, so the middle one is the steady state: "
              f"{B16 / cycles[1]:.2f} images/s; all three batches {sum(cycles):.4f} s, "
              f"{3 * B16 / sum(cycles):.2f} images/s)")
    fresh_spec = build_comp_model(opt16)
    fresh_spec.module.load_state_dict(deployment_sd, strict=True)
    pcodec, pbpp = check_portable(spec16, fresh_spec, codec16, strings16, images16, parts16,
                                  ref)
    del fresh_spec, parts16, ref
    print(f"portable streams, bf16 recon_kernels off, batch {B16}: {pbpp:.4f} bpp")
    del kept, pcodec, codec16, codec16k, spec16
    torch.cuda.empty_cache()
    return launches16, shapes16


# ------------------------------------------------------------------ training

TRAIN_BATCH, TRAIN_CROP = 6, 256     # config/_base_/dataset: batch 6 of 256x256 crops
GRAD_TOL = 1e-3                      # relative L2 per parameter tensor (+1e-7 absolute)
TRAIN_STEPS = 4                      # timed steps per setting; the first is not warm


def _training_images(root):
    """Twelve 384x320 training images and two 768x512 evaluation images
    (smooth content plus noise, seed 0), as .npy uint8 files."""
    from dc_vic_tpu_torch.tools.workload import smooth_images
    imgs = smooth_images(14, 768, 512)
    os.makedirs(os.path.join(root, "train_0"))
    os.makedirs(os.path.join(root, "kodak"))
    for i in range(12):
        np.save(os.path.join(root, "train_0", f"img{i:02d}.npy"),
                imgs[i, 24 * i:24 * i + 384, 8 * i:8 * i + 320])
    for j in range(2):
        np.save(os.path.join(root, "kodak", f"kodim{j:02d}.npy"), imgs[12 + j])


def training_opt(stage, root, load=None):
    """config/exp1_stage{stage}.yaml on the synthetic images, checkpoints
    under ``root``, the reconstruction kernels on."""
    from dc_vic_tpu_torch.models import RECON_KERNELS
    from dc_vic_tpu_torch.utils.config import load_config
    opt = load_config(os.path.join(ROOT, "config", f"exp1_stage{stage}.yaml"), is_train=True)
    data = opt["dataset"]
    data["batch_size"] = TRAIN_BATCH
    data["train_dataset"].update(root_dir=root, subset_list=[0], image_size=TRAIN_CROP)
    data["eval_dataset"]["root_dir"] = os.path.join(root, "kodak")
    opt["ckpt_root"] = os.path.join(root, "ckpt")
    opt["recon_kernels"] = list(RECON_KERNELS)
    opt["load_checkpoint"] = load
    return opt


class _KernelSwitch:
    """Every kernel of the training path that has a plain route, off or on:
    K3 to K6 through ``set_recon_kernels``, K2 through its shape rule (the
    plain attention is differentiated by autograd). K1 has no gradient."""

    def __init__(self, attention):
        self.attention, self.rule = attention, attention.use_kernel

    def __call__(self, module, on):
        from dc_vic_tpu_torch.models import RECON_KERNELS, set_recon_kernels
        set_recon_kernels(module, RECON_KERNELS if on else ())
        self.attention.use_kernel = self.rule if on else (lambda shape, dtype: False)


def backward_recorder(module):
    """Forward hooks counting, by the shape rules, the kernel launches whose
    output carries a gradient: the Function backwards the step runs."""
    import torch
    from dc_vic_tpu_torch.models.vqgan import VQAttnBlock, VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import Conv2d, GroupNorm
    from dc_vic_tpu_torch.ops import attention
    want = {"flash_attention": 0, "gn_channel_sums": 0, "gn_apply": 0, "conv3x3_same": 0,
            "conv3x3_gn_swish": 0}

    def hook(m, args):
        x = args[0]
        if not (torch.is_grad_enabled() and x.requires_grad):
            return
        if isinstance(m, VQAttnBlock):
            B, C, H, W = x.shape
            want["flash_attention"] += attention.use_kernel((B, H * W, C), torch.float32)
        elif isinstance(m, GroupNorm) and m.takes_kernel(x.shape):
            want["gn_channel_sums"] += 1
            want["gn_apply"] += 1
        elif isinstance(m, Conv2d) and m.takes_kernel(x.shape):
            want["conv3x3_same"] += 1
        elif isinstance(m, VQResnetBlock) and m.takes_fused(x.shape):
            want["conv3x3_gn_swish"] += 2

    kinds = (VQAttnBlock, GroupNorm, Conv2d, VQResnetBlock)
    return want, [m.register_forward_pre_hook(hook) for m in module.modules()
                  if isinstance(m, kinds)]


def _rel_l2(got, want):
    import torch
    err = float(torch.linalg.vector_norm((got - want).double()))
    return err, err / max(float(torch.linalg.vector_norm(want.double())), 1e-30)


def recorded_step(module, run):
    """``run()`` with every launch counter and Function backward counter
    set to 0 just before it and read just after, held against what the
    shape rules give for the modules that ran. Returns (run's result,
    {"forward": launches, "backward": backwards}, the conv and GroupNorm
    kernels' launch shapes)."""
    import torch
    from dc_vic_tpu_torch.ops import counts
    want, shapes, handles = expected_launch_recorder(module)
    want_bwd, more = backward_recorder(module)
    want.update(rans_encode_pack=0, rans_decode_section=0)
    counts.reset()
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        for h in handles + more:
            h.remove()
    got = dict(forward=counts.launches(), backward=counts.backwards())
    if got != dict(forward=want, backward=want_bwd):
        raise AssertionError(f"launches {got}, the shape rules give {want} / {want_bwd}")
    return result, got, shapes


def compare_training_gradients(tr, batch, switch, flags=None):
    """Item 13.1: one RD step's gradients with every kernel off and on, the
    same betas, noise and VQ targets, under the trainer's backend flags or
    ``flags``. Returns the worst relative error."""
    import torch
    from dc_vic_tpu_torch.codec.ops import Noise
    from dc_vic_tpu_torch.train.steps import rd_losses
    from dc_vic_tpu_torch.train.trainer import _FLAGS as _TRAIN_FLAGS
    from dc_vic_tpu_torch.utils.backends import backend_flags
    model = tr.model
    beta_rate, beta_vq = tr.policy.sample(tr.state.generator, batch.shape[0])
    with torch.no_grad():
        codes = model.vq_encode(batch)
    # the frozen VQGAN's targets, pinned: a near-tie in the argmin between
    # the two routes' latents would change the targets, not test a gradient
    model.vq_encode = lambda x: codes
    grads = {}

    def run():
        with backend_flags(**(flags or _TRAIN_FLAGS)):
            total, _, _ = rd_losses(model, tr.losses, batch, beta_rate, beta_vq, tr.policy,
                                    Noise(torch.Generator(batch.device).manual_seed(1)))
            (total + model.aux_loss()).backward()
        return total

    try:
        for on in (False, True):
            switch(model, on)
            for p in model.parameters():
                p.grad = None
            total, launched, _ = recorded_step(model, run)
            grads[on] = {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}
            print(f"RD step gradients, kernels {'on' if on else 'off'}: loss "
                  f"{float(total.detach()):.6f}; launches {launched['forward']}; Function "
                  f"backwards {launched['backward']}")
    finally:
        del model.vq_encode
        switch(model, True)
    trained = [n for n, m in tr.main_mask.items() if m] + [n for n, m in tr.aux_mask.items() if m]
    return hold_gradients(grads, trained, "RD step")


def hold_gradients(grads, trained, label):
    """``grads[on]`` ({name: gradient} with the kernels off and on): every
    name in ``trained`` has a finite gradient in both runs, no other name
    has any, and each is within GRAD_TOL relative L2 (+1e-7) of the run
    with the kernels off. Returns the worst relative error."""
    import torch
    for on in (False, True):
        missing = [n for n in trained if n not in grads[on]]
        bad = [n for n in trained if n in grads[on] and not torch.isfinite(grads[on][n]).all()]
        if missing or bad:
            raise AssertionError(f"{label}, kernels {'on' if on else 'off'}: trained parameters "
                                 f"without a gradient {missing[:5]}, non-finite {bad[:5]}")
    frozen = [n for n in grads[True] if n not in trained]
    if frozen:
        raise AssertionError(f"{label}: frozen parameters got gradients: {frozen[:5]}")
    worst, worst_name = 0.0, None
    for name, want in grads[False].items():
        err, rel = _rel_l2(grads[True][name], want)
        if not err <= GRAD_TOL * float(torch.linalg.vector_norm(want.double())) + 1e-7:
            raise AssertionError(f"{label} gradients, kernels on vs off: {name} relative L2 "
                                 f"error {rel:.3e} over {GRAD_TOL}")
        if rel > worst:
            worst, worst_name = rel, name
    print(f"{label} gradients, kernels on vs off: {len(trained)} trained tensors, every one "
          f"with a finite gradient, no frozen one with any; worst relative L2 error "
          f"{worst:.3e} ({worst_name}; tolerance {GRAD_TOL})")
    return worst


def timed_steps(tr, loader, switch, on, n=TRAIN_STEPS):
    """n steps of the trainer's stage with the kernels off or on: (host
    seconds of each step, ending in a synchronize; the last step's launches
    and Function backwards, held against the shape rules; its launch
    shapes)."""
    import torch
    switch(tr.model, on)
    secs = []
    for i in range(n):
        batch = tr._to_device(next(loader)["real_images"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i < n - 1:
            terms = tr.step(batch)
            torch.cuda.synchronize()
        else:
            terms, launched, shapes = recorded_step(tr.model, lambda: tr.step(batch))
        secs.append(time.perf_counter() - t)
        if not all(np.isfinite(float(v)) for v in terms.values()) or float(terms["skipped"]):
            raise AssertionError(f"a training step gave {terms}")
    return secs, launched, shapes


def time_backward_kernels(shapes, dev, gen):
    """Item 13.3: each kernel Function of the training path at the path's
    largest shape: the output carries a grad_fn, its gradients are held to
    autograd of the plain version, and forward and backward are timed with
    CUDA events. Returns {kernel: the training keys of its entry}."""
    import torch
    from dc_vic_tpu_torch.ops import attention, conv3x3, gn
    rows = {}

    def run(name, shape, kernel, plain, inputs):
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = kernel(*leaves)
        if out.grad_fn is None:
            raise AssertionError(f"{name}: the kernel's output has no grad_fn")
        g = torch.randn(out.shape, generator=gen, device=dev)
        got = torch.autograd.grad(out, leaves, g)
        ref = [t.detach().requires_grad_(True) for t in inputs]
        want = torch.autograd.grad(plain(*ref), ref, g)
        worst = max(_rel_l2(a, b)[1] for a, b in zip(got, want))
        if worst > GRAD_TOL:
            raise AssertionError(f"{name} backward at {list(shape)}: relative L2 {worst:.3e}")
        with torch.no_grad():
            fwd = _time_ms(kernel, *inputs)
        # one backward alone: the forward and backward, less the forward
        bwd = _time_ms(lambda: torch.autograd.grad(kernel(*leaves), leaves, g)) \
            - _time_ms(kernel, *leaves)
        plain_bwd = _time_ms(lambda: torch.autograd.grad(plain(*ref), ref, g)) \
            - _time_ms(plain, *ref)
        rows[name] = dict(train_shape=list(shape), train_fwd_ms=fwd, train_bwd_ms=bwd,
                          train_plain_bwd_ms=plain_bwd, train_bwd_max_rel_l2=worst)
        print(f"{name} at {list(shape)}, f32: the output has a grad_fn; forward kernel "
              f"{fwd:.3f} ms, Function backward {bwd:.3f} ms (autograd of the plain version "
              f"{plain_bwd:.3f} ms), gradients within {worst:.2e} of the plain version's")

    B = TRAIN_BATCH
    q, k, v = (torch.randn(B, 1024, 512, generator=gen, device=dev) * s for s in (0.05, 1, 1))
    run("flash_attention", (B, 1024, 512), attention.flash_attention,
        attention.attention_plain, (q, k, v))
    gshape = max(shapes["gn"], key=lambda s: int(np.prod(s)))
    x = torch.randn(gshape, generator=gen, device=dev)
    run("gn_channel_sums", gshape, gn.channel_sums, gn.channel_sums_plain, (x,))
    scale = torch.rand(gshape[:2], generator=gen, device=dev) + 0.5
    bias = torch.randn(gshape[:2], generator=gen, device=dev)
    run("gn_apply", gshape, lambda x, s, b: gn.apply_affine(x, s, b, "swish"),
        lambda x, s, b: gn.apply_affine_plain(x, s, b, "swish"), (x, scale, bias))
    for name in ("conv3x3_same", "conv3x3_gn_swish"):
        Bc, C, Cout, H, W = max(shapes[name], key=lambda s: int(np.prod(s)))
        x = torch.randn(Bc, C, H, W, generator=gen, device=dev)
        w = torch.randn(Cout, C, 3, 3, generator=gen, device=dev) / (3 * C ** 0.5)
        if name == "conv3x3_same":
            run(name, (Bc, C, Cout, H, W), conv3x3.conv3x3_same, conv3x3.conv3x3_same_plain,
                (x, w))
            continue
        s = torch.rand(Bc, C, generator=gen, device=dev) + 0.5
        b = torch.randn(Bc, C, generator=gen, device=dev) * 0.1
        cb = torch.randn(Cout, generator=gen, device=dev)
        res = torch.randn(Bc, Cout, H, W, generator=gen, device=dev)
        run(name, (Bc, C, Cout, H, W), conv3x3.conv3x3_gn_swish,
            conv3x3.conv3x3_gn_swish_plain, (x, w, s, b, cb, res))
    return rows


def check_training(smi, dev, gen):
    """Item 13 of the module docstring. Returns {kernel name: the training
    keys of its entry in the kernels line}."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.ops import attention
    from dc_vic_tpu_torch.tools.workload import scale_encoder
    from dc_vic_tpu_torch.train.trainer import build_trainer
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_train_")
    switch = _KernelSwitch(attention)
    loaders = []
    try:
        _training_images(root)
        torch.cuda.empty_cache()
        # stage 1_2: gradients off against on, then steps off and on
        t = time.perf_counter()
        tr = build_trainer(training_opt("1_2", root))
        tr.model.load_state_dict(scale_encoder(tr.model.state_dict()))
        print(f"stage 1_2 trainer (flagship, f32, random weights from seed 0, encoder x 0.55): "
              f"built in {time.perf_counter() - t:.1f} s")
        frozen0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                   if n.startswith("vq_model.")}
        loaders.append(tr.train_loader.infinite())
        loader = loaders[-1]
        worst = compare_training_gradients(tr, tr._to_device(next(loader)["real_images"]),
                                           switch)
        enc0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                if n.startswith("encoder.")}
        rd_off, _, _ = timed_steps(tr, loader, switch, False)
        torch.cuda.reset_peak_memory_stats()
        rd_on, rd_launched, shapes = timed_steps(tr, loader, switch, True)
        rd_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if all(torch.equal(enc0[n], p) for n, p in tr.model.named_parameters() if n in enc0):
            raise AssertionError("stage 1_2: the encoder did not move")
        n12 = tr.state.step
        tr.save(n12)
        del tr
        torch.cuda.empty_cache()

        # stage 1_3 boots from 1_2's checkpoint (the shipped knobs)
        tr = build_trainer(training_opt("1_3", root, dict(
            exp="exp1_stage1_2", iter=n12, load_optimizer=False, strict=False)))
        loaders.append(tr.train_loader.infinite())
        loader = loaders[-1]
        before = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                  if n.startswith(("encoder.", "decoder."))}
        gan_off, _, _ = timed_steps(tr, loader, switch, False)
        torch.cuda.reset_peak_memory_stats()
        gan_on, gan_launched, _ = timed_steps(tr, loader, switch, True)
        gan_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params = dict(tr.model.named_parameters())
        if not all(torch.equal(before[n], params[n]) for n in before if n.startswith("encoder.")):
            raise AssertionError("stage 1_3 moved the encoder, which the GAN stages freeze")
        if all(torch.equal(before[n], params[n]) for n in before if n.startswith("decoder.")):
            raise AssertionError("stage 1_3: the decoder did not move")
        n13 = tr.state.step
        tr.save(n13)
        d_sd = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
        del tr, params, before
        torch.cuda.empty_cache()

        # stage 3 boots from 1_3's, optimizer and discriminator included
        tr = build_trainer(training_opt("3", root, dict(
            exp="exp1_stage1_3", iter=n13, load_optimizer=True, load_scheduler=False,
            strict=True)))
        g_opt = tr.state.g_opt
        if (int(g_opt.sched_count), int(g_opt.count)) != (0, n13):
            raise AssertionError(f"stage 3 boot: schedule count {int(g_opt.sched_count)}, Adam "
                                 f"count {int(g_opt.count)}; expected 0 and {n13}")
        if any(not torch.equal(v, tr.state.disc.state_dict()[k]) for k, v in d_sd.items()):
            raise AssertionError("stage 3 boot: the discriminator is not 1_3's")
        loaders.append(tr.train_loader.infinite())
        s3, _, _ = timed_steps(tr, loaders[-1], switch, True, n=2)
        moved = [n for n, p in tr.model.named_parameters()
                 if n in frozen0 and not torch.equal(frozen0[n], p)]
        if moved:
            raise AssertionError(f"the frozen VQGAN prior moved: {moved[:5]}")
        t = time.perf_counter()
        val = tr.validate(tr.state.step, max_samples=2)
        val_s = time.perf_counter() - t
        if not (val and all(np.isfinite(v) for v in val.values()) and val["ms_ssim"] > 0):
            raise AssertionError(f"validation gave {val}")
        del tr
        torch.cuda.empty_cache()
    finally:
        for it in loaders:
            it.close()
        shutil.rmtree(root, ignore_errors=True)
        switch(torch.nn.Module(), True)

    rows = time_backward_kernels(shapes, dev, gen)
    warm = lambda secs: float(np.median(secs[1:]))
    print(f"training steps, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, f32 (host clock "
          f"around the step, ending in torch.cuda.synchronize(); medians of {TRAIN_STEPS - 1} "
          f"warm steps; {smi}): RD (stage 1_2) kernels off {warm(rd_off):.4f} s, on "
          f"{warm(rd_on):.4f} s ({TRAIN_BATCH / warm(rd_on):.2f} images/s); GAN (stage 1_3) "
          f"off {warm(gan_off):.4f} s, on {warm(gan_on):.4f} s "
          f"({TRAIN_BATCH / warm(gan_on):.2f} images/s); stage 3 "
          f"{', '.join(f'{x:.4f}' for x in s3)} s")
    print(f"peak device memory with the kernels on: RD step {rd_peak:.2f} GiB, GAN step "
          f"{gan_peak:.2f} GiB (model, optimizer states and activations)")
    print(f"launches per RD step {rd_launched['forward']}, Function backwards "
          f"{rd_launched['backward']}; per GAN step {gan_launched['forward']}, backwards "
          f"{gan_launched['backward']}")
    print(f"stage 1_2 -> 1_3 -> 3: checkpoints at {n12} and {n13} steps booted, the frozen "
          f"prior bit-identical, validation on two 768x512 images at four beta corners "
          f"{val_s:.1f} s ({val}); worst gradient error {worst:.3e}; training phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    out = {}
    for name in ("vq_argmin", "flash_attention", "gn_channel_sums", "gn_apply", "conv3x3_same",
                 "conv3x3_gn_swish"):
        out[name] = dict(rows.get(name, {}),
                         train_launches_rd_step=rd_launched["forward"][name],
                         train_backwards_rd_step=rd_launched["backward"].get(name, 0),
                         train_launches_gan_step=gan_launched["forward"][name],
                         train_backwards_gan_step=gan_launched["backward"].get(name, 0))
    return dict(kernels=out, rd_s=(warm(rd_off), warm(rd_on)),
                gan_s=(warm(gan_off), warm(gan_on)), peak_gib=(rd_peak, gan_peak),
                worst_grad_rel_l2=worst)


# ------------------------------------------------------- evaluation (item 14)

EVAL_IMAGES = 50          # FID's minimum (metrics/fid.py MIN_IMAGES)
EVAL_SIZE = (768, 512)
EVAL_BATCH = 16
HOST_PAIRS = 2            # reals and reconstructions the host CPU recomputes
CALIB_IMAGES = 18         # crops the rate search runs over: one batch of 16 and a remainder
CALIB_BATCH = 16
BETA_VQS = (1.0, 3.0)     # the rate search's cut sweep
# bpp inside the range the random-weight model spans at both beta_vq (about
# 0.254 to 0.260 over beta_rate 0 to 3 at 18 crops: random weights leave the
# rate nearly flat in beta_rate)
TARGET_RATES = (0.256, 0.258)
METRIC_TOL = 1e-4         # LPIPS and DISTS, card against host CPU
POOL3_RTOL, POOL3_ATOL = 1e-3, 1e-5    # Inception pool3 features, card against host CPU
RD_STEPS = 4              # RD steps with LPIPS; the first is not warm


def counted_run(module, run, rans=(0, 0)):
    """``run()`` with every launch counter set to 0 just before it and read
    just after, held against the shape rules for the modules that ran, with
    ``rans`` = (R1, R2) launches expected. Returns (run's result,
    launches)."""
    import torch
    from dc_vic_tpu_torch.ops import counts
    want, _, handles = expected_launch_recorder(module)
    want.update(rans_encode_pack=rans[0], rans_decode_section=rans[1])
    counts.reset()
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    got = counts.launches()
    if got != want:
        raise AssertionError(f"launches {got}, the shape rules give {want}")
    return result, got


def check_metric_nets(paths, reals, fakes, smi, dev):
    """The evaluation networks loaded through their loaders on the card and
    on the host CPU: LPIPS and DISTS on the first HOST_PAIRS pairs within
    METRIC_TOL, Inception's pool3 features of their patches within
    POOL3_RTOL; timed on the card. Returns (the card's networks, times)."""
    import torch
    from dc_vic_tpu_torch.metrics.feature_nets import load_dists, load_lpips
    from dc_vic_tpu_torch.metrics.fid import collect_patches
    from dc_vic_tpu_torch.metrics.inception import load_inception
    from dc_vic_tpu_torch.tools.calc_metrics import to_pm1
    card = dict(lpips=load_lpips(paths["lpips_alex"], "alex", dev),
                dists=load_dists(paths["dists"], dev),
                inception=load_inception(paths["inception"], dev))
    host = dict(lpips=load_lpips(paths["lpips_alex"], "alex", device="cpu"),
                dists=load_dists(paths["dists"], device="cpu"),
                inception=load_inception(paths["inception"], device="cpu"))
    nchw = lambda a, dev: torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(dev)
    worst = {}
    with torch.no_grad():
        for name, scale in (("lpips", to_pm1), ("dists", lambda u8: u8 / np.float32(255))):
            got = [float(card[name](nchw(scale(r)[None], dev), nchw(scale(f)[None], dev)))
                   for r, f in zip(reals[:HOST_PAIRS], fakes[:HOST_PAIRS])]
            want = [float(host[name](nchw(scale(r)[None], "cpu"), nchw(scale(f)[None], "cpu")))
                    for r, f in zip(reals[:HOST_PAIRS], fakes[:HOST_PAIRS])]
            worst[name] = float(np.max(np.abs(np.subtract(got, want))))
            if not np.all(np.isfinite(got)) or worst[name] > METRIC_TOL:
                raise AssertionError(f"{name} on the card {got}, on the host {want}")
    patches = np.stack(collect_patches(list(reals[:HOST_PAIRS])))
    got, want = card["inception"](patches), host["inception"](patches)
    # each feature within POOL3_RTOL of the host's, plus POOL3_ATOL for those
    # near 0: the worst share of that allowance used
    worst["pool3"] = float(np.max(np.abs(got - want) / (POOL3_ATOL + POOL3_RTOL * np.abs(want))))
    if got.shape != (len(patches), 2048) or worst["pool3"] > 1.0:
        raise AssertionError(f"pool3 features on the card differ from the host's: "
                             f"{worst['pool3']:.3f} of the allowance")
    # Inception as FID calls it: uint8 patches from the host, features back
    batch = np.stack(collect_patches(list(reals[:4]))[:32])
    card["inception"](batch)
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        card["inception"](batch)
        secs.append(time.perf_counter() - t)
    with torch.no_grad():
        a = nchw(to_pm1(reals[0])[None], dev)
        b = nchw(to_pm1(fakes[0])[None], dev)
        lpips_ms = _time_ms(card["lpips"], a, b)
        dists_ms = _time_ms(card["dists"], (a + 1) / 2, (b + 1) / 2)
    times = dict(inception_patches_per_s=len(batch) / float(np.median(secs)),
                 lpips_ms_per_image=lpips_ms, dists_ms_per_image=dists_ms)
    print(f"metric networks on the card against the host CPU ({HOST_PAIRS} pairs of "
          f"{reals[0].shape[0]}x{reals[0].shape[1]}, {len(patches)} patches): worst LPIPS "
          f"{worst['lpips']:.2e}, DISTS {worst['dists']:.2e} (atol {METRIC_TOL}), pool3 "
          f"{worst['pool3']:.3f} of its allowance (rtol {POOL3_RTOL}, atol {POOL3_ATOL}); "
          f"Inception "
          f"{times['inception_patches_per_s']:.1f} patches/s at batch 32 (host clock, "
          f"uint8 in, features out), LPIPS(alex) {lpips_ms:.3f} ms and DISTS "
          f"{dists_ms:.3f} ms per {reals[0].shape[0]}x{reals[0].shape[1]} image (CUDA "
          f"events; {smi})")
    return card, dict(times, **{f"worst_{k}": v for k, v in worst.items()})


def check_evaluation(opt, sd, smi, dev):
    """Item 14 of the module docstring. Returns {kernel name: its launches
    in this phase}, and the phase's figures."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.metrics.fid import MIN_IMAGES
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.tools import beta_selection, binary_rate_search
    from dc_vic_tpu_torch.tools import compress as cli
    from dc_vic_tpu_torch.tools.build_val_dataset import crop_and_tokenize
    from dc_vic_tpu_torch.tools.calc_metrics import calc_metrics_arrays, to_pm1
    from dc_vic_tpu_torch.tools.workload import metric_state_dicts, smooth_images
    from dc_vic_tpu_torch.train.trainer import build_trainer
    from dc_vic_tpu_torch.utils.backends import backend_flags
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_eval_")
    figures, launches = {}, {}
    try:
        paths = {}
        for name, state in metric_state_dicts(0).items():
            paths[name] = os.path.join(root, f"{name}.pth")
            torch.save({k: torch.from_numpy(v) for k, v in state.items()}, paths[name])
        spec = build_comp_model(opt, dev, recon_kernels=RECON_KERNELS)
        spec.module.load_state_dict(sd, strict=True)
        module = spec.module.eval()
        codec = Codec(spec, encode_backend="device", lanes=512)

        # (1) the compress CLI's body over fifty 768x512 images
        reals = smooth_images(EVAL_IMAGES, *EVAL_SIZE)
        named = [(f"img{i:02d}.png", a) for i, a in enumerate(reals)]
        chunks = -(-EVAL_IMAGES // EVAL_BATCH)
        t = time.perf_counter()
        (rows, decoded), launches["compress_50"] = counted_run(
            module, lambda: cli.compress_arrays(
                codec, named, 0, os.path.join(root, "out"), batch_size=EVAL_BATCH,
                selfcheck=True, decompress=True),
            rans=(2 * chunks, 2 * chunks * (1 + codec.y_sections)))
        compress_s = time.perf_counter() - t
        fakes = np.stack([decoded[n] for n, _ in named])
        if fakes.shape != reals.shape or fakes.dtype != np.uint8:
            raise AssertionError(f"decoded {fakes.shape} {fakes.dtype}")
        missing = [k for k, n in launches["compress_50"].items() if n < 1]
        if missing:
            raise AssertionError(f"the evaluation's compress never launched {missing}")
        with open(os.path.join(root, "out", "_avg_bitrate.json")) as f:
            bitrate = json.load(f)["avg_bpp"]
        print(f"compress_arrays, {EVAL_IMAGES} images {EVAL_SIZE[0]}x{EVAL_SIZE[1]}, tpu "
              f"format, device backend, lanes 512, reconstruction kernels on, batch "
              f"{EVAL_BATCH} ({chunks} chunks), "
              f"selfcheck and decompress: {compress_s:.2f} s, {bitrate:.4f} bpp; launches "
              f"{launches['compress_50']}")

        # (2) the metrics: the networks on the card held to the host CPU,
        # then calc_metrics over the fifty pairs
        nets, times = check_metric_nets(paths, reals, fakes, smi, dev)
        figures.update(times)
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = calc_metrics_arrays(list(reals), list(fakes), nets["lpips"], nets["dists"],
                                      nets["inception"], bitrate)
        figures["calc_metrics_s"] = time.perf_counter() - t
        if (metrics["skipped"] or metrics["num_images"] != EVAL_IMAGES
                or not all(np.isfinite(metrics[k]) for k in ("psnr", "ms_ssim", "fid",
                                                              "lpips", "dists"))):
            raise AssertionError(f"calc_metrics gave {metrics}")
        print(f"calc_metrics over {EVAL_IMAGES} pairs (random network weights, seed 0): "
              f"{metrics}; {figures['calc_metrics_s']:.2f} s (host clock)")

        # (3) the validation set and the rate search on both paths
        t = time.perf_counter()
        names, crops, maps = crop_and_tokenize(module, list(reals), np.random.default_rng(0),
                                               num_images=EVAL_IMAGES, crop=256,
                                               batch_size=EVAL_BATCH)
        if crops.shape != (EVAL_IMAGES, 256, 256, 3) or maps.shape != (EVAL_IMAGES, 32, 32) \
                or maps.dtype != np.uint8:
            raise AssertionError(f"validation set {crops.shape}, token maps {maps.shape} "
                                 f"{maps.dtype}")
        print(f"build_val_dataset: {len(names)} crops 256x256 and uint8 token maps "
              f"{maps.shape[1:]} in {time.perf_counter() - t:.2f} s")
        imgs = to_pm1(crops)
        sub = slice(0, CALIB_IMAGES)
        avg = {"token maps": binary_rate_search.make_avg_bpp(module, imgs[sub], CALIB_BATCH,
                                                             maps[sub]),
               "forward": binary_rate_search.make_avg_bpp(module, imgs[sub], CALIB_BATCH)}
        rem = CALIB_IMAGES % CALIB_BATCH
        for label, fn in avg.items():
            _, launches[f"probe_{label}"] = counted_run(module, lambda: fn(1.5, 2.0))
        curve = {bv: [(br, round(avg["token maps"](br, bv), 5))
                      for br in (0.0, 0.75, 1.5, 2.25, spec.max_beta_rate)] for bv in BETA_VQS}
        print(f"estimated bpp of {CALIB_IMAGES} crops by beta_rate, for beta_vq {BETA_VQS}: "
              f"{curve}")
        results, secs, probes = {}, {}, {}
        for label, fn in avg.items():
            calls = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            results[label] = binary_rate_search.search(
                lambda br, bv, fn=fn, calls=calls: calls.append(br) or fn(br, bv), BETA_VQS,
                TARGET_RATES, spec.max_beta_rate)
            secs[label], probes[label] = time.perf_counter() - t, len(calls)
        for a, b in zip(results["token maps"], results["forward"]):
            if (a["beta_rate"] != b["beta_rate"]
                    or not np.isclose(a["achieved_bpp"], b["achieved_bpp"], rtol=1e-5, atol=0)):
                raise AssertionError(f"the search's paths disagree: {a} against {b}")
            if abs(a["achieved_bpp"] - a["target_rate"]) > binary_rate_search.TOL:
                raise AssertionError(f"the search missed its target: {a}")
        figures.update(rate_search_s=secs, rate_search_probes=probes)
        print(f"binary_rate_search over {CALIB_IMAGES} crops (batch {CALIB_BATCH} and a "
              f"remainder of {rem}), beta_vq {BETA_VQS}, targets {TARGET_RATES}: "
              f"{results['forward']}; the token-map path agrees to rtol 1e-5; probes "
              f"{probes}, seconds {secs} (host clock)")

        # (4) beta selection on two of the search's candidates, with FID
        cands = [results["forward"][0], results["forward"][len(TARGET_RATES)]]
        feats = nets["inception"]
        t = time.perf_counter()
        chosen = beta_selection.score_candidates(
            cands, imgs, beta_selection.make_reconstruct(module, imgs, EVAL_BATCH), feats)
        figures["beta_selection_s"] = time.perf_counter() - t
        if (len(imgs) < MIN_IMAGES or not all(r["fid_in_score"] and np.isfinite(r["score"])
                                              for r in chosen)
                or sum(r["selected"] for r in chosen) != 1):
            raise AssertionError(f"beta_selection gave {chosen}")
        print(f"beta_selection of {len(cands)} candidates over {len(imgs)} crops with FID: "
              f"{chosen}; {figures['beta_selection_s']:.2f} s (host clock)")
        del codec, module, spec, nets
        torch.cuda.empty_cache()

        # (5) RD steps with the real (random) LPIPS, and the LPIPS loss's
        # forward and backward alone on the same batch
        _training_images(os.path.join(root, "train"))
        train_opt = training_opt("1_2", os.path.join(root, "train"))
        train_opt["lpips_weights"] = paths["lpips_alex"]
        tr = build_trainer(train_opt, dev)
        if tr.lpips_fn is None:
            raise AssertionError("the trainer did not load the LPIPS weights")
        loader = tr.train_loader.infinite()
        try:
            batch = tr._to_device(next(loader)["real_images"])
            secs = []
            for _ in range(RD_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                terms = tr.step(batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                if not all(np.isfinite(float(v)) for v in terms.values()):
                    raise AssertionError(f"an RD step with LPIPS gave {terms}")
        finally:
            loader.close()
        fake = (batch + 0.05 * torch.randn_like(batch)).requires_grad_(True)
        # the backend settings the trainer's steps run with
        with backend_flags(allow_tf32=False, deterministic=False, benchmark=True):
            lpips_ms = _time_ms(lambda: tr.lpips_fn(batch, fake).mean().backward())
        step_s = float(np.median(secs[1:]))
        figures.update(rd_step_s=step_s, lpips_fwd_bwd_ms=lpips_ms)
        print(f"RD step (stage 1_2, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, kernels "
              f"on, LPIPS(alex) as lpips_weights) {step_s:.4f} s (host clock, median of "
              f"{RD_STEPS - 1} warm steps); LPIPS forward + backward on that batch "
              f"{lpips_ms:.3f} ms (CUDA events), {lpips_ms / 10 / step_s:.2f}% of the step "
              f"({smi})")
        del tr
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    figures["phase_s"] = time.perf_counter() - t_phase
    print(f"evaluation and calibration phase {figures['phase_s']:.1f} s")
    return launches, figures


# ------------------------------------------- the rest of the model family (item 15)

# the beta FiLM of the dual-beta ELIC transforms: what stage 1_1 cannot carry
FILM_KEYS = ("encoder.mlp.", "encoder.beta_ft_list.", "decoder.mlp.", "decoder.beta_ft_list.",
             "decoder.init_fuse.")
ONE_SECTION = (4, 192, 48, 32)   # y of four 768x512 images without ChARM: one section
# stage 1_1's gradient comparison: the same cuDNN algorithms in both runs
DETERMINISTIC = dict(allow_tf32=False, deterministic=True, benchmark=False)
VARIANT_BETAS = (0.0, 0.0)       # the betas a model that selects no beta pairs is given


def check_stage1_1(smi, dev):
    """Item 15 (a): stage 1_1 of the curriculum at full width, then its
    hand-off to stage 1_2. The encoder keeps seed 0's weights unscaled:
    scaled by 0.55, as the codec items have it, stage 1_1's y rounds to 0
    everywhere, the decoder and the estimator see an all-zero map (no FiLM
    shifts it, as in stage 1_2), and each of the estimator's eighteen Swin
    LayerNorms multiplies the gradient by 1 / sqrt(1e-6): past 1e38 it is no
    longer finite, on the card and on the host CPU alike. The gradients with
    the kernels off and on are compared under DETERMINISTIC: under the
    trainer's flags (cuDNN free to choose its algorithms) two runs of one
    route already differ in the hyperprior's gradients by nearly GRAD_TOL,
    under DETERMINISTIC each route repeats bit for bit. K2 stays on in both
    runs: here it runs before the fusion taps and carries no gradient (no
    Function backward), so all it can change is the operating point, and
    switched with the others it brought the worst error close to GRAD_TOL,
    as a near-tie of the VQ targets would (which compare_training_gradients
    pins for that reason). The comparison holds K3 to K6, the kernels whose
    backwards the step runs. Returns the
    step's launches."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.models import (RECON_KERNELS, build_comp_model, init_weights,
                                         set_recon_kernels)
    from dc_vic_tpu_torch.ops import attention
    from dc_vic_tpu_torch.train.trainer import build_trainer
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_stage11_")
    switch = _KernelSwitch(attention)
    loaders = []
    try:
        _training_images(root)
        tr = build_trainer(training_opt("1_1", root))
        if tr.model.use_beta or tr.policy.sample(tr.state.generator, 2) != (None, None):
            raise AssertionError("stage 1_1 sampled betas")
        frozen0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                   if n.startswith("vq_model.")}
        loaders.append(tr.train_loader.infinite())
        loader = loaders[-1]
        batch = tr._to_device(next(loader)["real_images"])
        with torch.no_grad():
            nonzero = float((tr.model.extract_y_hat(batch) != 0).float().mean())
        if nonzero == 0:
            raise AssertionError("stage 1_1: y_hat is 0 everywhere, the decoder sees nothing")
        print(f"stage 1_1 trainer ({type(tr.model.encoder).__name__}, "
              f"{type(tr.model.decoder).__name__}, f32, random weights from seed 0): "
              f"{sum(p.numel() for p in tr.model.parameters())} parameters; "
              f"{nonzero:.2%} of the first batch's y_hat is not 0")
        worst = compare_training_gradients(
            tr, batch, lambda module, on: set_recon_kernels(module, RECON_KERNELS if on else ()),
            DETERMINISTIC)
        before = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                  if n.startswith(("encoder.", "decoder."))}
        off, _, _ = timed_steps(tr, loader, switch, False)
        torch.cuda.reset_peak_memory_stats()
        on, launched, _ = timed_steps(tr, loader, switch, True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params = dict(tr.model.named_parameters())
        for part in ("encoder.", "decoder."):
            if all(torch.equal(before[n], params[n]) for n in before if n.startswith(part)):
                raise AssertionError(f"stage 1_1: the {part[:-1]} did not move")
        moved = [n for n in frozen0 if not torch.equal(frozen0[n], params[n])]
        if moved:
            raise AssertionError(f"stage 1_1 moved the frozen VQGAN prior: {moved[:5]}")
        n11 = tr.state.step
        tr.save(n11)
        saved = {k: v.clone() for k, v in tr.model.state_dict().items()}
        del tr, params, before, frozen0
        torch.cuda.empty_cache()

        # stage 1_2 boots from it with the shipped knobs
        opt12 = training_opt("1_2", root, dict(exp="exp1_stage1_1", iter=n11,
                                                load_optimizer=False, load_scheduler=False,
                                                strict=False))
        tr = build_trainer(opt12)
        init = build_comp_model(opt12, dev).module
        init_weights(init, torch.Generator(device=dev).manual_seed(int(opt12.get("seed", 0))))
        booted, fresh = tr.model.state_dict(), init.state_dict()
        film = sorted(k for k in booted if k.startswith(FILM_KEYS))
        if set(booted) - set(film) != set(saved):
            raise AssertionError("stage 1_2 boot: the carried keys are not stage 1_1's")
        bad = [k for k in saved if not torch.equal(booted[k], saved[k])]
        bad += [k for k in film if not torch.equal(booted[k], fresh[k])]
        if bad or not film:
            raise AssertionError(f"stage 1_2 boot: {bad[:5]} not as carried or initialised")
        del init, fresh, saved
        loaders.append(tr.train_loader.infinite())
        s12, _, _ = timed_steps(tr, loaders[-1], switch, True, n=1)
        print(f"stage 1_2 booted from stage 1_1's checkpoint at {n11} steps (strict false): "
              f"{len(booted) - len(film)} tensors carried bit-exactly, {len(film)} beta-FiLM "
              f"tensors at their initialisation; one 1_2 step {s12[0]:.4f} s")
        del tr, booted
        torch.cuda.empty_cache()
    finally:
        for it in loaders:
            it.close()
        shutil.rmtree(root, ignore_errors=True)
        switch(torch.nn.Module(), True)
    warm = lambda secs: float(np.median(secs[1:]))
    print(f"stage 1_1 RD steps, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, f32 (host "
          f"clock, medians of {TRAIN_STEPS - 1} warm steps; {smi}): kernels off "
          f"{warm(off):.4f} s, on {warm(on):.4f} s ({TRAIN_BATCH / warm(on):.2f} images/s); "
          f"peak device memory with the kernels on {peak:.2f} GiB; launches per step "
          f"{launched['forward']}, Function backwards {launched['backward']}; worst gradient "
          f"error {worst:.3e}; phase {time.perf_counter() - t_phase:.1f} s")
    return launched


def variant_opts():
    """The two codec models of item 15: config/exp1_stage1_1.yaml's
    HyperpriorCharmVicModel, and config/dc_vic_patchgan.yaml as a
    HyperpriorDualCondVicModel (hyper_out_ch 384: the means and scales of
    192 channels, the widths the JAX package builds for that type)."""
    from dc_vic_tpu_torch.utils.config import load_config
    stage11 = load_config(os.path.join(ROOT, "config", "exp1_stage1_1.yaml"))
    dual = load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    dual["model"]["type"] = "HyperpriorDualCondVicModel"
    dual["subnet"]["hyperdecoder"]["hyper_out_ch"] = 384
    return {"HyperpriorCharmVicModel": stage11, "HyperpriorDualCondVicModel": dual}


def check_variants(flagship, smi, dev):
    """Item 15 (b): both models' codecs at full width, batch 4 768x512,
    every reconstruction kernel on, in the compressai format (the ChARM
    model's chain on the card, the other's on the host CPU) and the tpu
    format (device backend, lanes 512, decode chain sync-free). Each round
    trip is bit-exact and its launches are held to the shape rules and to
    the flagship's (``flagship``: format -> launches): the same K1 to K6,
    R1 twice per compress, R2 once per y section and once for z. Returns
    {model/format: launches}."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model, init_weights
    from dc_vic_tpu_torch.tools.workload import scale_encoder, smooth_images
    images = smooth_images(4, 768, 512)
    launches = {}
    for name, opt in variant_opts().items():
        spec = build_comp_model(opt, recon_kernels=RECON_KERNELS)
        init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
        spec.module.load_state_dict(scale_encoder(spec.module.state_dict()))
        m = spec.module
        betas = None if spec.selected_beta_rate else VARIANT_BETAS
        print(f"{name} (use_charm {m.use_charm}, use_beta {m.use_beta}): "
              f"{sum(p.numel() for p in m.parameters())} parameters"
              + ("" if betas is None else f"; no beta pairs selected, driven at betas "
                                          f"{betas}"))
        codecs = {"compressai": Codec(spec, stream_format="compressai",
                                      params_backend="accel" if m.use_charm else "cpu"),
                  "tpu": Codec(spec, encode_backend="device", lanes=512)}
        for fmt, codec in codecs.items():
            label = f"{name}, {fmt} format, kernels on, batch 4 768x512"
            _, got, _ = counted_round_trip(codec, images, label, betas,
                                           sync_free=fmt == "tpu")
            want = dict(flagship[fmt])
            if fmt == "tpu":
                want["rans_decode_section"] = 1 + (6 if m.use_charm else 1)
            if got != want:
                raise AssertionError(f"{label}: launches {got}, the flagship's path gives {want}")
            res, _, enc, dec = drive(codec, images, betas)
            launches[f"{name}/{fmt}"] = got
            print(f"{label}: warm encode {enc:.4f} s, decode {dec:.4f} s, "
                  f"{float(np.mean([r['bpp'] for r in res])):.4f} bpp ({smi})")
        del codecs, spec, m
        torch.cuda.empty_cache()
    return launches


def check_one_section(rd, rans_host, dev):
    """Item 15 (c): R1 and R2 on the y stream of a model without ChARM,
    one section of 4 x 192 x 48 x 32 symbols, six times the flagship's
    section: against their plain versions and the host coder (lanes 128
    and 512, the three symbol mixes; R2's symbols and consumed words also
    against the host decoder), then R2 timed at lanes 512 beside its
    dependent chain. Returns the keys this adds to R1's and R2's entries."""
    import torch
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional, get_scale_table
    y_host = GaussianConditional().build_cdf_table(get_scale_table())
    table = rd.DeviceCdfTable(y_host, dev)
    rng = np.random.default_rng(15)
    B, C, H, W = ONE_SECTION
    kept = {}
    for lanes in (128, 512):
        L = rd.section_lanes(C * H * W, lanes)
        for mix in RANS_MIXES:
            sym, idx, words, base, counts = kept[lanes, mix] = _rans_case(
                rd, rans_host, dev, y_host, table, ONE_SECTION, 1, lanes, mix, rng,
                f"R1/R2 one y section {list(ONE_SECTION)} ({C * H * W // L} steps), lanes "
                f"{lanes}, {mix}")
            words_np = words.cpu().numpy().view(np.uint16)
            rows = rd.to_stream(idx, L).cpu().numpy()
            want = rd.to_stream(sym, L).cpu().numpy()
            for b in range(B):
                o, n = int(base[b]), int(counts[b])
                dec, used = rans_host.tpu_decode_stream(words_np[o:o + n], [rows[b]], y_host)
                if used != n or not np.array_equal(dec[0], want[b]):
                    raise AssertionError(f"one section, lanes {lanes}, {mix}: the host "
                                         f"decoder reads other symbols or words, image {b}")
    print("one y section: R2's symbols and consumed words equal the host decoder's")
    sym, idx, words, base, counts = kept[512, "no escapes"]
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    L = rd.section_lanes(C * H * W, 512)
    steps = C * H * W // L
    r2 = _time_ms(rd.decode_section, words, base, zero, None, idx, ONE_SECTION, 512, table)
    r1 = _time_ms(rd.encode_pack, sym, idx, 1, 512, table)
    r2_plain = _time_ms(rd.decode_section_plain, words, base, zero, None,
                        rd.to_stream(idx, L), table, reps=1)
    # one step's latency: a single warp (batch 1, 32 lanes) leaves nothing else
    p1, _, c1, _, _ = rd.encode_pack(sym[:1].contiguous(), idx[:1].contiguous(), 1, 32, table)
    z1 = torch.zeros(1, dtype=torch.int32, device=dev)
    r2_step = _time_ms(rd.decode_section, p1[:int(c1[0])].contiguous(), z1, z1, None,
                       idx[:1].contiguous(), (1, C, H, W), 32, table) / (C * H * W // 32)
    chain = steps * r2_step
    print(f"one y section at lanes 512 ({steps} steps): R2 kernel {r2:.4f} ms, plain "
          f"{r2_plain:.1f} ms, dependent chain {chain:.4f} ms ({chain / r2:.0%} of the "
          f"kernel's time); R1 over the whole stream {r1:.4f} ms")
    return ({"ms_one_section_lanes512": r1},
            {"ms_one_section_lanes512": r2, "plain_ms_one_section_lanes512": r2_plain,
             "chain_ms_one_section_lanes512": chain, "steps_one_section_lanes512": steps})



# ------------------------------- the OASIS stage and the codec profiler (item 16)

OASIS_TRAINER = "DualBetaCondOasisGanDistortionVqFusionTrainer"
# the JAX package's own test value (tests/test_saver_oasis.py); no shipped config sets one
OASIS_LOSS = {"type": "OasisGANLoss", "loss_weight": 0.01}
# the two classes of item 16 (b), at the flagship's widths
OASIS_N_LAYERS2 = {"type": "OasisDualBetaCondTamingNLayerDiscriminator", "ndf": 64,
                   "n_embed": 256, "n_layers": 2, "cond_ch": 8, "L": 10, "norm_type": "none",
                   "max_beta_1": 3.0, "max_beta_2": 3.5, "weight_init": True}
FILM_DISC = {"type": "DualBetaFtTamingNLayerDiscriminator", "ndf": 64, "n_layers": 3,
             "cond_ch": 64, "L": 10, "norm_type": "none", "max_beta_1": 3.0,
             "max_beta_2": 3.5, "weight_init": True}
# K1 to K6 by kernel name, and their Functions' backwards by autograd node
OWN_KERNELS = ("vq_argmin_kernel", "flash_attn_f32_kernel", "gn_channel_sums_kernel",
               "gn_apply_kernel", "conv3x3_same_kernel", "conv3x3_gn_swish_kernel",
               "conv3x3_bf16_kernel")
OWN_BACKWARDS = ("_FlashAttentionBackward", "_ChannelSumsBackward", "_ApplyAffineBackward",
                 "_Conv3x3SameBackward", "_Conv3x3GnSwishBackward")
PROFILE_ROUNDS = 3


def oasis_opt(root, discriminator=None, load=None, exp="oasis"):
    """Stage 1_3 (``training_opt``) as the OASIS stage: its trainer, the
    OASIS loss and the discriminator block of config/dc_vic_oasis.yaml (the
    dual-beta PatchGAN with keep_shape and 257 classes: 256 / 8 = 32 logits
    a side, the token grid), or ``discriminator``."""
    from dc_vic_tpu_torch.utils.config import load_config
    opt = training_opt("1_3", root, load)
    opt["trainer"]["type"] = OASIS_TRAINER
    opt["loss"]["gan_loss"] = dict(OASIS_LOSS)
    opt["discriminator"] = discriminator or load_config(
        os.path.join(ROOT, "config", "dc_vic_oasis.yaml"))["discriminator"]
    opt["exp"] = exp
    return opt


def film_opt(root):
    """Stage 1_3 (``training_opt``) with the FiLM discriminator (FILM_DISC)."""
    opt = training_opt("1_3", root)
    opt["discriminator"] = dict(FILM_DISC)
    opt["exp"] = "film"
    return opt


def compare_oasis_gradients(tr, batch):
    """Item 16 (a): one OASIS GAN step's gradients, the generator's trained
    parameters' and the discriminator's, with K3 to K6 off and on under
    DETERMINISTIC (K2 on in both, as in item 15), the same betas, noise and
    (pinned) token maps. Returns the worst relative error."""
    import torch
    from dc_vic_tpu_torch.codec.ops import Noise
    from dc_vic_tpu_torch.models import RECON_KERNELS, set_recon_kernels
    from dc_vic_tpu_torch.train.steps import gan_d_loss, gan_g_losses
    from dc_vic_tpu_torch.utils.backends import backend_flags
    model, disc = tr.model, tr.state.disc
    beta_rate, beta_vq = tr.policy.sample(tr.state.generator, batch.shape[0])
    with torch.no_grad():
        codes = model.vq_encode(batch)
    model.vq_encode = lambda x: codes
    grads = {}

    def run():
        with backend_flags(**DETERMINISTIC):
            disc.requires_grad_(False)
            try:
                g_total, _, out = gan_g_losses(
                    model, disc, tr.losses, batch, beta_rate, beta_vq, tr.policy,
                    Noise(torch.Generator(batch.device).manual_seed(1)), tr.lpips_fn, oasis=True)
                g_total.backward()
            finally:
                disc.requires_grad_(True)
            tokens = out["gt_vq_indices"]
            d_total = gan_d_loss(disc, tr.losses["gan_loss"], batch, out["fake_images"],
                                 beta_rate, beta_vq, real_tokens=tokens, fake_tokens=tokens)
            d_total.backward()
        return g_total, d_total

    try:
        for on in (False, True):
            set_recon_kernels(model, RECON_KERNELS if on else ())
            for p in (*model.parameters(), *disc.parameters()):
                p.grad = None
            (g_total, d_total), launched, _ = recorded_step(model, run)
            grads[on] = {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}
            grads[on].update({f"disc.{n}": p.grad.clone() for n, p in disc.named_parameters()
                              if p.grad is not None})
            print(f"OASIS GAN step gradients, kernels {'on' if on else 'off'}: G loss "
                  f"{float(g_total.detach()):.6f}, D loss {float(d_total.detach()):.6f}; "
                  f"launches {launched['forward']}; Function backwards {launched['backward']}")
    finally:
        del model.vq_encode
        set_recon_kernels(model, RECON_KERNELS)
    trained = [n for n, m in tr.main_mask.items() if m]
    trained += [f"disc.{n}" for n, _ in disc.named_parameters()]
    return hold_gradients(grads, trained, "OASIS GAN step")


def own_share(prof):
    """One profiled step: (device ms in all, in K1 to K6's own kernels, in
    the kernels their Functions' backwards launch)."""
    from dc_vic_tpu_torch.utils.profiling import kernel_times
    times = kernel_times(prof)
    total = sum(us for us, _ in times.values())
    own = sum(us for name, (us, _) in times.items() if any(k in name for k in OWN_KERNELS))
    bwd = 0.0
    for evt in prof.events():
        if evt.name.startswith("autograd::engine::evaluate_function: ") and \
                evt.name.split(": ", 1)[1] in OWN_BACKWARDS:
            us = getattr(evt, "device_time_total", None)
            bwd += float(evt.cuda_time_total if us is None else us)
    if total <= 0:
        raise AssertionError("the profiler recorded no device time")
    return total / 1e3, own / 1e3, bwd / 1e3


def warm_step_peak(tr, loader):
    """Peak device memory (GiB) of one more step of the trainer as it is:
    its cuDNN algorithms already chosen, so no search's workspace counts."""
    import torch
    batch = tr._to_device(next(loader)["real_images"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    terms = tr.step(batch)
    torch.cuda.synchronize()
    if float(terms["skipped"]):
        raise AssertionError(f"a training step gave {terms}")
    return torch.cuda.max_memory_allocated() / 2 ** 30


def check_oasis(smi, dev):
    """Item 16 (a), (b) and (d) of the module docstring. Returns the OASIS
    step's launches and Function backwards (kernels on, without
    mc_sampling) and the figures PERF.md records."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.ops import attention
    from dc_vic_tpu_torch.train.trainer import build_trainer
    from dc_vic_tpu_torch.utils.profiling import device_trace, kernel_report, kernel_times
    root = tempfile.mkdtemp(prefix="dcvic_oasis_")
    switch = _KernelSwitch(attention)
    loaders = []
    warm = lambda secs: float(np.median(secs[1:]))
    try:
        _training_images(root)
        t = time.perf_counter()
        tr = build_trainer(oasis_opt(root))
        if not (tr.gan and tr.oasis) or type(tr.state.disc).__name__ != \
                "DualBetaCondTamingNLayerDiscriminator":
            raise AssertionError(f"the OASIS trainer built {type(tr.state.disc).__name__}")
        loaders.append(tr.train_loader.infinite())
        loader = loaders[-1]
        batch = tr._to_device(next(loader)["real_images"])
        b = torch.ones(TRAIN_BATCH, device=dev)
        with torch.no_grad():
            shape = tuple(tr.state.disc(batch, b, b).shape)
        if shape != (TRAIN_BATCH, 257, TRAIN_CROP // 8, TRAIN_CROP // 8):
            raise AssertionError(f"the OASIS discriminator's logits are {shape}")
        print(f"OASIS stage trainer (flagship, f32, random weights from seed 0, encoder not "
              f"scaled; config/dc_vic_oasis.yaml's discriminator, {OASIS_LOSS}): built in "
              f"{time.perf_counter() - t:.1f} s; the discriminator's logits {list(shape)}")
        worst = compare_oasis_gradients(tr, batch)
        # on the host: a copy of every parameter on the card would count in
        # the steps' peak memory
        before = {n: p.detach().to("cpu", copy=True) for n, p in tr.model.named_parameters()}
        off, _, _ = timed_steps(tr, loader, switch, False)
        torch.cuda.reset_peak_memory_stats()
        on, launched, _ = timed_steps(tr, loader, switch, True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        warm_peak = warm_step_peak(tr, loader)
        tr.mc_sampling = True
        torch.cuda.reset_peak_memory_stats()
        mc, mc_launched, _ = timed_steps(tr, loader, switch, True)
        mc_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mc_warm_peak = warm_step_peak(tr, loader)
        tr.mc_sampling = False
        params = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
        moved = [n for n, m in tr.main_mask.items() if not m
                 and not torch.equal(before[n], params[n])]
        if moved:
            raise AssertionError(f"the OASIS stage moved frozen parameters: {moved[:5]}")
        if all(torch.equal(before[n], params[n]) for n in before if n.startswith("decoder.")):
            raise AssertionError("the OASIS stage: the decoder did not move")

        # (d) one warm step with the kernels on, under the profiler
        batch = tr._to_device(next(loader)["real_images"])
        torch.cuda.synchronize()
        with device_trace(os.path.join(root, "trace")) as prof:
            t = time.perf_counter()
            terms = tr.step(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if float(terms["skipped"]):
            raise AssertionError(f"the profiled step gave {terms}")
        dev_ms, own_ms, bwd_ms = own_share(prof)
        print(f"one warm OASIS GAN step (kernels on) under torch.profiler: wall {wall:.4f} s, "
              f"device {dev_ms:.3f} ms (idle {1 - dev_ms / 1e3 / wall:.1%} of the profiled wall, "
              f"{1 - dev_ms / 1e3 / warm(on):.1%} of the unprofiled warm step's "
              f"{warm(on):.4f} s); K1 to K6 kernels {own_ms:.3f} ms ({own_ms / dev_ms:.1%}), their "
              f"Functions' backwards {bwd_ms:.3f} ms ({bwd_ms / dev_ms:.1%}): together "
              f"{(own_ms + bwd_ms) / dev_ms:.1%}")
        for line in kernel_report(kernel_times(prof)):
            print(line)
        del prof

        n = tr.state.step
        tr.save(n)
        d_sd = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
        del tr, params, before
        torch.cuda.empty_cache()
        tr = build_trainer(oasis_opt(root, load=dict(exp="oasis", iter=n, load_optimizer=True,
                                                     strict=True), exp="oasis_boot"))
        booted = tr.state.disc.state_dict()
        if set(booted) != set(d_sd) or any(not torch.equal(booted[k], v)
                                           for k, v in d_sd.items()):
            raise AssertionError("the OASIS boot: the discriminator is not the saved one")
        print(f"OASIS checkpoint at {n} steps booted: the discriminator's {len(d_sd)} tensors "
              f"bit for bit")
        del tr, booted, d_sd
        torch.cuda.empty_cache()

        # (b) one step through each new class
        for label, opt in (
                ("OasisDualBetaCondTamingNLayerDiscriminator, n_layers 2 (64 -> 32 resize), "
                 "OASIS step", oasis_opt(root, OASIS_N_LAYERS2, exp="oasis_n2")),
                ("DualBetaFtTamingNLayerDiscriminator, stage 1_3's vanilla GAN step",
                 film_opt(root))):
            tr = build_trainer(opt)
            d0 = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
            loaders.append(tr.train_loader.infinite())
            secs, got, _ = timed_steps(tr, loaders[-1], switch, True, n=1)
            if all(torch.equal(d0[k], v) for k, v in tr.state.disc.state_dict().items()):
                raise AssertionError(f"{label}: the discriminator did not move")
            print(f"{label}: one step {secs[0]:.4f} s (cold), launches {got['forward']}")
            del tr, d0
            torch.cuda.empty_cache()
    finally:
        for it in loaders:
            it.close()
        shutil.rmtree(root, ignore_errors=True)
        switch(torch.nn.Module(), True)
    print(f"OASIS GAN steps, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, f32 (host clock, "
          f"medians of {TRAIN_STEPS - 1} warm steps; {smi}): kernels off {warm(off):.4f} s, on "
          f"{warm(on):.4f} s ({TRAIN_BATCH / warm(on):.2f} images/s), on with mc_sampling "
          f"{warm(mc):.4f} s; peak device memory over the {TRAIN_STEPS} steps (the first one's "
          f"cuDNN algorithm search included) {peak:.2f} GiB, {mc_peak:.2f} GiB with "
          f"mc_sampling; over one warm step {warm_peak:.2f} GiB, {mc_warm_peak:.2f} GiB with "
          f"mc_sampling; launches per step {launched['forward']}, Function backwards "
          f"{launched['backward']}; with mc_sampling {mc_launched['forward']} / "
          f"{mc_launched['backward']}; worst gradient error {worst:.3e}")
    return dict(launched=launched, mc_launched=mc_launched, s=(warm(off), warm(on), warm(mc)),
                peak_gib=(peak, mc_peak, warm_peak, mc_warm_peak), worst=worst,
                trace_ms=(dev_ms, own_ms, bwd_ms))


def profile_contract(deployment_sd, launches16, smi):
    """Item 16 (c): ``tools/profile_codec.py::profile`` over the contract
    configuration with every reconstruction kernel on; its launches, a
    warm-up and PROFILE_ROUNDS cycles, held to that many of the deployment
    round trip's (``launches16``, item 8). Returns the report."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.ops import counts
    from dc_vic_tpu_torch.tools import profile_codec
    from dc_vic_tpu_torch.tools.workload import (DEPLOYMENT, deployment_config,
                                                 deployment_images)
    from dc_vic_tpu_torch.utils.config import load_config
    opt16 = deployment_config(load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml")))
    spec = build_comp_model(opt16, recon_kernels=RECON_KERNELS)
    spec.module.load_state_dict(deployment_sd, strict=True)
    codec = Codec(spec, encode_backend="device", lanes=DEPLOYMENT["lanes"])
    images = deployment_images()
    counts.reset()
    rep = profile_codec.profile(codec, images, PROFILE_ROUNDS, quality_ind=0)
    torch.cuda.synchronize()
    got = counts.launches()
    want = {k: (PROFILE_ROUNDS + 1) * n for k, n in launches16.items()}
    if got != want:
        raise AssertionError(f"profile_codec launched {got}, {PROFILE_ROUNDS + 1} round trips "
                             f"of the deployment give {want}")
    total = sum(v["mean_sec"] for v in rep.values())
    print(f"profile_codec over the contract configuration (bf16, entropy_precision default, "
          f"tpu format, device backend, lanes {DEPLOYMENT['lanes']}, batch {len(images)} "
          f"768x512, every reconstruction kernel on; means of {PROFILE_ROUNDS} rounds after a "
          f"warm-up; {smi}):")
    for name, v in rep.items():
        print(f"  {name}: {v['mean_sec'] * 1e3:.3f} ms")
    print(f"  end-to-end: {total:.4f} s / batch -> {len(images) / total:.2f} images/s")
    del codec, spec
    torch.cuda.empty_cache()
    return rep


# ------------------------------------------------ the training soak (item 17)

SOAK_ITERS, SOAK_EVAL_STEP = 20, 10    # a stage: the mechanics; the quality needs the full runs
SOAK_S2_CARRIED = 746                  # s1 tensors s2 carries (tests/test_torch_soak.py)
SOAK_ATTENTION = ((6, 1024, 128), (1, 1024, 128))   # K2 in a soak step and in its eval


def check_soak_attention(attention, dev, gen):
    """K2 at the soak's shapes against its plain version, item 2's
    tolerance, twice for equal bits."""
    import torch
    for B, N, C in SOAK_ATTENTION:
        q = torch.randn(B, N, C, generator=gen, device=dev) * C ** -0.5
        k, v = (torch.randn(B, N, C, generator=gen, device=dev) for _ in range(2))
        got = attention.flash_attention(q, k, v)
        want = attention.attention_plain(q, k, v)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        if not torch.equal(got, attention.flash_attention(q, k, v)):
            raise AssertionError(f"flash_attention is not repeatable at {(B, N, C)}")
        print(f"K2 at the soak's [{B},{N},{C}]: max abs err "
              f"{float((got - want).abs().max()):.3e} to plain, repeatable; kernel "
              f"{_time_ms(attention.flash_attention, q, k, v):.4f} ms, plain "
              f"{_time_ms(attention.attention_plain, q, k, v):.4f} ms")


def check_soak(smi, dev, gen):
    """Item 17: the curriculum soak's four stages (tools/soak.py
    run_curriculum on docs/artifacts/soak_gan_config.yaml, every
    reconstruction kernel on, its synthetic data from seed 0) at SOAK_ITERS
    iterations a stage and an eval every SOAK_EVAL_STEP, with every counter
    set to 0 just before and read just after: each kernel a step launches
    must have launched. Each stage's trainer is then built again from its
    options for one more step under recorded_step, which gives the shape
    rules' launches and Function backwards a step; the soak's own count of
    every step must equal them. K3 and K4 are held against their plain
    versions at the GroupNorm shapes those steps launched them with (f32,
    check_path_shapes). No step skipped, every logged loss and d_loss
    finite; each boot took what its knobs say (s2 carries SOAK_S2_CARRIED
    tensors, the beta FiLM at its initialisation; s3 and s4 strictly, s4
    with the optimizer states and the discriminator); checkpoints and CSV
    rows written. The gates are printed, not held: 20 iterations show the
    mechanics, the quality needs the full runs. Returns the launches and
    backwards of a step ({kernel: n}, or {kernel: {stage: n}} where the
    stages differ)."""
    import argparse
    import copy
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.ops import attention, conv3x3, counts, gn
    from dc_vic_tpu_torch.tools import soak
    from dc_vic_tpu_torch.train.trainer import build_trainer
    t_phase = time.perf_counter()
    check_soak_attention(attention, dev, gen)
    root = tempfile.mkdtemp(prefix="dcvic_soak_")
    rules, shapes = {}, {"gn": {}, "conv3x3_same": {}, "conv3x3_gn_swish": {}}
    try:
        train_root, eval_root = soak.make_synthetic_dataset(os.path.join(root, "datasets"))
        args = argparse.Namespace(iters=SOAK_ITERS, eval_step=SOAK_EVAL_STEP, work=root,
                                  keep_work=True, config=None, no_artifacts=True, out=None,
                                  trace_dir=None, device=dev.type)
        counts.reset()
        verdict, runs = soak.run_curriculum(args, train_root, eval_root)
        torch.cuda.synchronize()
        total = soak.kernel_counts()
        for s, run in runs.items():
            exp, gan, stats = f"cur_{s}", s in ("s3", "s4"), run.stats
            model_dir = os.path.dirname(run.checkpoint("comp_model", SOAK_ITERS))
            want = ["comp_model", "training_state"] + (["discriminator"] if gan else [])
            if sorted(os.listdir(model_dir)) != sorted(f"{k}_iter{SOAK_ITERS}.ckpt"
                                                       for k in want):
                raise AssertionError(f"{exp}: checkpoints {os.listdir(model_dir)}")
            n_eval = SOAK_ITERS // SOAK_EVAL_STEP * (1 if s == "s1" else 4)
            if len(run.loss_rows) != 4 or len(run.eval_rows) != n_eval:
                raise AssertionError(f"{exp}: {len(run.loss_rows)} loss and "
                                     f"{len(run.eval_rows)} eval rows")
            terms = [float(r[k]) for r in run.loss_rows for k in ("total", "bpp", "distortion")
                     + (("d_loss",) if gan else ())]
            if stats["nan_skips"] or not np.isfinite(terms).all() or stats["steps"] != SOAK_ITERS:
                raise AssertionError(f"{exp}: {stats['steps']} steps, {stats['nan_skips']} "
                                     f"skips, losses {run.loss_rows[-1]}")
            tr = build_trainer(copy.deepcopy(run.opt), device=dev.type)
            data = tr.train_loader.infinite()
            try:
                batch = tr._to_device(next(data)["real_images"])
                _, rules[s], step_shapes = recorded_step(tr.model, lambda: tr.step(batch))
            finally:
                data.close()
            del tr, batch
            for kind, seen in step_shapes.items():
                for shape, n in seen.items():
                    shapes[kind][shape] = max(n, shapes[kind].get(shape, 0))
            want = {**rules[s]["forward"],
                    **{f"{k}_backward": n for k, n in rules[s]["backward"].items()}}
            if stats["launches_per_step"] != want:
                raise AssertionError(f"{exp}: the soak counted {stats['launches_per_step']} "
                                     f"a step, the shape rules give {want}")
            if not (want["vq_argmin"] >= 1 and want["flash_attention"] >= 1):
                raise AssertionError(f"{exp}: K1/K2 a step {want}")
            idle = [k for k, n in want.items() if n and not total[k]]
            if idle:
                raise AssertionError(f"{exp}: {idle} launch a step but not in the soak's run "
                                     f"({total})")
        s2, s3, s4 = (runs[s].stats["handoff"] for s in ("s2", "s3", "s4"))
        if (s2["strict"] or s2["carried"] != SOAK_S2_CARRIED or s2["optimizer"]
                or not all(k.startswith(FILM_KEYS) for k in s2["kept_init"])):
            raise AssertionError(f"s2's boot: {s2['carried']} carried, strict {s2['strict']}")
        for name, boot, extras in (("s3", s3, False), ("s4", s4, True)):
            if not (boot["strict"] and boot["carried"] == boot["total"]
                    and boot["optimizer"] == extras and boot["discriminator"] == extras):
                raise AssertionError(f"{name}'s boot: {boot}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    check_path_shapes(gn, conv3x3, shapes, dev, gen, "float32")

    out = {}
    for part in ("forward", "backward"):
        names = sorted({k for launched in rules.values() for k in launched[part]})
        out[part] = {}
        for k in names:
            per = {s: launched[part].get(k, 0) for s, launched in rules.items()}
            out[part][k] = per["s1"] if len(set(per.values())) == 1 else per
    for s, run in runs.items():
        stats = run.stats
        boot = dict(stats["handoff"] or {})
        boot.pop("kept_init", None)
        print(f"item 17, cur_{s} ({SOAK_ITERS} steps, {smi}): median warm "
              f"{stats['median_warm_s_per_it']:.4f} s/it, peak {stats['peak_gib']:.2f} GiB, "
              f"NaN skips {stats['nan_skips']}, boot {boot or None}")
    print(f"item 17 soak stages (printed, not held at {SOAK_ITERS} iterations): "
          f"{json.dumps(verdict['stages'])}")
    print(f"item 17 soak gates (printed, not held): {json.dumps(verdict['gates'])}")
    print(f"item 17: launches a soak step {out['forward']}, Function backwards "
          f"{out['backward']}; the run's {total}; phase {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------- the last modules and options (item 18)

STANDALONE = (("ElicEncoder", "ElicDecoder", {}),
              ("ElicEncoder", "ElicDecoder", {"pixel_shuffle": True}),
              ("Balle18Encoder", "Balle18Decoder", {}),
              ("Cheng20Encoder", "Cheng20Decoder", {}),
              ("TestEncoder", "TestDecoder", {}))
# card against host CPU: relative, and absolute over the output's largest
# magnitude (random weights grow Cheng'20's decoder output to about 1e5,
# where f32 rounding alone moves values near zero)
STANDALONE_TOL = 1e-3


def _alt_round_trip(codec, images, label, smi, betas=None):
    """counted_round_trip (sync-free decode in the tpu format), then one
    warm round trip timed with the peak device memory over it. Returns
    (y_hat, launches)."""
    import torch
    y_hat, launches, _ = counted_round_trip(codec, images, label, betas,
                                            sync_free=codec.stream_format == "tpu")
    torch.cuda.reset_peak_memory_stats()
    res, _, enc, dec = drive(codec, images, betas)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: warm encode {enc:.4f} s, decode {dec:.4f} s, "
          f"{float(np.mean([r['bpp'] for r in res])):.4f} bpp, peak device memory "
          f"{peak:.2f} GiB ({smi})")
    return y_hat, launches


def check_alt_variants(smi, dev):
    """Item 18 (a) and (b). Returns {variant_mode_format_kernels: launches}."""
    import torch
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model, init_weights
    from dc_vic_tpu_torch.tools.workload import (deployment_config, scale_encoder,
                                                 smooth_images, variant_a, variant_b)
    from dc_vic_tpu_torch.utils.config import load_config
    images = smooth_images(4, 768, 512)
    launches = {}

    def built(opt, on, sd):
        spec = build_comp_model(opt, recon_kernels=RECON_KERNELS if on else ())
        if sd is None:
            init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
            sd = scale_encoder(spec.module.state_dict())
        spec.module.load_state_dict(sd)
        return spec, sd

    opt_a = variant_a(load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml")))
    sd, f32_off = None, None
    for mode, opt in (("f32", opt_a), ("bf16", deployment_config(opt_a))):
        codecs, y_hats = {}, {}
        for on in (False, True):
            spec, sd = built(opt, on, sd)
            if mode == "f32" and not on:
                print(f"variant A ({type(spec.module.encoder).__name__}, "
                      f"{type(spec.module.fusion_module.fusion_modules['block_1_8']).__name__}"
                      f"): {sum(p.numel() for p in spec.module.parameters())} parameters")
            codec = codecs[on] = Codec(spec, encode_backend="device", lanes=512)
            key = f"variant_a_{mode}_tpu_{'on' if on else 'off'}"
            y_hats[on], launches[key] = _alt_round_trip(
                codec, images, f"variant A, {mode}, tpu format, device backend, lanes 512, "
                f"kernels {'on' if on else 'off'}, batch 4 768x512", smi)
        if mode == "f32":
            missing = [k for k, n in launches["variant_a_f32_tpu_on"].items() if n < 1]
            if missing:
                raise AssertionError(f"variant A, kernels on: never launched {missing}")
            compare_recon(codecs[False], codecs[True], y_hats[False])
            f32_off = codecs[False]
        else:
            bf16_against_f32(f32_off, codecs[False], codecs[True], y_hats[False])
        del codecs
    del f32_off
    torch.cuda.empty_cache()

    opt_b = variant_b(load_config(os.path.join(ROOT, "config", "exp1_stage1_1.yaml")))
    sd = None
    for on in (False, True):
        spec, sd = built(opt_b, on, sd)
        if not on:
            print(f"variant B ({type(spec.module.encoder).__name__}, double_z VQGAN): "
                  f"{sum(p.numel() for p in spec.module.parameters())} parameters; no beta "
                  f"pairs selected, driven at betas {VARIANT_BETAS}")
        for fmt in ("tpu", "compressai"):
            codec = (Codec(spec, encode_backend="device", lanes=512) if fmt == "tpu" else
                     Codec(spec, stream_format="compressai", params_backend="accel"))
            key = f"variant_b_f32_{fmt}_{'on' if on else 'off'}"
            _, launches[key] = _alt_round_trip(
                codec, images, f"variant B, f32, {fmt} format, kernels "
                f"{'on' if on else 'off'}, batch 4 768x512", smi, VARIANT_BETAS)
        del spec
    torch.cuda.empty_cache()
    return launches


def check_alt_training(smi, dev):
    """Item 18 (c): one RD step of variant A on stage 1_2's config, batch 6
    of 256x256, every kernel on (two steps, the first not warm). Returns
    the last step's launches and Function backwards."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.ops import attention
    from dc_vic_tpu_torch.tools.workload import variant_a
    from dc_vic_tpu_torch.train.trainer import build_trainer
    root = tempfile.mkdtemp(prefix="dcvic_variant_a_")
    loader = None
    try:
        _training_images(root)
        tr = build_trainer(variant_a(training_opt("1_2", root)))
        loader = tr.train_loader.infinite()
        secs, launched, _ = timed_steps(tr, loader, _KernelSwitch(attention), True, n=2)
        print(f"variant A RD step (stage 1_2, batch {TRAIN_BATCH} of {TRAIN_CROP}x{TRAIN_CROP}, "
              f"f32, kernels on; {smi}): finite, not skipped; {secs[-1]:.4f} s warm; launches "
              f"{launched['forward']}, Function backwards {launched['backward']}")
        del tr
        torch.cuda.empty_cache()
    finally:
        if loader is not None:
            loader.close()
        shutil.rmtree(root, ignore_errors=True)
    return launched


def check_standalone(smi, dev):
    """Item 18 (d): the standalone transforms, one batch-4 768x512 forward
    each on the card, the first image's against the host CPU's."""
    import copy
    import torch
    from dc_vic_tpu_torch.models import init_weights
    from dc_vic_tpu_torch.models.dc_vic import to_model_range
    from dc_vic_tpu_torch.tools.workload import smooth_images
    from dc_vic_tpu_torch.utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY
    x = to_model_range(torch.from_numpy(smooth_images(4, 768, 512)).to(dev).permute(0, 3, 1, 2))
    for enc_name, dec_name, kw in STANDALONE:
        tanh = {"use_tanh": False} if dec_name != "TestDecoder" else {}
        with torch.device(dev):
            enc = ENCODER_REGISTRY.get(enc_name)()
            dec = DECODER_REGISTRY.get(dec_name)(**kw, **tanh)
        for m in (enc, dec):
            init_weights(m, torch.Generator(device=dev).manual_seed(0))
            m.eval()
        with torch.no_grad():
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = enc(x)
            out = dec(y)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            y_cpu = copy.deepcopy(enc).cpu()(x[:1].cpu())
            out_cpu = copy.deepcopy(dec).cpu()(y_cpu)
        label = f"{enc_name} -> {dec_name}{' (pixel shuffle)' if kw else ''}"
        for what, got, ref in (("y", y[:1].cpu(), y_cpu), ("output", out[:1].cpu(), out_cpu)):
            scale = max(1.0, float(ref.abs().max()))
            err = float((got - ref).abs().max())
            if (tuple(got.shape) != tuple(ref.shape) or not torch.isfinite(got).all()
                    or not torch.allclose(got, ref, rtol=STANDALONE_TOL,
                                          atol=STANDALONE_TOL * scale)):
                raise AssertionError(f"{label}: the card's {what} is {err:.3e} from the host "
                                     f"CPU's (largest magnitude {scale:.3e})")
            print(f"{label}: {what} {list(got.shape[1:])}, card against host CPU max abs diff "
                  f"{err:.3e} (largest magnitude {scale:.3e}, tolerance {STANDALONE_TOL:g} "
                  f"relative and of it)")
        print(f"{label}: batch 4 768x512 on the card {card_s:.3f} s (first call; {smi})")
        del enc, dec, y, out
    torch.cuda.empty_cache()


# --------------------------------------------- more than one device (item 19)

DP_WORLD = 2            # ranks of the data-parallel comparison
DP_STAGES = ("1_2", "1_3")
# the averaged step against the step of the whole batch at once: batch 3
# and batch 6 run other cuDNN algorithms, which flip roundings and argmaxes
# at near-ties on random weights (measured up to 4.0e-2 RD, 1.1e-1 GAN
# relative L2 in a gradient, 2.4e-4 in a term); a rank's rows, betas or
# noise sliced wrong move the step by far more
WHOLE_BATCH_TERM_TOL = 1e-3     # relative to max(|term|, 1)
WHOLE_BATCH_GRAD_TOL = 0.2      # relative L2 per parameter tensor


def _bits(named):
    """sha256 of (name, bytes) over a {name: tensor} mapping, in name order:
    two processes' tensors compared without moving them."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for name in sorted(named):
        t = named[name].detach().contiguous().reshape(-1)
        h.update(name.encode())
        h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _train_state(tr):
    """The trainer's parameters, buffers and optimizer states by name (a
    copy)."""
    out = {f"model.{k}": v.clone() for k, v in tr.model.state_dict().items()}
    if tr.state.disc is not None:
        out.update({f"disc.{k}": v.clone() for k, v in tr.state.disc.state_dict().items()})
    for key in ("g_opt", "aux_opt", "d_opt"):
        opt = getattr(tr.state, key)
        if opt is not None:
            sd = opt.state_dict()
            out.update({f"{key}.{k}": sd[k] for k in ("count", "sched_count")})
            for moment in ("mu", "nu"):
                out.update({f"{key}.{moment}.{n}": t for n, t in sd.get(moment, {}).items()})
    return out


def _snapshot(tr):
    """What ``_restore`` puts back: weights, optimizer states, the
    generator's state, the step count."""
    opts = {k: getattr(tr.state, k) for k in ("g_opt", "aux_opt", "d_opt")}
    return dict(model=_train_state(tr), opts={k: o.state_dict() for k, o in opts.items()
                                               if o is not None},
                gen=tr.state.generator.get_state(), step=tr.state.step)


def _restore(tr, snap):
    tr.model.load_state_dict({k[len("model."):]: v for k, v in snap["model"].items()
                              if k.startswith("model.")})
    if tr.state.disc is not None:
        tr.state.disc.load_state_dict({k[len("disc."):]: v for k, v in snap["model"].items()
                                       if k.startswith("disc.")})
    for k, sd in snap["opts"].items():
        getattr(tr.state, k).load_state_dict(sd)
    tr.state.generator.set_state(snap["gen"])
    tr.state.step = snap["step"]


def _dp_step(tr, batch, dp, grads=True):
    """One step of the trainer's stage on ``batch`` under DETERMINISTIC,
    its launches and Function backwards held to the shape rules. Returns
    (terms as floats, launches, the gradients the optimizers used, or
    None without ``grads``)."""
    from dc_vic_tpu_torch.train.steps import gan_step, rd_step
    from dc_vic_tpu_torch.utils.backends import backend_flags

    def run():
        with backend_flags(**DETERMINISTIC):
            if tr.gan:
                return gan_step(tr.state, batch, tr.losses, tr.policy, tr.mc_sampling,
                                tr.y_hat_cond, tr.lpips_fn, tr.oasis, dp=dp)
            return rd_step(tr.state, batch, tr.losses, tr.policy, tr.lpips_fn, dp=dp)
    terms, launched, _ = recorded_step(tr.model, run)
    terms = {k: float(v) for k, v in terms.items()}
    if not grads:
        return terms, launched, None
    grads = {n: p.grad.detach().clone() for n, p in tr.model.named_parameters()
             if p.grad is not None}
    if tr.state.disc is not None:
        grads.update({f"disc.{n}": p.grad.detach().clone()
                      for n, p in tr.state.disc.named_parameters() if p.grad is not None})
    return terms, launched, grads


def _timed_step(tr, batch, dp):
    """One more step on ``batch``, the VQ targets the model's own: (its
    launches and Function backwards, held to the rules; host seconds,
    ending in a synchronize)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    terms, launched, _ = _dp_step(tr, batch, dp, grads=False)
    if not all(np.isfinite(v) for v in terms.values()) or terms["skipped"]:
        raise AssertionError(f"a data-parallel step gave {terms}")
    return launched, time.perf_counter() - t


class _Microbatch:
    """A rank of a data-parallel step played in one process, one rank after
    the other: the step runs on the rank's rows with the rank's slices of
    the global draws and keeps the rank's own gradients and terms where a
    rank would average them (no collective). The mean over the ranks is the
    1-process step of the global batch taken in micro-batches of the
    ranks' shape."""

    def __init__(self, tr, rank, world):
        self.rank, self.world = rank, world
        modules = [("", tr.model)] + ([("disc.", tr.state.disc)] if tr.state.disc else [])
        self.names = {id(p): prefix + n for prefix, m in modules
                      for n, p in m.named_parameters()}
        self.grads, self.terms = {}, {}

    @property
    def shard(self):
        return self.rank, self.world

    def all_reduce_mean(self, values):
        self.terms = {k: float(v) for k, v in values.items()}
        return values

    def mean_grads(self, params):
        import torch
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        self.grads.update({self.names[id(p)]: g.detach().clone()
                           for p, g in zip(params, grads) if p.grad is not None})
        return grads


def _microbatch_reference(tr, batch, snap, world):
    """The gradients and terms of the 1-process step of ``batch`` taken in
    ``world`` micro-batches of the ranks' shape (``_Microbatch``), each
    from ``snap``: what the ranks' averaged step must give."""
    from dc_vic_tpu_torch.parallel.mesh import shard_rows
    parts = []
    for r in range(world):
        _restore(tr, snap)
        part = _Microbatch(tr, r, world)
        _dp_step(tr, batch[shard_rows(batch.shape[0], r, world)], part, grads=False)
        parts.append(part)
    grads = {n: sum(p.grads[n] for p in parts) / world for n in parts[0].grads}
    terms = {k: sum(p.terms[k] for p in parts) / world for k in parts[0].terms}
    return grads, terms


def _batch_shape_witness(tr, batch, world):
    """What batch 3 against batch 6 does to the model with nothing sliced:
    its eval forward (hard rounds, no noise) on the whole batch and on
    ``world`` contiguous parts of it in turn, from the same weights and
    per-sample betas. Returns the largest per-image relative L2 of y before
    rounding, the elements of y and z whose rounding flipped (|change| >
    0.5), and the VQ targets' and the estimator's argmax flips."""
    import torch
    from dc_vic_tpu_torch.utils.backends import backend_flags
    n = batch.shape[0]
    betas = [None, None]
    if tr.policy.use_beta:
        betas = [torch.linspace(0.0, m, n, device=batch.device)
                 for m in (tr.policy.max_beta_rate, tr.policy.max_beta_vq)]

    def forward(lo, hi):
        with torch.no_grad(), backend_flags(**DETERMINISTIC):
            out = tr.model(batch[lo:hi], *(b if b is None else b[lo:hi] for b in betas),
                           is_train=False)
        return dict(y=out["latent_code"]["y"], y_hat=out["quantized_code"]["y"],
                    z_hat=out["quantized_code"]["z"], targets=out["gt_vq_indices"],
                    argmax=out["out_vq_logits"].argmax(dim=1))

    whole = forward(0, n)
    step = n // world
    parts = [forward(r * step, (r + 1) * step) for r in range(world)]
    split = {k: torch.cat([p[k] for p in parts]) for k in whole}
    y, y_split = whole["y"].double().flatten(1), split["y"].double().flatten(1)
    rel = torch.linalg.vector_norm(y_split - y, dim=1) / torch.linalg.vector_norm(y, dim=1)
    flips = lambda k: int(((split[k] - whole[k]).abs() > 0.5).sum())
    return dict(y_rel_l2=float(rel.max()), y_flips=flips("y_hat"), y_elements=y.numel(),
                z_flips=flips("z_hat"), z_elements=whole["z_hat"].numel(),
                target_flips=int((split["targets"] != whole["targets"]).sum()),
                argmax_flips=int((split["argmax"] != whole["argmax"]).sum()),
                tokens=whole["argmax"].numel())


def _hold_whole_batch(got, want, label):
    """The averaged step of the ranks against the 1-process step of the
    whole batch at once: every term within WHOLE_BATCH_TERM_TOL of
    max(|term|, 1), every gradient within WHOLE_BATCH_GRAD_TOL relative L2
    (+1e-7). Prints the comparison before it holds it. Returns (the
    largest gradient error, the gradients over GRAD_TOL)."""
    import torch
    if set(got["grads"]) != set(want["grads"]):
        raise AssertionError(f"{label}: gradients of other tensors than the 1-process step")
    rels, diff2, norm2 = [], 0.0, 0.0
    for n, w in want["grads"].items():
        err, rel = _rel_l2(got["grads"][n].to(w.device), w)
        wn = float(torch.linalg.vector_norm(w.double()))
        diff2, norm2 = diff2 + err ** 2, norm2 + wn ** 2
        rels.append((rel if err > 1e-7 else 0.0, err > GRAD_TOL * wn + 1e-7, n))
    rels.sort(reverse=True)
    over = sum(o for _, o, _ in rels)
    terms = {k: (got["terms"][k], w, abs(got["terms"][k] - w) / max(abs(w), 1.0))
             for k, w in want["terms"].items() if k != "skipped"}
    worst_term = max(terms, key=lambda k: terms[k][2])
    print(f"{label} against the batch-{TRAIN_BATCH} step in one process: {over} of "
          f"{len(rels)} gradients over {GRAD_TOL} relative L2 (+1e-7), the largest "
          f"{rels[0][0]:.3e} ({rels[0][2]}), all gradients together "
          f"{(diff2 / norm2) ** 0.5:.3e}; terms " + ", ".join(
              f"{k} {g:.6f} against {w:.6f}" for k, (g, w, _) in terms.items())
          + f"; the largest term error {terms[worst_term][2]:.2e} ({worst_term}) of "
          f"max(|term|, 1)")
    if rels[0][0] > WHOLE_BATCH_GRAD_TOL or terms[worst_term][2] > WHOLE_BATCH_TERM_TOL:
        raise AssertionError(
            f"{label}: against the whole batch's step, gradients over "
            f"{WHOLE_BATCH_GRAD_TOL} relative L2: "
            f"{[(n, f'{r:.3e}') for r, _, n in rels if r > WHOLE_BATCH_GRAD_TOL][:8]}; terms "
            f"over {WHOLE_BATCH_TERM_TOL}: "
            f"{[k for k, t in terms.items() if t[2] > WHOLE_BATCH_TERM_TOL]}")
    return rels[0][0], over


def _dp_rank(rank, world, backend, store, root, devices, out):
    """One rank of item 19 (a), in its own process: each stage's trainer on
    ``devices[rank]`` through the process group, the rank's rows of the
    first global batch, one counted step and one timed step. Writes what it
    saw to ``out/rank{rank}.pt`` (rank 0 also the gradients)."""
    import torch
    from dc_vic_tpu_torch.ops import native
    from dc_vic_tpu_torch.parallel.mesh import init_distributed, teardown
    from dc_vic_tpu_torch.train.trainer import build_trainer
    torch.cuda.set_device(devices[rank])
    native.kernels()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dp = init_distributed(rank, world, backend, f"file://{store}")
    res = {}
    try:
        for stage in DP_STAGES:
            tr = build_trainer(training_opt(stage, root), device=devices[rank], dp=dp)
            batch = tr._to_device(next(tr.train_loader.epoch_batches(0))["real_images"])
            start = _bits(_train_state(tr))
            terms, _, grads = _dp_step(tr, batch, dp)
            after = _bits(_train_state(tr))
            launched, step_s = _timed_step(tr, batch, dp)
            res[stage] = dict(start=start, after=after, terms=terms, launched=launched,
                              batch=int(batch.shape[0]), step_s=step_s,
                              peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            if rank == 0:
                res[stage]["grads"] = {n: g.cpu() for n, g in grads.items()}
            del tr, grads
            torch.cuda.empty_cache()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        teardown()


def _hold_dp_grads(got, want, label):
    """The averaged gradients of a data-parallel step against the 1-process
    step's: the same tensors, each within GRAD_TOL relative L2 (+1e-7).
    Returns the relative error of the tensor that used the largest share
    of its tolerance."""
    import torch
    if set(got) != set(want):
        raise AssertionError(f"{label}: gradients of other tensors than the 1-process step")
    shares = {}
    for name, w in want.items():
        err, rel = _rel_l2(got[name].to(w.device), w)
        shares[name] = (err / (GRAD_TOL * float(torch.linalg.vector_norm(w.double())) + 1e-7),
                        rel)
    order = sorted(shares, key=lambda n: -shares[n][0])
    worst_name = order[0]
    worst, worst_rel = shares[worst_name]
    if worst > 1.0:
        raise AssertionError(f"{label}: relative L2 errors over {GRAD_TOL}: " + ", ".join(
            f"{n} {shares[n][1]:.3e}" for n in order[:8] if shares[n][0] > 1.0))
    print(f"{label}: {len(want)} gradients within {GRAD_TOL} relative L2 (+1e-7) of the "
          f"1-process step's; the largest share of that tolerance {worst:.3f} ({worst_name}, "
          f"relative error {worst_rel:.3e})")
    return worst_rel


def check_data_parallel(smi):
    """Item 19 (a). Returns {stage: {"plain": launches, "ranks": [launches
    of each rank]}} of the counted steps."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.parallel.mesh import init_distributed, teardown
    from dc_vic_tpu_torch.train.trainer import build_trainer
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_dp_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    plain, out = {}, {}
    try:
        _training_images(root)
        dp1 = init_distributed(0, 1, "nccl", f"file://{os.path.join(root, 'store_nccl1')}")
        try:
            for stage in DP_STAGES:
                tr = build_trainer(training_opt(stage, root))
                batch = tr._to_device(next(tr.train_loader.epoch_batches(0))["real_images"])
                snap = _snapshot(tr)
                terms, launched, grads = _dp_step(tr, batch, None)
                after = _train_state(tr)
                # the same state again, through the process group of one rank
                _restore(tr, snap)
                terms1, launched1, grads1 = _dp_step(tr, batch, dp1)
                same = (terms1 == terms and launched1 == launched
                        and all(torch.equal(grads1[n], g) for n, g in grads.items())
                        and set(grads1) == set(grads)
                        and all(torch.equal(v, after[k]) for k, v in _train_state(tr).items()))
                if not same:
                    raise AssertionError(f"stage {stage}: the nccl world-1 step is not the "
                                         f"plain step bit for bit")
                _restore(tr, snap)
                witness = _batch_shape_witness(tr, batch, DP_WORLD)
                micro, micro_terms = _microbatch_reference(tr, batch, snap, DP_WORLD)
                launched, step_s = _timed_step(tr, batch, None)
                plain[stage] = dict(start=_bits(snap["model"]), terms=terms, launched=launched,
                                    grads=grads, step_s=step_s, micro=micro,
                                    micro_terms=micro_terms)
                print(f"item 19, stage {stage}: the eval forward on batch {TRAIN_BATCH} against "
                      f"{DP_WORLD} parts of {TRAIN_BATCH // DP_WORLD} in turn, nothing sliced "
                      f"(the weights the steps start from): y before rounding within "
                      f"{witness['y_rel_l2']:.3e} relative L2 an image; rounding flips y "
                      f"{witness['y_flips']} of {witness['y_elements']}, z "
                      f"{witness['z_flips']} of {witness['z_elements']}; argmax flips: VQ "
                      f"targets {witness['target_flips']}, estimator "
                      f"{witness['argmax_flips']} of {witness['tokens']} tokens")
                buckets = {k: 4 * sum(p.numel() for p in getattr(tr.state, k).params)
                           for k in ("g_opt", "d_opt" if tr.gan else "aux_opt")}
                print(f"item 19, stage {stage} ({'GAN' if tr.gan else 'RD'}) step, batch "
                      f"{TRAIN_BATCH} in one process: {terms}; the nccl world-1 step gives the "
                      f"same bits (terms, gradients, weights, optimizer states); in "
                      f"{DP_WORLD} micro-batches: {micro_terms}; launches "
                      f"{launched['forward']}, Function backwards {launched['backward']}; a "
                      f"rank's all-reduce buckets a step (bytes): {buckets} and "
                      f"{4 * (len(terms) - 1)} of terms")
                del tr, snap, after, grads1
                torch.cuda.empty_cache()
        finally:
            teardown()
        runs = [("gloo", ["cuda:0"] * DP_WORLD)]
        if torch.cuda.device_count() >= 2:
            runs.append(("nccl", [f"cuda:{i}" for i in range(DP_WORLD)]))
        else:
            print(f"item 19: one card ({smi}), so no nccl run over {DP_WORLD} cards")
        for backend, devices in runs:
            done = os.path.join(root, f"ranks_{backend}")
            os.makedirs(done)
            torch.multiprocessing.spawn(
                _dp_rank, args=(DP_WORLD, backend, os.path.join(root, f"store_{backend}"),
                                root, devices, done), nprocs=DP_WORLD, join=True)
            ranks = [torch.load(os.path.join(done, f"rank{r}.pt"), weights_only=False)
                     for r in range(DP_WORLD)]
            for stage in DP_STAGES:
                want = plain[stage]
                label = f"item 19, stage {stage}, {DP_WORLD} ranks ({backend}, {devices})"
                for r, rank in enumerate(ranks):
                    got = rank[stage]
                    if got["start"] != want["start"]:
                        raise AssertionError(f"{label}: rank {r} did not start from the "
                                             f"1-process step's bits")
                    if got["launched"]["forward"]["vq_argmin"] < 1 or any(
                            n < 1 for k, n in got["launched"]["forward"].items()
                            if k not in ("rans_encode_pack", "rans_decode_section")):
                        raise AssertionError(f"{label}: rank {r} launches {got['launched']}")
                    if got["terms"].get("skipped"):
                        raise AssertionError(f"{label}: rank {r} skipped the step")
                if ranks[0][stage]["after"] != ranks[1][stage]["after"] or \
                        ranks[0][stage]["terms"] != ranks[1][stage]["terms"]:
                    raise AssertionError(f"{label}: the ranks differ after the step")
                got = ranks[0][stage]
                print(f"{label}: terms of the mean over the ranks {got['terms']}")
                worst = _hold_dp_grads(got["grads"], want["micro"],
                                       f"{label} against one process in micro-batches")
                whole_worst, over = _hold_whole_batch(got, want, label)
                rel_total = abs(got["terms"]["total"] / want["micro_terms"]["total"] - 1)
                out.setdefault(stage, {})[backend] = dict(
                    worst=worst, step_s=[rank[stage]["step_s"] for rank in ranks],
                    launched=[rank[stage]["launched"] for rank in ranks],
                    whole_batch_worst=whole_worst, whole_batch_over=over)
                print(f"{label}: ranks bit-equal after the step (weights, optimizer states); "
                      f"mean loss {got['terms']['total']:.6f} against "
                      f"{want['micro_terms']['total']:.6f} in micro-batches (relative "
                      f"{rel_total:.2e}); launches a "
                      f"rank {ranks[0][stage]['launched']['forward']} on batch "
                      f"{ranks[0][stage]['batch']}; warm step "
                      f"{', '.join(f'{r[stage]['step_s']:.4f}' for r in ranks)} s a rank against "
                      f"{want['step_s']:.4f} s in one process ({smi}; host clock, one step "
                      f"each; peak {max(r[stage]['peak_gib'] for r in ranks):.2f} GiB a rank)")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    print(f"item 19 (a) took {time.perf_counter() - t_phase:.1f} s")
    for stage in DP_STAGES:
        out[stage]["plain"] = plain[stage]["launched"]
    return out


def _mesh_round_trip(codec, images, label):
    """A round trip on a mesh codec with every counter set to 0 just
    before it and read just after: latents bit-exact, the decoded images
    each shard's reconstruct_uint8 of the encoder's y_hat. Returns
    (launches, results, images, encode s, decode s)."""
    import torch
    from dc_vic_tpu_torch.ops import counts
    counts.reset()
    res, out, enc_s, dec_s = drive(codec, images)
    launches = counts.launches()
    B, H, W = images.shape[:3]
    strings = [r["string_list"] for r in res]
    if len(res) != B or out.shape != images.shape:
        raise AssertionError(f"{label}: {len(res)} results, images {out.shape}")
    if not codec.verify_roundtrip(res, strings, (H, W)):
        raise AssertionError(f"{label}: decode-side y_hat differs from the encoder's")
    recon = []
    with torch.no_grad():
        for c, part in zip(codec._shards, codec._cut(np.stack([r["y_hat"] for r in res]))):
            y = torch.from_numpy(np.ascontiguousarray(part.transpose(0, 3, 1, 2))).to(c.device)
            recon.append(c.module.reconstruct_uint8(y, *c._betas(0))[:, :, :H, :W]
                         .permute(0, 2, 3, 1).cpu().numpy())
    if not np.array_equal(out, np.concatenate(recon)[:B]):
        raise AssertionError(f"{label}: decoded images differ from the shards' "
                             f"reconstruct_uint8(y_hat)")
    print(f"{label}: y_hat round trip bit-exact, images equal each shard's "
          f"reconstruct_uint8, {float(np.mean([r['bpp'] for r in res])):.4f} bpp, encode "
          f"{enc_s:.4f} s, decode {dec_s:.4f} s; launches {launches}")
    return launches, res, out, enc_s, dec_s


def check_mesh_codec(deployment_sd, smi):
    """Item 19 (b). Returns the launches of the mesh round trip at batch 16."""
    import torch
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model
    from dc_vic_tpu_torch.parallel.mesh import make_mesh
    from dc_vic_tpu_torch.tools.workload import DEPLOYMENT, deployment_config, deployment_images
    from dc_vic_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    B16, lanes = DEPLOYMENT["batch"], DEPLOYMENT["lanes"]
    images16 = deployment_images()
    spec = build_comp_model(deployment_config(load_config(os.path.join(
        ROOT, "config", "dc_vic_patchgan.yaml"))), recon_kernels=RECON_KERNELS)
    spec.module.load_state_dict(deployment_sd, strict=True)
    single = Codec(spec, encode_backend="device", lanes=lanes)
    label = f"bf16 contract configuration, kernels on, one device, batch {B16 // 2}"
    _, half, _ = counted_round_trip(single, images16[:B16 // 2], label)
    meshes = [make_mesh(["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_mesh())
    launches = None
    for mesh in meshes:
        n = len(mesh)
        name = f"mesh {[str(d) for d in mesh]}"
        mc = Codec(spec, encode_backend="device", lanes=lanes, mesh=mesh)
        got, res, out, enc_s, dec_s = _mesh_round_trip(
            mc, images16, f"item 19, contract configuration on {name}, batch {B16}")
        want = {k: v * n for k, v in half.items()} if n == 2 else None
        if want is not None and got != want:
            raise AssertionError(f"{name}: launches {got}, twice the batch-{B16 // 2} round "
                                 f"trip's {want}")
        if any(v < 1 for v in got.values()):
            raise AssertionError(f"{name}: a kernel never launched: {got}")
        if launches is None:
            launches = got
        h = HeaderHandler.decode(res[0]["string_list"][0])
        if (h["encode_batch"], h["lanes"], h["bf16"], h["portable"]) != (B16, lanes, True, False):
            raise AssertionError(f"{name}: header {h}")
        # a batch that does not divide: 15 images run as 16
        res15 = mc.compress(images16[:15], 0, debug=True)
        s15 = [r["string_list"] for r in res15]
        if (len(res15) != 15 or not mc.verify_roundtrip(res15, s15, images16.shape[1:3])
                or mc.decompress(s15).shape != (15,) + images16.shape[1:]
                or HeaderHandler.decode(s15[0][0])["encode_batch"] != (-(-15 // n)) * n):
            raise AssertionError(f"{name}: the batch of 15 did not round-trip padded")
        print(f"item 19, {name}: a batch of 15 round-trips bit-exactly, padded to "
              f"{(-(-15 // n)) * n}")
        # portable streams, both ways, against the single-device codec
        pm_codec = Codec(spec, encode_backend="device", lanes=lanes, portable=True, mesh=mesh)
        ps_codec = Codec(spec, encode_backend="device", lanes=lanes, portable=True)
        for enc, dec, way in ((pm_codec, ps_codec, "mesh -> one device"),
                              (ps_codec, pm_codec, "one device -> mesh")):
            pres = enc.compress(images16, 0, debug=True)
            pstr = [r["string_list"] for r in pres]
            for part in (slice(0, B16), slice(0, 4), slice(5, 6)):
                if not dec.verify_roundtrip(pres[part], pstr[part], images16.shape[1:3]):
                    raise AssertionError(f"{name}: portable streams {way}, images {part}: "
                                         f"latents differ")
        print(f"item 19, {name}: portable streams decode bit-exactly mesh -> one device and "
              f"one device -> mesh (groupings of {B16}, 4 and 1)")
        del pm_codec, ps_codec
        # the times: the same global batch on the mesh and on one device
        _, _, s_enc, s_dec = drive(single, images16)
        _, _, m_enc, m_dec = drive(mc, images16)
        print(f"item 19, contract cycle at batch {B16} ({smi}): one device encode {s_enc:.4f} "
              f"s, decode {s_dec:.4f} s; {name} encode {m_enc:.4f} s, decode {m_dec:.4f} s "
              f"(host clock, one warm run each, in turn)")
        del mc
        torch.cuda.empty_cache()
    del single, spec
    torch.cuda.empty_cache()
    print(f"item 19 (b) took {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------- fully sharded training (item 20)

FSDP_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_train.py's FSDP against replicated
EVAL_SWEEP_MESH = ("cuda:0", "cuda:0")


def _whole_state(tr):
    """``_train_state`` with every tensor whole: under FSDP gathered on
    every rank (every rank calls this)."""
    return tr._whole(lambda: _train_state(tr))


def _opts(tr):
    return [(k, getattr(tr.state, k)) for k in ("g_opt", "aux_opt", "d_opt")
            if getattr(tr.state, k) is not None]


def _resident_bytes(tr):
    """The bytes of parameters and optimizer moments the rank holds now:
    the modules' parameters (a released sharded one holds none), the FSDP
    slices and the moments, each tensor once."""
    held = {}
    modules = [tr.model] + ([tr.state.disc] if tr.state.disc is not None else [])
    tensors = [p for m in modules for p in m.parameters()]
    if tr.fsdp is not None:
        tensors += [s for lay in tr.fsdp.layouts for s in lay.shards.values()]
    for _, opt in _opts(tr):
        tensors += list(opt.params) + list(opt.mu or []) + list(opt.nu or [])
    for t in tensors:
        held.setdefault(id(t), t.numel() * t.element_size())
    return sum(held.values())


def _hold_fsdp_slices(tr, dp_after, rank, world, label):
    """Every tensor the FSDP rank holds after its step against the same
    tensor of the data-parallel rank after its step from the same bits: a
    slice against the data-parallel tensor's slice on the shard dimension,
    a whole tensor against the whole, at FSDP_TOL (the counters exactly).
    Returns (tensors, bit-equal, largest |difference|, its tensor)."""
    import torch
    pairs = []
    for lay, prefix in zip(tr.fsdp.layouts, ("model.", "disc.")):
        pairs += [(prefix + n, lay.param(n), lay.plan[n]) for n in lay.params]
    for key, opt in _opts(tr):
        pairs += [(f"{key}.{c}", getattr(opt, c), None) for c in ("count", "sched_count")]
        for moment in ("mu", "nu"):
            pairs += [(f"{key}.{moment}.{n}", t, opt.layout.plan[n])
                      for n, t in zip(opt.names, getattr(opt, moment) or [])]
    equal, worst, worst_name = 0, 0.0, None
    for name, got, d in pairs:
        got, want = got.detach(), dp_after[name]
        if d is not None:
            k = want.shape[d] // world
            want = want.narrow(d, rank * k, k)
        if got.shape != want.shape or not torch.allclose(got, want, **FSDP_TOL):
            raise AssertionError(f"{label}: {name} differs from the data-parallel step's "
                                 f"beyond rtol {FSDP_TOL['rtol']}, atol {FSDP_TOL['atol']}")
        equal += bool(torch.equal(got, want))
        diff = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        if diff > worst:
            worst, worst_name = diff, name
    return len(pairs), equal, worst, worst_name


def _fsdp_rank(rank, world, backend, store, root, devices, out):
    """One rank of item 20 (a), in its own process: for each stage, the
    data-parallel trainer's counted step and warm step, then the fully
    sharded trainer's (``fsdp: true``) from the same bits, held here
    against the data-parallel one; bytes at rest, collective bytes, peaks
    and warm seconds of both; after the last stage's steps an FSDP save.
    Writes what it saw to ``out/rank{rank}.pt``."""
    import torch
    from dc_vic_tpu_torch.ops import native
    from dc_vic_tpu_torch.parallel.mesh import init_distributed, teardown
    from dc_vic_tpu_torch.train.trainer import build_trainer
    torch.cuda.set_device(devices[rank])
    native.kernels()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dp = init_distributed(rank, world, backend, f"file://{store}")
    res = {}
    try:
        for stage in DP_STAGES:
            got = res[stage] = {}
            for mode in ("dp", "fsdp"):
                opt = training_opt(stage, root)
                opt["fsdp"] = mode == "fsdp"
                tr = build_trainer(opt, device=devices[rank], dp=dp)
                if (tr.fsdp is None) != (mode == "dp"):
                    raise AssertionError(f"rank {rank}: fsdp {opt['fsdp']} built {tr.fsdp}")
                batch = tr._to_device(next(tr.train_loader.epoch_batches(0))["real_images"])
                start = _bits(_whole_state(tr))
                terms, launched, _ = _dp_step(tr, batch, dp, grads=False)
                resident = _resident_bytes(tr)
                if mode == "dp":
                    dp_after = _train_state(tr)
                else:
                    got["held"] = _hold_fsdp_slices(tr, dp_after, rank, world,
                                                    f"rank {rank}, stage {stage}")
                    got["after"] = _bits(_whole_state(tr))
                    del dp_after
                torch.cuda.reset_peak_memory_stats()
                warm, step_s = _timed_step(tr, batch, dp)
                got[mode] = dict(start=start, terms=terms, launched=launched, warm=warm,
                                 step_s=step_s, resident=resident,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
                if mode == "fsdp":
                    # the step's collectives alone: the all-gather of the sharded
                    # parameters, then the gradients' reduce-scatters and all-reduces
                    # (zeros: no gradient is left after a step)
                    t = time.perf_counter()
                    tr.fsdp.gather()
                    torch.cuda.synchronize()
                    got["gather_s"] = time.perf_counter() - t
                    t = time.perf_counter()
                    for key in ("g_opt", "d_opt" if tr.gan else "aux_opt"):
                        tr.fsdp.mean_grads(getattr(tr.state, key))
                    torch.cuda.synchronize()
                    got["scatter_s"] = time.perf_counter() - t
                    tr.fsdp.release()
                if mode == "fsdp" and stage == DP_STAGES[-1]:
                    got["saved_bits"] = _bits(_whole_state(tr))
                    got["saved"] = tr.save(1)
                del tr
                torch.cuda.empty_cache()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.use_deterministic_algorithms(False)
        teardown()


def _eval_sweep(model, batch, smi):
    """Item 20 (e): ``data_parallel_eval`` of the eval forward over
    EVAL_SWEEP_MESH against one call on the whole batch, each output held
    within WHOLE_BATCH_GRAD_TOL relative L2 (item 19's whole-batch limit:
    split batches run other cuDNN algorithms, _batch_shape_witness)."""
    import torch
    from dc_vic_tpu_torch.parallel import data_parallel_eval
    from dc_vic_tpu_torch.utils.backends import backend_flags

    def forward(m, x, b1, b2):
        out = m(x, b1, b2, is_train=False)
        return dict(fake=out["fake_images"], y=out["latent_code"]["y"],
                    y_hat=out["quantized_code"]["y"], z_hat=out["quantized_code"]["z"],
                    tokens=out["out_vq_logits"].argmax(dim=1).float())
    betas = [torch.full((1,), 1.0, device=batch.device)] * 2
    sweep = data_parallel_eval(forward, EVAL_SWEEP_MESH)
    with torch.no_grad(), backend_flags(**DETERMINISTIC):
        whole = forward(model, batch, *betas)
        torch.cuda.synchronize()
        t = time.perf_counter()
        whole = forward(model, batch, *betas)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
        split = sweep(model, batch, *betas)
        torch.cuda.synchronize()
        t = time.perf_counter()
        split = sweep(model, batch, *betas)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t
    rows = []
    for k, w in whole.items():
        g = split[k]
        if g.shape != w.shape or g.device != w.device or not torch.isfinite(g).all():
            raise AssertionError(f"item 20 (e): {k} {tuple(g.shape)} on {g.device}, want "
                                 f"{tuple(w.shape)} on {w.device}")
        _, rel = _rel_l2(g, w)
        flips = int(((g - w).abs() > 0.5).sum()) if k in ("y_hat", "z_hat", "tokens") else None
        if rel > WHOLE_BATCH_GRAD_TOL:
            raise AssertionError(f"item 20 (e): {k} is {rel:.3e} relative L2 from one device's")
        rows.append(f"{k} {rel:.3e}" + ("" if flips is None else f" ({flips} of {g.numel()} "
                                                                 f"changed)"))
    print(f"item 20 (e): data_parallel_eval of the eval forward over {list(EVAL_SWEEP_MESH)}, "
          f"batch {batch.shape[0]}, against one device (relative L2, limit "
          f"{WHOLE_BATCH_GRAD_TOL}): {', '.join(rows)}; warm {sweep_s:.4f} s against "
          f"{one_s:.4f} s ({smi}; host clock, one call each, replicas made in the call)")


def check_fsdp(smi, dp_runs):
    """Item 20: (b) ``fsdp: true`` over an nccl world of 1 is the plain step,
    (e) the eval sweep, (a) + (c) the FSDP ranks against the data-parallel
    ones, (d) their checkpoint booting one process. ``dp_runs``: item 19's
    result. Returns {stage: {backend: [launches of each rank's FSDP step]}}."""
    import shutil
    import tempfile
    import torch
    from dc_vic_tpu_torch.parallel.mesh import init_distributed, teardown
    from dc_vic_tpu_torch.tools import fsdp_bytes
    from dc_vic_tpu_torch.train.trainer import build_trainer
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="dcvic_fsdp_")
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    try:
        _training_images(root)
        dp1 = init_distributed(0, 1, "nccl", f"file://{os.path.join(root, 'store_nccl1')}")
        try:
            for stage in DP_STAGES:
                opt = training_opt(stage, root)
                opt["fsdp"] = True
                tr = build_trainer(opt, dp=dp1)
                if tr.fsdp is not None:
                    raise AssertionError("fsdp: true sharded a world of 1")
                batch = tr._to_device(next(tr.train_loader.epoch_batches(0))["real_images"])
                snap = _snapshot(tr)
                terms, launched, _ = _dp_step(tr, batch, None, grads=False)
                after = _bits(_train_state(tr))
                _restore(tr, snap)
                terms1, launched1, _ = _dp_step(tr, batch, dp1, grads=False)
                if (terms1, launched1, _bits(_train_state(tr))) != (terms, launched, after):
                    raise AssertionError(f"stage {stage}: fsdp: true over an nccl world of 1 "
                                         f"is not the plain step bit for bit")
                print(f"item 20 (b), stage {stage}: fsdp: true over an nccl world of 1 shards "
                      f"nothing and gives the plain step's bits (terms, weights, optimizer "
                      f"states; total {terms['total']:.6f})")
                if stage == DP_STAGES[0]:
                    _eval_sweep(tr.model.eval(), batch, smi)
                del tr, snap
                torch.cuda.empty_cache()
        finally:
            teardown()
        runs = [("gloo", ["cuda:0"] * DP_WORLD)]
        if torch.cuda.device_count() >= 2:
            runs.append(("nccl", [f"cuda:{i}" for i in range(DP_WORLD)]))
        else:
            print(f"item 20: one card ({smi}), so no nccl run over {DP_WORLD} cards")
        saved = None
        for backend, devices in runs:
            done = os.path.join(root, f"fsdp_{backend}")
            os.makedirs(done)
            torch.multiprocessing.spawn(
                _fsdp_rank, args=(DP_WORLD, backend, os.path.join(root, f"store_fsdp_{backend}"),
                                  root, devices, done), nprocs=DP_WORLD, join=True)
            ranks = [torch.load(os.path.join(done, f"rank{r}.pt"), weights_only=False)
                     for r in range(DP_WORLD)]
            for stage in DP_STAGES:
                label = f"item 20, stage {stage}, {DP_WORLD} ranks ({backend}, {devices})"
                item19 = dp_runs[stage].get(backend)
                for r, rank in enumerate(ranks):
                    dp, fs = rank[stage]["dp"], rank[stage]["fsdp"]
                    if fs["start"] != dp["start"] or fs["start"] != ranks[0][stage]["dp"]["start"]:
                        raise AssertionError(f"{label}: rank {r}'s FSDP trainer did not start "
                                             f"from the data-parallel bits")
                    if fs["terms"] != dp["terms"] or fs["terms"].get("skipped"):
                        raise AssertionError(f"{label}: rank {r} terms {fs['terms']} against "
                                             f"{dp['terms']}")
                    if fs["launched"] != dp["launched"] or (
                            item19 is not None and fs["launched"] != item19["launched"][r]):
                        raise AssertionError(f"{label}: rank {r} launches {fs['launched']}, "
                                             f"data parallel {dp['launched']}")
                if ranks[0][stage]["after"] != ranks[1][stage]["after"]:
                    raise AssertionError(f"{label}: the ranks' gathered states differ")
                held = [rank[stage]["held"] for rank in ranks]
                got = [rank[stage] for rank in ranks]
                plan = fsdp_bytes.count(training_opt(stage, root), DP_WORLD)
                if any((g["fsdp"]["resident"], g["dp"]["resident"])
                       != (plan["resident_fsdp"], plan["resident_dp"]) for g in got):
                    raise AssertionError(
                        f"{label}: a rank holds {[g['fsdp']['resident'] for g in got]} B "
                        f"between FSDP steps, {[g['dp']['resident'] for g in got]} B between "
                        f"data-parallel ones; the plan gives {plan['resident_fsdp']} and "
                        f"{plan['resident_dp']}")
                print(f"{label}: terms equal to the data-parallel step's (total "
                      f"{got[0]['fsdp']['terms']['total']:.6f}); each rank's slices and whole "
                      f"tensors after the step against the data-parallel rank's at rtol {FSDP_TOL['rtol']}, atol {FSDP_TOL['atol']}: "
                      + "; ".join(f"rank {r} {n} tensors, {eq} bit-equal, largest |difference| "
                                  f"{w:.3e} ({name})" for r, (n, eq, w, name) in enumerate(held))
                      + f"; the gathered states bit-equal across the ranks; launches a rank "
                      f"{got[0]['fsdp']['launched']['forward']} (= the data-parallel step's"
                      + ("" if item19 is None else " and item 19's") + ")")
                print(f"{label}: bytes of parameters and moments each rank holds between "
                      f"steps {plan['resident_fsdp']} FSDP against {plan['resident_dp']} data "
                      f"parallel ({plan['resident_fsdp'] / plan['resident_dp']:.4f}), as "
                      f"tools/fsdp_bytes.py counts them; a step all-gathers "
                      f"{plan['all_gather']} B ({plan['sharded']} tensors), reduce-scatters "
                      f"{plan['reduce_scatter']} B ({plan['sharded_trained']}) and all-reduces "
                      f"{plan['all_reduce']} B (+ the terms); peak over a warm step "
                      + ", ".join(f"{g['fsdp']['peak_gib']:.2f} / {g['dp']['peak_gib']:.2f}"
                                  for g in got)
                      + " GiB a rank (FSDP / data parallel); warm step "
                      + ", ".join(f"{g['fsdp']['step_s']:.4f} / {g['dp']['step_s']:.4f}"
                                  for g in got)
                      + " s a rank (FSDP / data parallel); the collectives alone: all-gather "
                      + ", ".join(f"{g['gather_s']:.4f}" for g in got)
                      + " s, reduce-scatters and all-reduce "
                      + ", ".join(f"{g['scatter_s']:.4f}" for g in got)
                      + f" s ({smi}; host clock, one step each"
                      + ("" if item19 is None else ", item 19's data-parallel ranks "
                         + ", ".join(f"{s:.4f}" for s in item19["step_s"]) + " s")
                      + ")")
                out.setdefault(stage, {})[backend] = [g["fsdp"]["launched"] for g in got]
            if saved is None:
                saved = ranks[0][DP_STAGES[-1]]
        # (d) the FSDP ranks' checkpoint boots one process
        paths = saved["saved"]
        tr = build_trainer(training_opt(DP_STAGES[-1], root, load=dict(
            path=paths[0], training_state_path=paths[1], discriminator_path=paths[2],
            strict=True)))
        if not (tr.restored["strict"] and tr.restored["optimizer"]
                and tr.restored["discriminator"]):
            raise AssertionError(f"item 20 (d): the boot took {tr.restored}")
        if _bits(_train_state(tr)) != saved["saved_bits"]:
            raise AssertionError("item 20 (d): the 1-process trainer booted from the FSDP "
                                 "checkpoint differs from the ranks' gathered state")
        print(f"item 20 (d): the FSDP ranks' stage {DP_STAGES[-1]} checkpoint "
              f"({', '.join(os.path.basename(p) for p in paths)}) boots one process bit for bit "
              f"(model, discriminator, g_opt, aux_opt and d_opt states)")
        del tr
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    print(f"item 20 took {time.perf_counter() - t_phase:.1f} s")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script runs on a GPU")
    sys.path.insert(0, ROOT)
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import RECON_KERNELS, build_comp_model, init_weights
    from dc_vic_tpu_torch.ops import (attention, conv3x3, gn, native, rans_device, rans_host,
                                      vq)
    from dc_vic_tpu_torch.tools.workload import scale_encoder
    from dc_vic_tpu_torch.utils.config import load_config

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    t = time.perf_counter()
    native.kernels()
    native.rans()
    print(f"build: {time.perf_counter() - t:.1f} s (kernels + host rANS coder)")
    report_ptxas(native.build_logs.get("libdcvic_kernels.so", ""))

    # the numerics the codec runs with: f32 convolutions and products without
    # TF32, deterministic cuDNN algorithms (Codec sets the same)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = check_vq(vq, dev, gen)
    k1["launch_floor_ms"], k1["launch_floor_profiled_ms"] = launch_floor_ms(native)
    k1["bound_with_launch_ms"] = max(k1["bound_ms"], k1["launch_floor_ms"])
    k2 = check_attention(attention, dev, gen)
    print(f"K1 at M={k1['per_m'][-1]['M']}: kernel {k1['ms'] * 1e3:.3f} us device time (graph "
          f"replay; {k1['profiled_ms'] * 1e3:.3f} us by the profiler), plain "
          f"{k1['plain_ms'] * 1e3:.3f} us, bound {k1['bound_ms'] * 1e3:.3f} us "
          f"({k1['bound_by']}); an empty kernel takes {k1['launch_floor_ms'] * 1e3:.3f} us "
          f"(graph; {k1['launch_floor_profiled_ms'] * 1e3:.3f} us profiler) from launch to "
          f"finish, so the larger of the two is {k1['bound_with_launch_ms'] * 1e3:.3f} us")
    print(f"K2 at [4,6144,512]: kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, "
          f"bound {k2['bound_ms']:.3f} ms ({k2['bound_by']}, 3xTF32; "
          f"{k2['bound_ffma_ms']:.3f} ms at the f32 rate), "
          f"F.scaled_dot_product_attention {k2['library_ms']:.3f} ms; at [16,6144,512] "
          f"{k2['per_shape'][-1]['ms']:.3f} ms")
    k3, k4 = check_gn(gn, dev, gen)
    k5, k6 = check_conv(conv3x3, dev, gen)
    torch.cuda.empty_cache()
    r1, r2 = check_rans(rans_device, rans_host, Codec, dev)
    for r in (r1, r2):
        print(f"{r['name']} at lanes 128: kernel {r['ms']:.4f} ms ({r['ms_lanes512']:.4f} ms "
              f"at lanes 512), plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}), dependent chain {r['chain_ms']:.4f} ms")
    torch.cuda.empty_cache()
    recon_names = (*gn.launches, *conv3x3.launches)

    t = time.perf_counter()
    opt = load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    spec = build_comp_model(opt)
    init_weights(spec.module, torch.Generator(device=dev).manual_seed(0))
    codec = Codec(spec, stream_format="compressai", params_backend="accel")
    print(f"flagship model: {sum(p.numel() for p in spec.module.parameters())} "
          f"parameters, built in {time.perf_counter() - t:.1f} s")

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 768, 512, 3), dtype=np.uint8)
    y_hat, default_launches, _ = counted_round_trip(
        codec, images, "compressai format, default path, batch 4 768x512")
    if any(default_launches[k] for k in recon_names):
        raise AssertionError("the default path launched a reconstruction kernel")
    if default_launches["vq_argmin"] != 1 or default_launches["flash_attention"] < 1:
        raise AssertionError(f"the default path's launches: {default_launches}")

    img1 = rng.integers(0, 256, (1, 500, 740, 3), dtype=np.uint8)
    verify(codec, img1, *drive(codec, img1), "compressai format, default path, batch 1 500x740")
    check_codec_scope(codec, img1)

    # the tpu stream format on the same model: host and device encode backends
    tpu = {(backend, lanes): Codec(spec, encode_backend=backend, lanes=lanes)
           for backend, lanes in (("host", 128), ("device", 128), ("device", 512))}
    strings = {}
    for (backend, lanes), c in tpu.items():
        label = f"tpu format, {backend} backend, lanes {lanes}, batch 4 768x512"
        _, got, _ = counted_round_trip(c, images, label)
        for k in ("vq_argmin", "flash_attention", *recon_names):
            if got[k] != default_launches[k]:
                raise AssertionError(f"{label}: {k} launched {got[k]} times, "
                                     f"{default_launches[k]} in the compressai format")
        res = c.compress(images, 0)
        strings[backend, lanes] = [r["string_list"] for r in res]
        for r in res:
            h = HeaderHandler.decode(r["string_list"][0])
            want = dict(stream_format="tpu", lanes=lanes, encode_batch=4, portable=False,
                        fast_entropy=False, bf16=False, t2free=True, img_size=(768, 512),
                        quality_ind=0)
            if len(r["string_list"][0]) != 9 or any(h[k] != v for k, v in want.items()):
                raise AssertionError(f"{label}: header {h}")
        print(f"{label}: header {HeaderHandler.decode(res[0]['string_list'][0])}; "
              f"pred_y_bpp {res[0]['pred_y_bpp']:.4f}, pred_z_bpp {res[0]['pred_z_bpp']:.4f}")
    if strings["host", 128] != strings["device", 128]:
        raise AssertionError("the host and device encode backends wrote different streams")
    print("tpu format: the host and device encode backends wrote identical strings")
    try:
        tpu["device", 128].decompress(strings["device", 128][:2])
    except ValueError as e:
        print(f"a batch-4 stream decoded as batch 2 raises: {str(e)[:90]}...")
    else:
        raise AssertionError("a batch-4 stream decoded as batch 2 did not raise")
    # the decode chain must not wait for the card: PyTorch raises on any
    # synchronising call while the debug mode is "error"
    probe = torch.ones(1, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        probe.cpu()
    except RuntimeError:
        pass                                   # the mode does see a fetch
    else:
        raise AssertionError("the sync debug mode let a device-to-host copy through")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with sync_free_decode(tpu["device", 128]):
        out_tpu = tpu["device", 128].decompress(strings["device", 128])
    print("tpu format: the decode chain ran with torch.cuda.set_sync_debug_mode('error'): "
          "no host synchronisation between the upload and the final fetch")
    pending = tpu["device", 128].decompress(strings["host", 128], defer_fetch=True)
    if not np.array_equal(pending.fetch(), out_tpu):
        raise AssertionError("defer_fetch returned other images")

    # one warm round trip of each format, this run, this card
    codecs = {"compressai": codec, **{f"tpu/{b}/lanes {n}": c for (b, n), c in tpu.items()}}
    for name, c in codecs.items():
        res, _, enc, dec = drive(c, images)
        bpp = float(np.mean([r["bpp"] for r in res]))
        print(f"warm round trip, {name}: encode {enc:.4f} s, decode {dec:.4f} s "
              f"(one run), {bpp:.4f} bpp")
    del tpu, codecs, pending
    torch.cuda.empty_cache()

    # the same model with every reconstruction kernel on, in both formats
    spec_k = build_comp_model(opt, recon_kernels=RECON_KERNELS)
    spec_k.module.load_state_dict(spec.module.state_dict(), strict=True)
    codec_k = Codec(spec_k, stream_format="compressai", params_backend="accel")
    _, launches_c, conv_shapes = counted_round_trip(
        codec_k, images, "compressai format, reconstruction kernels on, batch 4 768x512")
    codec_kt = Codec(spec_k, encode_backend="device")
    _, launches, _ = counted_round_trip(
        codec_kt, images, "tpu format, device backend, reconstruction kernels on, "
        "batch 4 768x512")
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    for k in ("vq_argmin", "flash_attention", *recon_names):
        want = default_launches[k] if k in ("vq_argmin", "flash_attention") else launches_c[k]
        if launches[k] != want or launches_c[k] < 1:
            raise AssertionError(f"{k}: {launches[k]} launches in the tpu format with the "
                                 f"reconstruction kernels on, expected {want}")
    compare_models(codec, codec_k, images, y_hat)
    # the deployment workload's weights: the same seed, encoder scaled
    deployment_sd = scale_encoder(spec.module.state_dict())
    del codec, codec_k, codec_kt, spec, spec_k
    torch.cuda.empty_cache()

    print(json.dumps({"conv_launch_shapes": {
        name: [{"shape": list(shape), "launches": n} for shape, n in sorted(table.items())]
        for name, table in conv_shapes.items()}}))
    time_conv_shapes(conv3x3, conv_shapes["conv3x3_same"], dev, gen)

    bf16_kernels = check_bf16_kernels(gn, conv3x3, dev, gen)
    torch.cuda.empty_cache()

    launches16, shapes16 = check_deployment(deployment_sd)
    path_rows = check_path_shapes(gn, conv3x3, shapes16, dev, gen)
    torch.cuda.empty_cache()

    launches_tiled, _ = check_tiled(opt, deployment_sd, smi, dev, gen)
    torch.cuda.empty_cache()

    training = check_training(smi, dev, gen)
    torch.cuda.empty_cache()

    launches_eval, _ = check_evaluation(opt, deployment_sd, smi, dev)
    torch.cuda.empty_cache()

    t15 = time.perf_counter()
    launches_11 = check_stage1_1(smi, dev)
    torch.cuda.empty_cache()
    launches_var = check_variants({"compressai": launches_c, "tpu": launches}, smi, dev)
    torch.cuda.empty_cache()
    r1_one, r2_one = check_one_section(rans_device, rans_host, dev)
    r1.update(r1_one)
    r2.update(r2_one)
    print(f"R2 over the one y section of a model without ChARM: "
          f"{r2['ms_one_section_lanes512']:.4f} ms, against six sections of the flagship's "
          f"stream {6 * r2['ms_lanes512']:.4f} ms (six launches of {r2['ms_lanes512']:.4f} ms)")
    print(f"item 15 took {time.perf_counter() - t15:.1f} s")

    t16 = time.perf_counter()
    oasis = check_oasis(smi, dev)
    torch.cuda.empty_cache()
    profile_contract(deployment_sd, launches16, smi)
    torch.cuda.empty_cache()
    print(f"item 16 took {time.perf_counter() - t16:.1f} s")

    soak_steps = check_soak(smi, dev, gen)
    torch.cuda.empty_cache()

    t18 = time.perf_counter()
    launches_alt = check_alt_variants(smi, dev)
    alt_step = check_alt_training(smi, dev)
    check_standalone(smi, dev)
    print(f"item 18 took {time.perf_counter() - t18:.1f} s")

    t19 = time.perf_counter()
    dp_launches = check_data_parallel(smi)
    launches_mesh = check_mesh_codec(deployment_sd, smi)
    del deployment_sd
    torch.cuda.empty_cache()
    print(f"item 19 took {time.perf_counter() - t19:.1f} s")

    fsdp_launches = check_fsdp(smi, dp_launches)
    torch.cuda.empty_cache()

    kernels = [k1, k2, k3, k4, k5, k6, r1, r2]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_bf16_batch16"] = launches16[k["name"]]
        k["launches_tiled_2048x1365"] = launches_tiled[k["name"]]
        k.update(training["kernels"].get(k["name"], {}))
        for phase, table in launches_eval.items():
            k[f"launches_eval_{phase.replace(' ', '_')}"] = table[k["name"]]
        for path, table in launches_var.items():
            k[f"launches_{path.replace('/', '_')}"] = table[k["name"]]
        k["train_launches_stage1_1_step"] = launches_11["forward"][k["name"]]
        k["train_backwards_stage1_1_step"] = launches_11["backward"].get(k["name"], 0)
        k["train_launches_oasis_step"] = oasis["launched"]["forward"][k["name"]]
        k["train_backwards_oasis_step"] = oasis["launched"]["backward"].get(k["name"], 0)
        k["train_launches_soak_step"] = soak_steps["forward"].get(k["name"], 0)
        k["train_backwards_soak_step"] = soak_steps["backward"].get(k["name"], 0)
        for run, table in launches_alt.items():
            k[f"launches_{run}"] = table[k["name"]]
        k["train_launches_variant_a_step"] = alt_step["forward"][k["name"]]
        k["train_backwards_variant_a_step"] = alt_step["backward"].get(k["name"], 0)
        k["launches_mesh_2_batch16"] = launches_mesh[k["name"]]
        for stage, table in dp_launches.items():
            k[f"train_launches_dp_{stage}_plain"] = table["plain"]["forward"][k["name"]]
            for backend, run in table.items():
                if backend != "plain":
                    k[f"train_launches_dp_{stage}_{backend}_ranks"] = [
                        launched["forward"][k["name"]] for launched in run["launched"]]
        for stage, table in fsdp_launches.items():
            for backend, ranks in table.items():
                k[f"train_launches_fsdp_{stage}_{backend}_ranks"] = [
                    launched["forward"][k["name"]] for launched in ranks]
    for k in bf16_kernels:
        k["launches"] = launches16[k["name"][:-len("_bf16")]]
        k["path_shapes"] = [r for r in path_rows if r["name"] == k["name"]]
    kernels += bf16_kernels
    for k in kernels:
        if k["ms"] < k["bound_ms"]:
            raise AssertionError(f"{k['name']}: {k['ms']:.4f} ms is under its bound of "
                                 f"{k['bound_ms']:.4f} ms: the bound or the timing is wrong")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

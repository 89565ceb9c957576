#!/usr/bin/env python3
"""Smoke test of the PyTorch port (super_resolution_tpu_torch) on one
NVIDIA GPU.

Phases, each of which raises on failure:
  1. probe: torch and CUDA versions, the card's name and power limit;
  2. build: nvcc builds the kernels from super_resolution_tpu_torch/csrc;
     each kernel's registers, stack and spills (ptxas) and its HMMA
     instructions (the SASS, where the toolkit has cuobjdump): the
     tensor-core kernels must hold some;
  3. kernels: each of the eighteen kernel wrappers (and the bare gated FFN
     entry) against its plain PyTorch version on the card, at the shapes
     its main path gives it (the flagship HAT's, ESC's window 32, ESC-XL's
     window 48, ATD's head dim 35, SRFormer's window 24 against its
     permuted 12 and HiT-SRF's six window sizes from 4 to 64 at head dim
     5), in float32 (TF32 off) and bfloat16 (the two global sums of
     ``hab_front`` by their error relative to the magnitudes they add), with
     CUDA-event times of the kernel, the plain version and, where one
     PyTorch call computes the same function, that call; beside them the
     least time the card could take (bound), from the bytes and operations
     of the call, and for every kernel with a softmax the time of its
     exponentials on the special-function units (exp floor; for
     ``msa_qtile_attention`` and ``fused_psa_block`` also their two-pass
     designs', two exponentials a score). The four attention-only kernels,
     ``fused_ocab_attention``, ``fused_psa_block``, ``fused_msa_attention``,
     ``fused_ocab_block`` and ``fused_msa_block(_shifted)`` run bf16 on
     their tensor-core kernels and float32 on their FMA kernels, so both
     are checked; the library time of ``hab_front``, ``fused_ocab_block``
     and ``fused_msa_block(_shifted)`` is a composition of calls; rows 1
     and 2 are also timed at SwinIR's window 8, with an explicit zero mask
     and at a head group's slice; ``mlp_block(_sum3(_shifted))`` run bf16
     on their tensor-core kernel and float32 on their FMA kernel, their
     library time is a composition of calls, and they are also timed at
     SwinIR's widths (C / hidden 60 / 120, 240 / 480, 180 / 720) and
     checked at a tensor-parallel worker's hidden slice;
     ``gated_dconv_ffn(_block)`` and ``fused_hab_block`` run bf16 on their
     tensor-core kernels and float32 on their FMA kernels, their library
     time is a composition of calls, and the gated FFN is also timed at
     HAT-S's width (C / M 144 / 288) and as the bare entry at C_out 36;
     ``hab_front`` and ``fused_scc_block`` run bf16 on their tensor-core
     kernels and float32 on their FMA kernels, their library time is a
     composition of calls, and ``hab_front`` is also timed at HAT-S's
     width (C / MID 144 / 6) and checked on a ragged image; ``ln_split``
     runs bf16 on its vector kernel and float32 on its first version, and
     is also timed on two inputs in turn and through its C entry (the
     kernel alone, without the wrapper's host work); and the kernels of
     phase 5 at the shapes a whole image gives them (rows 5 to 9 on
     (1, 64, 96, 180) and (1, 80, 80, 180), ``fused_attention`` on ESC's
     six windows of 64 x 96), in both dtypes;
  4. main paths: Predictor -> runner in tile mode -> network at the
     published width (bf16, seeded random weights) answers requests:
     classic HAT x4 (HATClassic), the fork's HAT x2 with the ESC-infused
     OCAB, one request of the fork's HAT with the plain OCAB, ESC x4 on its
     own route and on ``fused_attention_v3``, ESC-XL x4 on its own route
     and on ``msa_qtile_attention``, ATD x4 and the shipped ATD-light x4,
     SRFormer x4 and the shipped SRFormer-light x4, HiT-SRF x4,
     classic HAT x4 on its whole-block route (``fused_hab_block``), the
     fork's HAT x2 on its ``hab_front`` route, SwinIR-M x4 (classical),
     lightweight SwinIR x4, real-world SwinIR-L x4, ESC-FP x4, ESC-Real x4
     and ESC-RealM x2 with the DySample head. The launch counts
     are set to 0 before each path and read after it; the counts, the
     output shapes and values, and the PSNR against the port's float32
     path are checked; a route of another path's network is held against
     that path's output;
  5. evaluation paths: the port's test pipeline (test.py) on the disk
     backend, on a synthetic Set5 (Set5's GT sizes, the LR by the MATLAB
     bicubic) with the option files unedited but for their data roots,
     weights (the widened seeded weights in a .pth under params_ema) and
     results root: options/test/HAT_SRx4.yml (whole images) in float32
     through the CLI's entry and in bf16, options/esc/test/ESC_DIV2K_X4.yml
     (its Set5 set) in float32 and bf16, and options/test/
     HAT_tile_example.yml (one 300 x 400 image, tiled) in bf16. Checked:
     the launches an image or chunk forward, the PNGs and their sizes,
     finite metrics, PSNR of bf16 against float32 on the card, and the
     float32 PSNR / SSIM of the smallest image against the port's run on
     the host CPU; each path's seconds an image, split into inference and
     the host's tensor2img, PNG and metrics;
  6. training: (a) the four kernels of a train step (ln_split,
     gated_dconv_ffn_block, fused_ocab_block, mlp_block) through their
     autograd entries (kernel forward, autograd through the plain version
     backward) at the training shape (4, 64, 64, 180), float32 and bf16:
     forward and every input's gradient against the plain version, forward
     + backward times; (b) the port's train pipeline (train.py) on
     options/train/train_HAT_SRx4_from_scratch.yml in float32 at a batch of
     4 (the file's 32 does not fit: batch 4 peaks near 11 GiB, about 2.7 GiB
     a sample of saved activations) and (c) on
     options/train/train_HAT_SRx4_amp_remat.yml (bf16, per-RHAG remat) at
     its own batch 32, each file at 2 of its 6 RHAGs (for the run's time
     limit) and otherwise unedited but for its data roots (32
     synthetic DF2K-sub pairs, GT 480 x 480, LR by the MATLAB bicubic; the
     two images of the synthetic Set5 whose LR sides are multiples of the
     window, since the files' SRModel does not pad), total_iter 6, val_freq 3,
     save_checkpoint_freq 3 and print_freq 1. Checked: finite losses, the
     first step's loss against a float32 forward on the same batch,
     weights and drop-path draws (on the host CPU for (b), on the card for
     (c)), net_g_3 and net_g_6 strict-loadable, a run resumed from net_g_3
     against the uninterrupted one, the launches a step (rows 7, 8 once, in
     the one block at drop-path rate 0; rows 5, 6 twice, once a RHAG; twice
     as many under remat) and an eval image; seconds a step, images a
     second and peak memory;
  7. ESC-family training: (a) the four autograd entries ESC training and
     the fork's HAT x2 add (fused_attention at ESC x4's step, q (64, 4,
     1024, 16); fused_msa_block at window 16 on (16, 64, 64, 64);
     msa_flash_attention at ESC-XL's window 48 on qkv (2, 96, 96, 576);
     fused_ocab_attention at the fork's HAT x2 step, (8, 64, 64, 180)),
     float32 and bf16, as phase 6 (a), with the peak memory of each
     forward + backward; (b) the train pipeline on
     options/esc/train/ESC_DIV2K_X4.yml as shipped (ESRModel, float32,
     batch 16, gt 256; its five validation sets all on the synthetic
     Set5's window-multiple pairs), on the same file with the ESC
     strategy's options added (top-level use_amp, gradient_clip 1.0,
     reset_momentum_iter 2, MESA from iteration 4), on ESC_DFLIP_X4.yml
     (DownsampleImageDataset on the GT folder), on ESC_FP_X4.yml, on
     options/train/train_HAT_SRx2_from_scratch.yml at batch 8 (cut from
     32: float32 without remat takes ~2.7 GiB a sample) with x2 LR of the
     same GT, and on train_HAT_SRx2_ImageNet_from_scratch.yml
     (ImageNetPairedDataset over a synthetic meta_info_file) at its batch
     4, each at 2 of its 5 blocks (ESC) or 6 RHAGs (HAT), for the time;
     checked as phase 6 (b), and the EMA of the resumed run, the momentum
     resets (2, 4, 6; 4, 6 resumed) and MESA's loss (0 before iteration 4)
     in both runs, the row 10 launches a step (2, 4 with MESA) and row 9's
     (2);
  8. real-world GAN training: (a) the degradation synthesizer on the card
     against the CPU (the GAN file's chain with its noise ranges at 0 and
     its JPEG qualities fixed: deterministic; the LQ within 1e-4 but for
     pixels one 8-bit level away, at most 0.5 % of them); (b) the train
     pipeline on the four shipped real-world files at their published
     widths and batches, 2 of their 6 RHAGs (ESCReal 2 of 10 blocks; a
     cut for the time limit) (options/train/train_Real_HAT_SRx4_mse_model.yml
     and train_Real_HAT_GAN_SRx4_finetune_from_mse_model.yml: the fork's HAT
     x4, batch 4; options/esc/train/ESC_Real_X4_MSE.yml and
     ESC_Real_X4_GAN.yml: ESCReal x4, batch 12; gt 256 from a 400 canvas),
     each in a copy with its GT root (12 synthetic images of 400 to 480 a
     side), no pretrained G, seeded random VGG19 weights under
     torchvision's names, a queue of two batches, 4 iterations and a
     checkpoint every 2 overridden and logged; then a run resumed from
     net_g_2. Checked: finite losses; the first iteration's losses against
     the same iteration recomputed on the host CPU from the run's weights
     and batch; the launches an iteration (rows 5 to 8: 6, 6, 36, 36; row
     10: 10); that D and its spectral-norm u moved; the resumed run
     against the uninterrupted one. Printed: s an iteration, images a
     second, the synthesizer's and the G and D steps' ms, peak memory;
  9. HATX: the train pipeline on
     options/train/train_HAT_SRx2_ESC_OCAB_from_scratch.yml (HATX x2 at
     its published width and batch 2, float32; its paired meta_info_file
     replaced by one listing the synthetic pairs' GT names),
     6 iterations with tile validation (64 / 16) on the x2 Set5 pairs,
     then resumed from net_g_3, checked as phase 6 (b); no kernel runs
     (JAX routes none of HATX to Pallas); then one HybridHATNAF forward at
     the file's HATX widths on the card against the host CPU, no kernel
     launched;
  10. the arbitrary-scale app: (a) the autograd entries of rows 1, 2, 6,
     12 and 14 at the arb encoders' training steps (batch 32: SwinIR's
     unshifted and shifted blocks and MLP tail at 48 x 48, C 60 in 6 heads
     of 10; ATD-light's shifted attention at 64 x 64, C 48; HiT-SRF's SCC
     at 64 x 64, C 60, windows 8 and 64), as phase 6 (a); (b) LTE over each of the seven encoders at its published width
     on one 64 x 64 LR queried at x3, in float32 and with the encoder in
     bf16 (utils/precision.py), bf16 against float32 >= 35 dB, the
     launches of a forward; (c) eval_arb on test-fast-set5-4.yml (one
     call, then chunked: equal) and test-div2k-4.yml (chunked) with LIIF
     over SwinIR on synthetic pairs, ``scale: 4`` added to the files'
     datasets (they lack it, in JAX too); (d) train_arb for 3 iterations
     at each file's batch, at most 16 (a cut for the time limit: the files
     of 32 run at 16), on synthetic 256 x 256 GT: the five files JAX
     trains and train_esc-lte, train_rdn-metasr, train_swinir-lte with
     ``no_upsampling`` dropped from their encoder specs (logged): finite
     losses, the first against the host CPU's on the same batch and
     weights (1e-4 relative), the launches a step, the checkpoints; s an iteration, images
     a second and peak memory printed;
  11. training on every kernel route: (a) the autograd entries of rows 3,
     4, 15, 18 and the bare gated FFN at the flagship HAT x4's step (4, 64,
     64, 180), row 13 at SRFormer x4's (4, 72, 72, 180) without and with
     the shift mask, row 16 at ESC-XL x4's qkv (4, 96, 96, 576), as phase 6
     (a); (b) train.py's SR runner on options/train/
     train_HAT_SRx4_from_scratch.yml with network_g swapped at drop-path
     rate 0 (classic HAT x4 at the flagship width on both hab_routes,
     SRFormer x4, SwinIR-M x4, ESC-XL x4 on the forced qtile route, the
     file's fork HAT x4 on hab_front), batch 4, 3 steps, no validation:
     finite losses, the launches each step, the first loss against the
     host CPU's (1e-4 relative; the classic HAT at 2 of its 6 RHAGs and
     ESC-XL at 2 of its 8 blocks, for the time), then one step at rate 0.1
     through the runner and its launches; (c) SRGANModel (MSRResNet 64 x
     16) and
     ESRGANModel (RRDBNet 64 x 23, grow 32) against the VGG-style
     discriminator at 64 features on 128 x 128 GT patches, BasicSR's SRGAN
     / ESRGAN losses (L1 1e-2, VGG19 conv5_4 1, vanilla GAN 5e-3), batch
     16, on RealESRGANPairedDataset over a meta_info of the synthetic pairs,
     3 iterations: the first G and D losses against the host CPU's, D
     moved, no kernel launched; and ESRModel on ESC_DIV2K_X4.yml with that
     VGG19 loss added, batch 4 (cut from 16), its first pixel and
     perceptual losses against the host CPU's;
  12. the rest of the evaluation surface: (a) test.py on
     options/test/HAT_tile_example.yml (the fork's HAT x4 at full width,
     tile 256 / pad 32, chunk 4) with val: {bucketed_eval: true} and PSNR /
     SSIM added, over synthetic pairs of Urban100 x4's LR sides (141 to
     256; two sizes twice) and one 300 x 400 LR, bucketed and per image, in
     bf16 (each three times) and float32: the launches a chunk forward (rows 7, 8
     36 times, rows 5, 6 six), one input shape a bucket, bucketed against
     per image (float32 max|diff| <= 1e-4, bf16 >= 45 dB), s an image of
     each route, wall and inference (bf16: a first run of each route,
     then bucketed, per image, per image, bucketed); (b) SRModel.test_selfensemble of options/test/HAT_SRx4.yml's
     network at full width on one Set5 LR image, float32 on the card
     against the host CPU within 1e-4, eight forwards' launches; (c) that
     file's test pipeline on the synthetic Set5 read from .lmdb folders the
     port's make_lmdb_from_imgs wrote, against the disk run: equal PSNR /
     SSIM; (d) RawPack's reader built by g++, crop_batch against numpy, and
     three iterations of phase 6's float32 file on a RawPackPairedDataset
     over packs of phase 6's pairs: finite losses, the first batch against
     numpy crops of the PNGs; (e) logger.profile on (a) and (d): one Chrome
     trace each that names row 7's kernel (the tensor-core kernel in (a)'s
     bf16, the FMA kernel in (d)'s float32); (f) calculate_psnr_pt /
     calculate_ssim_pt on (a)'s outputs on the card against numpy, and
     tools/eval_folder.py on (a)'s PNGs against the pipeline's metrics;
 13. video SR, float32 with TF32 off, no kernel on the path: (a) the plain
     DCN at EDVR-M's L1 shape (1, 180, 320, 64, dg 8) and at BasicVSR++'s
     alignment (1, 180, 320, 128, dg 16), and the flow warp, on the card
     against the host CPU, with their CUDA-event ms; (b) EDVR-M, EDVR-L,
     TOFlow, DUF-52L, BasicVSR, IconVSR and BasicVSR++ at BasicSR's
     widths on seeded weights (the DCNs' offset convs drawn): a 64 x 64
     clip against the host CPU (1e-3 of the output's scale), then one
     REDS-size request (LR 180 x 320; 5 frames for EDVR, 7 for DUF and
     TOFlow at 256 x 448, 15 for the recurrent three): ms a clip,
     out-Mpix/s, peak memory, the CUDA-event spans of the DCN, warp and
     SpyNet calls and, from torch.profiler, the device time of the
     kernels each launches beside the device's busy time; (c) train.py
     through EDVRModel (EDVR-M, batch 4, tsa_iter 2, dcn_lr_mul 0.5) and
     VideoRecurrentModel (BasicVSR, batch 1, 15 frames, fix_flow 2,
     flow_lr_mul 0.125) on a synthetic REDS-layout clip, LR 64, 3
     iterations: the first loss against the host CPU's, the frozen part
     unmoved for 2 iterations and moved after; (d) one iteration of
     VideoGANModel (EDVR-M) and VideoRecurrentGANModel (BasicVSR, 5
     frames, fix_flow, lr_flow) against the U-Net discriminator with
     spectral norm and a seeded VGG19: every loss against the host CPU's,
     D moved; (e) test.py through VideoTestDataset (EDVR-M) and
     VideoRecurrentTestDataset (BasicVSR) on seeded weights in a .pth:
     the per-folder PSNR tables;
 14. faces, float32 with TF32 off, no kernel on the path (it launches none
     of the 18 rows; each of its paths' counts is checked to be 0): (a)
     StyleGAN2Generator and StyleGAN2GeneratorBilinear at BasicSR's
     train_StyleGAN2_256_Cmul2_FFHQ widths (256 x 256, 512-dim styles, 8
     MLP layers, channel multiplier 2) on seeded weights, a forward of two
     mixed styles with explicit noise on the card against the host CPU;
     then train.py through StyleGAN2Model (and the discriminator at 256 /
     Cmul 2) at batch 4 on a disk FFHQDataset of 8 synthetic 256 x 256
     faces, the file's periods (the path penalty every 4 iterations, R1
     every 16), 16 iterations: iteration 16's losses (R1 and the path
     penalty among them) against the host CPU's from the weights before
     each step and the same draws, s a step of each of the four kinds,
     peak memory, the 4-a-row sample grid; (b) train.py through
     HiFaceGANModel (64 features; D 2 scales of 4 layers at 64) on two
     written 512 x 512 pairs at scale 1, batch 1, 2 iterations, with L1,
     a seeded VGG19 (BasicSR's five perceptual layers), MultiScaleGANLoss
     hinge and GANFeatLoss: the first iteration's losses against the host
     CPU's, s an iteration, peak memory; (c) DFDNet at 64 features on one
     512 x 512 face with a seeded dictionary in which each part's own
     feature is one atom: a forward on the card against the host CPU and
     its ms; (d) the FID InceptionV3 on a seeded pt_inception state dict:
     block-3 features on the card against the host CPU, and
     tools/eval_folder.py --fid-weights (calculate_fid) on 32 written
     96 x 96 seeded images against their noisy copies. Card
     against CPU within 1e-3 of the output's scale, first losses within
     1e-3. Alone: ``python3 -c "import chip_smoke; chip_smoke.face_main()"``.

 15. parallelism (super_resolution_tpu_torch/parallel/): (a) train.py on
     phase 6's float32 file (2 RHAGs, batch 4) for 2 steps with ``mesh:
     {data: -1}`` in an NCCL world of one against the same run without a
     mesh: losses and final weights and EMA within 1e-6 relative; (b) two
     spawned ranks of a gloo group on the one card (NCCL refuses two ranks
     on one GPU), a (model: 2) mesh: HATClassic x4 at full width (C 180,
     6 heads, window 16, hidden 360) at 2 RHAGs, one tiled forward of a
     64 x 64 input through the runner's tensor-parallel route against the
     one-process call: float32 within 1e-4 of scale, bf16 PSNR >= 35 dB
     against the float32 one-process output, each rank's launches of rows
     1 to 6 (wrapper counts, and the float32 kernels' device launches under
     torch.profiler) equal to the one-process counts; one TP train step's
     gradients against the one-process step's; (c) pipeline_forward over
     (pipe: 2) against the one-process forward, and spatial_shard_forward
     of an exact-receptive-field CNN over (data: 2) against the unsharded
     one. Alone: ``python3 -c "import chip_smoke; chip_smoke.par_main()"``.

The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}. Exits non-zero, printing neither, when there
is no CUDA device or any phase fails.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# flagship widths: classic HAT x4 (utils/kernel_parity.py:28-31 of the JAX
# package) and the fork's HAT x2
# (options/train/train_HAT_SRx2_from_scratch.yml:35-56)
C, HEADS, WS, SS, OW, HID, PDIM = 180, 6, 16, 8, 24, 360, 16
CLASSIC = dict(type="HATClassic", upscale=4, in_chans=3, img_size=64,
               window_size=WS, compress_ratio=3, squeeze_factor=30,
               conv_scale=0.01, overlap_ratio=0.5, img_range=1.0,
               depths=[6] * 6, embed_dim=C, num_heads=[HEADS] * 6,
               mlp_ratio=2, upsampler="pixelshuffle",
               resi_connection="1conv", stream_tail_rows=64)
FORK = dict(type="HAT", upscale=2, in_chans=3, img_size=64, window_size=WS,
            compress_ratio=3, squeeze_factor=30, conv_scale=0.01,
            overlap_ratio=0.5, img_range=1.0, depths=[6] * 6, embed_dim=C,
            num_heads=[HEADS] * 6, mlp_ratio=2, upsampler="pixelshuffle",
            resi_connection="1conv", esc_pdim=PDIM, esc_kernel=13,
            ocab_esc_enable=True, ocab_esc_pdim=PDIM, ocab_esc_kernel=13,
            stream_tail_rows=64)
# ESC x4 (options/esc/test/ESC_DIV2K_X4.yml) and ESC-XL x4
# (options/esc/test/ESC_XL_DF2K_X4.yml), as published
ESC = dict(type="ESC", dim=64, pdim=16, kernel_size=13, n_blocks=5,
           conv_blocks=5, window_size=32, num_heads=4, upscaling_factor=4,
           exp_ratio=1.25, attn_type="xla")
ESC_XL = dict(type="ESC", dim=192, pdim=48, kernel_size=13, n_blocks=8,
              conv_blocks=5, window_size=48, num_heads=12,
              upscaling_factor=4, exp_ratio=1.25, attn_type="xla",
              use_ln=True)
# ESC-FP x4 (options/esc/test/ESC_FP_X4.yml:44-45) and ESC-Real x4
# (options/esc/test/ESC_Real_X4.yml:29-30), as published; ESC-RealM x2 at
# ESC-Real's widths with the DySample head (the JAX package's defaults,
# mid_dim 48, the unshuffle stem by 2): no option file names it
ESC_FP = dict(type="ESCFP", dim=48, pdim=16, kernel_size=13, n_blocks=5,
              conv_blocks=5, window_size=32, num_heads=3, upscaling_factor=4,
              exp_ratio=1.25, attn_type="xla")
ESC_REAL = dict(type="ESCReal", dim=64, pdim=16, kernel_size=13, n_blocks=10,
                conv_blocks=5, window_size=32, num_heads=4,
                upscaling_factor=4, exp_ratio=2, attn_type="xla")
ESC_REAL_M = dict(ESC_REAL, type="ESCRealM", upscaling_factor=2,
                  upsampler="dysample")
# ATD x4 as published (scripts/bench_atd.py:28-31 of the JAX package builds
# the same) and the shipped options/esc/test/ATDLight/ATD_light_DFLIP_X4.yml
ATD = dict(type="ATD", upscale=4, in_chans=3, img_size=64, embed_dim=210,
           depths=[6] * 6, num_heads=[6] * 6, window_size=16,
           category_size=256, num_tokens=128, reducted_dim=20,
           convffn_kernel_size=5, img_range=1.0, mlp_ratio=2,
           upsampler="pixelshuffle", resi_connection="1conv")
ATD_LIGHT = dict(type="ATD", upscale=4, in_chans=3, img_size=64, embed_dim=48,
                 depths=[6] * 4, num_heads=[4] * 4, window_size=16,
                 category_size=128, num_tokens=64, reducted_dim=8,
                 convffn_kernel_size=7, img_range=1.0, mlp_ratio=1,
                 upsampler="pixelshuffledirect", resi_connection="1conv")
# SRFormer x4 as published (scripts/bench_srformer.py:14-15 builds the same)
# and the shipped options/esc/test/SRFormerLight/SRFormer_light_DFLIP_X4.yml
SRFORMER = dict(type="SRFormer", upscale=4, in_chans=3, img_size=64,
                window_size=24, img_range=1.0, depths=[6] * 6, embed_dim=180,
                num_heads=[6] * 6, mlp_ratio=2, upsampler="pixelshuffle",
                resi_connection="1conv")
SRFORMER_LIGHT = dict(type="SRFormer", upscale=4, in_chans=3, img_size=64,
                      window_size=16, img_range=1.0, depths=[6] * 4,
                      embed_dim=60, num_heads=[6] * 4, mlp_ratio=2,
                      upsampler="pixelshuffledirect", resi_connection="1conv")
# HiT-SRF x4 (options/esc/test/HiTSRF/HiTSRF_DFLIP_X4.yml), as published
HITSRF = dict(type="HiT_SRF", upscale=4, in_chans=3, img_size=64,
              base_win_size=[8, 8], img_range=1.0, depths=[6] * 4,
              embed_dim=60, num_heads=[6] * 4, expansion_factor=2,
              resi_connection="1conv",
              hier_win_ratios=[0.5, 1, 2, 4, 6, 8],
              upsampler="pixelshuffledirect")
# SwinIR x4: classical SwinIR-M (SwinIR's main_test_swinir.py,
# classical_sr: 001_classicalSR_DF2K_s64w8_SwinIR-M_x4), lightweight
# (lightweight_sr: 002_lightweightSR_DIV2K_s64w8_SwinIR-S_x4) and real-world
# SwinIR-L (real_sr, large_model: 003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4)
SWINIR = dict(type="SwinIR", upscale=4, in_chans=3, img_size=64,
              window_size=8, img_range=1.0, depths=[6] * 6, embed_dim=180,
              num_heads=[6] * 6, mlp_ratio=2, upsampler="pixelshuffle",
              resi_connection="1conv")
SWINIR_LIGHT = dict(SWINIR, depths=[6] * 4, embed_dim=60, num_heads=[6] * 4,
                    upsampler="pixelshuffledirect")
SWINIR_REAL_L = dict(SWINIR, depths=[6] * 9, embed_dim=240,
                     num_heads=[8] * 9, upsampler="nearest+conv",
                     resi_connection="3conv")
TILE = dict(tile_size=128, tile_pad=16, chunk=4)
# ESC-XL: a padded tile is 144 x 144, 3 x 3 windows of 48; SRFormer: 6 x 6
# windows of 24
TILE_XL = dict(tile_size=112, tile_pad=16, chunk=4)
# HiT-SRF: a padded tile is 192 x 192, the least common multiple of its six
# windows (4, 8, 16, 32, 48, 64)
TILE_HIT = dict(tile_size=160, tile_pad=16, chunk=4)
# LR request sizes: one tile; two tiles and a reflect-pad (100 x 150 is no
# window multiple); six tiles in two chunk forwards
REQUESTS = [(64, 64), (100, 150), (300, 200)]
# ESC-XL: one 96 x 96 tile; four tiles after a reflect pad to 144 x 192;
# six tiles in two chunk forwards (SRFormer: the pads are to 120 x 168 and
# 168 x 264, the tile counts the same)
REQUESTS_XL = [(96, 96), (100, 150), (150, 250)]
# HiT-SRF: one 64 x 64 tile; four 192 x 192 tiles in one forward (200 x 300
# is padded to 208 x 304); six in two forwards
REQUESTS_HIT = [(64, 64), (200, 300), (300, 400)]
PSNR_MIN_DB = 35.0
TOL_F32 = 1e-4   # times max(1, max|plain|): accumulation order only
TOL_BF16 = 2 ** -5  # times max(1, max|plain|): a few bf16 ulps at the
#                     output's scale; kernel and plain round at other points
# fused_scc_block in bf16, beside the bound on its worst element:
# |kernel - float32 plain|_2 / |float32 plain|_2 on the same bf16 inputs
TOL_SCC_BF16_L2 = 1e-2
# hab_front's two global sums: |kernel - plain| over the sum of the
# magnitudes each adds up, within TOL_F32 or TOL_BF16
FRONT_MID = C // 3
# the main paths: network, requests, how many of them also get a float32
# plain reference on the host CPU, and kernel launches per chunk forward
# (6 RHAGs; classic: 3 unshifted + 3 shifted HABs + 1 OCAB each; fork:
# 6 HABs + 1 OCAB each)
_FORK_HAB = {"ln_split": 36, "gated_dconv_ffn_block": 36, "mlp_block": 6}
# SwinIR: each RSTB's blocks alternate unshifted and shifted, each then
# mlp_block (6 RSTBs of 6; light 4 of 6; SwinIR-L 9 of 6)
_SWIN = ("fused_msa_block", "fused_msa_block_shifted", "mlp_block")
# ``runs``: (tile settings, requests) pairs served by one predictor. ESC has
# one attention launch a block (5 blocks, ESC-XL 8). ESC-XL's last run has
# 160 x 160 tiles, no multiple of 48: the reflect pad inside its window
# attention acts (160 -> 192).
PATHS = {
    "classic": dict(net=CLASSIC, runs=[(TILE, REQUESTS)], cpu_reference=2,
                    calls={"fused_msa_block": 18,
                           "fused_msa_block_shifted": 18,
                           "mlp_block_sum3": 18, "mlp_block_sum3_shifted": 18,
                           "fused_ocab_block": 6, "mlp_block": 6}),
    "fork": dict(net=FORK, runs=[(TILE, REQUESTS)], cpu_reference=1,
                 calls=dict(_FORK_HAB, fused_ocab_attention=6)),
    "fork_plain_ocab": dict(net=dict(FORK, ocab_esc_enable=False),
                            runs=[(TILE, REQUESTS[:1])], cpu_reference=0,
                            calls=dict(_FORK_HAB, fused_ocab_block=6)),
    "esc": dict(net=ESC, runs=[(TILE, REQUESTS)], cpu_reference=1,
                calls={"fused_attention": 5}),
    "esc_v3": dict(net=dict(ESC, attn_route="fused_attention_v3"),
                   runs=[(TILE, REQUESTS[:1])], cpu_reference=0,
                   calls={"fused_attention_v3": 5}),
    "esc_xl": dict(net=ESC_XL,
                   runs=[(TILE_XL, REQUESTS_XL), (TILE, [(192, 192)])],
                   cpu_reference=1, calls={"msa_flash_attention": 8}),
    "esc_xl_qtile": dict(net=dict(ESC_XL, attn_route="msa_qtile_attention"),
                         runs=[(TILE_XL, REQUESTS_XL[:1])], cpu_reference=0,
                         calls={"msa_qtile_attention": 8}),
    # one attention launch a block: ESC-FP 5, ESC-Real 10; ESC-RealM x2's
    # one request is a single 64 x 64 tile, 32 x 32 after the unshuffle
    "esc_fp": dict(net=ESC_FP, runs=[(TILE, REQUESTS)], cpu_reference=1,
                   calls={"fused_attention": 5}),
    "esc_real": dict(net=ESC_REAL, runs=[(TILE, REQUESTS)], cpu_reference=1,
                     calls={"fused_attention": 10}),
    "esc_real_m": dict(net=ESC_REAL_M, runs=[(TILE, REQUESTS[:1])],
                       cpu_reference=0, calls={"fused_attention": 10}),
    # one attention launch a layer: 6 x 6 (light: 4 x 6), half of them
    # shifted; every tile is a window multiple
    "atd": dict(net=ATD, runs=[(TILE, REQUESTS)], cpu_reference=1,
                calls={"fused_msa_attention": 36}),
    "atd_light": dict(net=ATD_LIGHT, runs=[(TILE, REQUESTS[:1])],
                      cpu_reference=0, calls={"fused_msa_attention": 24}),
    "srformer": dict(net=SRFORMER, runs=[(TILE_XL, REQUESTS_XL)],
                     cpu_reference=1, calls={"fused_psa_block": 36}),
    "srformer_light": dict(net=SRFORMER_LIGHT, runs=[(TILE, REQUESTS[:1])],
                           cpu_reference=0, calls={"fused_psa_block": 24}),
    # one launch a block, 4 groups of 6, whatever its window. The last run
    # has 160 x 160 tiles, no multiple of 48 or 64: the reflect pad of those
    # blocks acts (160 -> 192).
    "hitsrf": dict(net=HITSRF,
                   runs=[(TILE_HIT, REQUESTS_HIT), (TILE, [(160, 160)])],
                   cpu_reference=1, calls={"fused_scc_block": 24}),
    # the classic path's weights and first request on the whole-block
    # route: each unshifted HAB is one launch instead of two
    "classic_hab_block": dict(
        net=dict(CLASSIC, hab_route="fused_hab_block"),
        runs=[(TILE, REQUESTS[:1])], cpu_reference=0, same_as="classic",
        calls={"fused_hab_block": 18, "fused_msa_block_shifted": 18,
               "mlp_block_sum3_shifted": 18, "fused_ocab_block": 6,
               "mlp_block": 6}),
    # the fork path's weights and first request with each HAB's front as
    # one hab_front launch in place of ln_split and the CAB's convs
    "fork_hab_front": dict(
        net=dict(FORK, front_route="hab_front"), runs=[(TILE, REQUESTS[:1])],
        cpu_reference=0, same_as="fork",
        calls={"hab_front": 36, "gated_dconv_ffn_block": 36,
               "fused_ocab_attention": 6, "mlp_block": 6}),
    "swinir": dict(net=SWINIR, runs=[(TILE, REQUESTS)], cpu_reference=1,
                   calls=dict(zip(_SWIN, (18, 18, 36)))),
    "swinir_light": dict(net=SWINIR_LIGHT, runs=[(TILE, REQUESTS[:1])],
                         cpu_reference=0,
                         calls=dict(zip(_SWIN, (12, 12, 24)))),
    "swinir_real_l": dict(net=SWINIR_REAL_L, runs=[(TILE, REQUESTS[:1])],
                          cpu_reference=0,
                          calls=dict(zip(_SWIN, (27, 27, 54)))),
}
_CSRC = "super_resolution_tpu_torch/csrc/"
_POPS = "super_resolution_tpu/ops/"
# kernel wrapper -> (module under ops/, CUDA source, TPU kernel it replaces)
KERNELS = {
    "fused_msa_block": ("cuda_attention", "msa_block.cu",
                        "pallas_attention.py:948"),
    "fused_msa_block_shifted": ("cuda_attention", "msa_block.cu",
                                "pallas_attention.py:1063"),
    "mlp_block_sum3": ("cuda_ffn", "mlp_tail.cu", "pallas_ffn.py:503"),
    "mlp_block_sum3_shifted": ("cuda_ffn", "mlp_tail.cu",
                               "pallas_ffn.py:571"),
    "fused_ocab_block": ("cuda_attention", "ocab_block.cu",
                         "pallas_attention.py:683"),
    "mlp_block": ("cuda_ffn", "mlp_tail.cu", "pallas_ffn.py:367"),
    "gated_dconv_ffn_block": ("cuda_ffn", "gated_dconv_ffn.cu",
                              "pallas_ffn.py:124"),
    "ln_split": ("cuda_hab", "ln_split.cu", "pallas_hab.py:315"),
    "fused_ocab_attention": ("cuda_attention", "ocab_attention.cu",
                             "pallas_attention.py:296"),
    "fused_attention": ("cuda_window_attention", "window_attention.cu",
                        "pallas_attention.py:105"),
    "fused_attention_v3": ("cuda_window_attention", "window_attention.cu",
                           "pallas_attention.py:186"),
    "msa_qtile_attention": ("cuda_window_attention",
                            "large_window_attention.cu",
                            "pallas_attention.py:1902"),
    "msa_flash_attention": ("cuda_window_attention",
                            "large_window_attention.cu",
                            "pallas_attention.py:2124"),
    "fused_msa_attention": ("cuda_window_attention", "msa_attention.cu",
                            "pallas_attention.py:444"),
    "fused_psa_block": ("cuda_psa", "psa_block.cu",
                        "pallas_attention.py:1282"),
    "fused_scc_block": ("cuda_scc", "scc_block.cu",
                        "pallas_attention.py:1539"),
    "fused_hab_block": ("cuda_hab_block", "hab_block.cu",
                        "pallas_attention.py:1707"),
    "hab_front": ("cuda_hab", "hab_front.cu", "pallas_hab.py:167"),
}
# the attention-only kernels at their paths' shapes: ESC's chunk of four
# 160 x 160 tiles at window 32 is (100, 4, 1024, 16) windows; ESC-XL's chunk
# of four 144 x 144 tiles at window 48 is a (4, 144, 144, 576) qkv image;
# and one rectangular case, the flagship OCAB's (Nq 256, Nk 576, d 30)
WINDOW_SHAPE = (100, 4, 1024, 1024, 16)
WINDOW_RECT_SHAPE = (100, 6, 256, 576, 30)
IMAGE_SHAPE = (4, 144, 144, 192, 12, 48)
# the two kernels on a whole image with a shift mask, (B, H, W, C, heads,
# ws): ATD's chunk of four 160 x 160 tiles (head dim 35) and ATD-light's
# (head dim 12); SRFormer's chunk of four 144 x 144 tiles (window 24 against
# its permuted 12) and SRFormer-light's. The first of each is the shape the
# kernels line reports, with the shift mask.
MSA_SHAPES = [(4, 160, 160, 210, 6, 16), (4, 160, 160, 48, 4, 16)]
PSA_SHAPES = [(4, 144, 144, 180, 6, 24), (4, 160, 160, 60, 6, 16)]
# HiT-SRF's SCC on the qv image of a chunk of four 192 x 192 tiles, (B, H, W,
# C, heads, base), at each window size of a group; and a rectangular window
# on a smaller base, checked beside them
SCC_SHAPE = (4, 192, 192, 60, 6, 8)
SCC_WINDOWS = [4, 8, 16, 32, 48, 64]
SCC_RECT = ((2, 48, 40, 20, 2), (8, 4), (4, 4))
# elementwise operations of the softmax per score: scale, bias, running
# maximum, subtraction, exponential, sum, division
SOFTMAX_OPS = 7
# the kernels whose library time is a composition of calls: no one PyTorch
# call computes their function
_MSA_COMPOSITION = (" (composition: two linears, windows cut, attention, "
                    "windows put back)")
_TAIL_COMPOSITION = " (composition: LayerNorm, linear, GELU, linear, add)"
COMPOSITIONS = {
    "fused_msa_block": _MSA_COMPOSITION,
    "fused_msa_block_shifted": _MSA_COMPOSITION.replace(": ", ": roll, "),
    "hab_front": " (composition: LayerNorm, two convs and GELU)",
    "fused_ocab_block": " (composition: LayerNorm, two linears, windows cut, "
                        "attention, linear, add)",
    "mlp_block": _TAIL_COMPOSITION,
    "mlp_block_sum3": _TAIL_COMPOSITION.replace(": ", ": two adds, "),
    "mlp_block_sum3_shifted": _TAIL_COMPOSITION.replace(": ",
                                                        ": roll, two adds, "),
    "gated_dconv_ffn_block": " (composition: LayerNorm, linear, depthwise "
                             "conv, gate, linear, add)",
    "gated_dconv_ffn": " (composition: linear, depthwise conv, gate, "
                       "linear)",
    "fused_hab_block": " (composition: fused_msa_block's, then "
                       "mlp_block_sum3's)",
    "fused_scc_block": " (composition: windows cut, einsum, baddbmm and bmm "
                       "per head, the Gram's two bmm, linear, windows put "
                       "back)",
}
# a second entry point of gated_dconv_ffn.cu, off the main paths: checked
# against its plain version, not listed among the kernels
EXTRA_ENTRY = {"gated_dconv_ffn": "cuda_ffn"}
# published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense rates): tensor cores bf16 and TF32, float32 outside them, HBM3
PEAK = dict(bf16=989e12, tf32=495e12, f32=67e12, hbm=3.35e12)
# exponentials a second on the special-function units of one H100 SXM: 16 a
# clock on each of its 132 SMs, at about 1.85 GHz. The attention kernels'
# floor beside the bound (which counts an exponential at the float32 rate)
EXP_RATE = 3.9e12
# exponentials a score of a kernel's design, where it computes each more
# than once: the exact softmax of msa_qtile_attention and of
# fused_psa_block's tensor-core kernel takes two passes
EXP_PASSES = {"msa_qtile_attention": 2, "fused_psa_block": 2}
# the scores of the kernels of check_kernels, (windows, heads, Nq, Nk), on
# (b, hw, hw, C) activations: the exp floor's arguments
SOFTMAX_SHAPES = {
    "fused_msa_block": lambda nwin: (nwin, HEADS, WS * WS, WS * WS),
    "fused_msa_block_shifted": lambda nwin: (nwin, HEADS, WS * WS, WS * WS),
    "fused_hab_block": lambda nwin: (nwin, HEADS, WS * WS, WS * WS),
    "fused_ocab_block": lambda nwin: (nwin, HEADS, WS * WS, OW * OW),
    "fused_ocab_attention": lambda nwin: (nwin, HEADS, WS * WS, OW * OW),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def wrappers() -> dict:
    import importlib

    mods = {name: mod for name, (mod, _, _) in KERNELS.items()}
    mods.update(EXTRA_ENTRY)
    return {name: getattr(importlib.import_module(
        f"super_resolution_tpu_torch.ops.{mod}"), name)
        for name, mod in mods.items()}


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(b: int, hw, dtype, seed: int):
    """Inputs of the wrappers at the flagship widths on (b, h, w) images, hw
    an int (square) or (h, w): name -> (args, kwargs, plain version, the one
    PyTorch call for the same function or None)."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops import cuda_ffn as cf
    from super_resolution_tpu_torch.ops import cuda_hab as ch
    from super_resolution_tpu_torch.ops import cuda_hab_block as chb
    from super_resolution_tpu_torch.ops.attention import (
        relative_position_index_oca, relative_position_index_sa,
        shift_attn_mask)
    from super_resolution_tpu_torch.ops.windowing import (
        extract_overlap_windows, window_partition, window_reverse)

    h, w_ = (hw, hw) if isinstance(hw, int) else hw
    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0, dt=dtype):
        a = rng.standard_normal(shape).astype(np.float32) * s
        return torch.from_numpy(a).to("cuda", dt)

    def w(fan_in, *shape):
        return t(fan_in, *shape, s=fan_in ** -0.5)

    n, nk = WS * WS, OW * OW
    x, a, cv = t(b, h, w_, C), t(b, h, w_, C), t(b, h, w_, C)
    lns, lnb = (1.0 + t(C, s=0.1)), t(C, s=0.1)
    tail = (lns, lnb, w(C, HID), t(HID, s=0.1), w(HID, C), t(C, s=0.1))
    rpi_sa = torch.from_numpy(relative_position_index_sa(WS)).long().cuda()
    table = t((2 * WS - 1) ** 2, HEADS, s=0.5, dt=torch.float32)
    bias_sa = table[rpi_sa.reshape(-1)].reshape(n, n, HEADS)
    bias_sa = bias_sa.permute(2, 0, 1).contiguous()
    rpi_oca = torch.from_numpy(relative_position_index_oca(WS, 0.5)).long()
    table2 = t((WS + OW - 1) ** 2, HEADS, s=0.5, dt=torch.float32)
    bias_oca = table2[rpi_oca.cuda().reshape(-1)].reshape(n, nk, HEADS)
    bias_oca = bias_oca.permute(2, 0, 1).contiguous()
    msa = (w(C, 3 * C), t(3 * C, s=0.1), w(C, C), t(C, s=0.1), bias_sa)
    mask = torch.from_numpy(shift_attn_mask(h, w_, WS, SS)).cuda()
    msa_kw = dict(heads=HEADS, window_size=WS)
    ocab = (lns, lnb, w(C, C), t(C, s=0.1), w(C, 2 * C), t(2 * C, s=0.1),
            w(C, C), t(C, s=0.1), bias_oca)
    # the gated FFN: fc1 (C, 2M) with M = HID, depthwise taps of a 3 x 3 mean
    ffn = (w(C, 2 * HID), t(2 * HID, s=0.5), t(3, 3, 2 * HID, s=1 / 3),
           t(2 * HID, s=0.1), w(HID, C), t(C, s=0.1))
    q_img, kv_img = t(b, h, w_, C), t(b, h, w_, 2 * C)
    oca_kw = dict(msa_kw, overlap_win=OW)
    # the CAB's two 3 x 3 convs (HWIO) of the fork's HAB front
    front = (lns, lnb, t(3, 3, C, FRONT_MID, s=(9 * C) ** -0.5),
             t(FRONT_MID, s=0.1),
             t(3, 3, FRONT_MID, C, s=(9 * FRONT_MID) ** -0.5), t(C, s=0.1))

    def heads_of(q, kv):
        """q windows and overlap windows of k and v, split by head."""
        d = C // HEADS
        qw = window_partition(q, WS).reshape(-1, n, HEADS, d)
        kvw = extract_overlap_windows(kv, WS, OW)
        kw_ = kvw[..., :C].reshape(-1, nk, HEADS, d)
        vw = kvw[..., C:].reshape(-1, nk, HEADS, d)
        return (v.transpose(1, 2).contiguous() for v in (qw, kw_, vw))

    def sdpa():
        """The library's attention on windows cut beforehand: it has no
        windowing of its own."""
        qh, kh, vh = heads_of(q_img, kv_img)
        m = bias_oca.to(dtype)[None]
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=m)

    def ocab_library():
        """The library's composition of ``fused_ocab_block`` (no one call
        computes it): ``F.layer_norm``, the q and kv ``F.linear``, the
        windows and overlap windows cut, ``F.scaled_dot_product_attention``
        with the RPB, the output ``F.linear`` and the residual add."""
        lns_, lnb_, wq, bq, wkv, bkv, wp, bp, rpb = ocab
        wq_t, wkv_t, wp_t = (t_.t().contiguous() for t_ in (wq, wkv, wp))
        m = rpb.to(dtype)[None]

        def run():
            xn = F.layer_norm(x, (C,), lns_, lnb_, 1e-5)
            qh, kh, vh = heads_of(F.linear(xn, wq_t, bq),
                                  F.linear(xn, wkv_t, bkv))
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m)
            o = window_reverse(o.transpose(1, 2).reshape(-1, WS, WS, C), WS,
                               h, w_)
            return F.linear(o, wp_t, bp) + x
        return run

    return {
        "fused_msa_block": ((x, *msa, None), msa_kw,
                            lambda: ca.msa_block_reference(
                                x, *msa, None, HEADS, WS),
                            lambda: msa_block_library(x, *msa, None, HEADS,
                                                      WS, 0)),
        "fused_msa_block_shifted": (
            (x, *msa, mask), dict(msa_kw, shift=SS),
            lambda: ca.msa_block_shifted_reference(x, *msa, mask, HEADS, WS,
                                                   SS),
            lambda: msa_block_library(x, *msa, mask, HEADS, WS, SS)),
        "mlp_block_sum3": ((x, a, cv, *tail), dict(conv_scale=0.01),
                           lambda: cf.mlp_block_sum3_reference(
                               x, a, cv, *tail, 0.01),
                           lambda: mlp_tail_library(x, a, cv, tail, 0.01)),
        "mlp_block_sum3_shifted": (
            (x, a, cv, *tail), dict(conv_scale=0.01, shift=SS),
            lambda: cf.mlp_block_sum3_shifted_reference(x, a, cv, *tail,
                                                        0.01, SS),
            lambda: mlp_tail_library(x, a, cv, tail, 0.01, SS)),
        "fused_hab_block": ((a, x, cv, *msa, *tail),
                            dict(msa_kw, conv_scale=0.01),
                            lambda: chb.hab_block_reference(
                                a, x, cv, *msa, *tail, HEADS, WS,
                                conv_scale=0.01),
                            lambda: hab_block_library(a, x, cv, msa, tail)),
        "fused_ocab_block": ((x, *ocab), oca_kw,
                             lambda: ca.ocab_block_reference(
                                 x, *ocab, HEADS, WS, OW), ocab_library),
        "mlp_block": ((x, *tail), {},
                      lambda: cf.mlp_block_reference(x, *tail),
                      lambda: mlp_tail_library(x, None, None, tail)),
        "gated_dconv_ffn_block": (
            (x, lns, lnb, *ffn), {},
            lambda: cf.ffn_block_reference(x, lns, lnb, *ffn),
            lambda: gated_ffn_library(x, lns, lnb, ffn)),
        "gated_dconv_ffn": ((x, *ffn), {},
                            lambda: cf.ffn_reference(x, *ffn),
                            lambda: gated_ffn_library(x, None, None, ffn)),
        "ln_split": ((x, lns, lnb), dict(pdim=PDIM),
                     lambda: ch.ln_split_reference(x, lns, lnb, 1e-5, PDIM),
                     lambda: (lambda: F.layer_norm(x, (C,), lns, lnb, 1e-5))),
        "hab_front": ((x, *front), dict(pdim=PDIM),
                      lambda: ch.hab_front_reference(x, *front, 1e-5, PDIM),
                      lambda: front_library(x, *front)),
        "fused_ocab_attention": (
            (q_img, kv_img, bias_oca), oca_kw,
            lambda: ca.ocab_attention_reference(q_img, kv_img, bias_oca,
                                                HEADS, WS, OW), sdpa),
    }


def msa_block_library(x, w_qkv, b_qkv, w_proj, b_proj, bias, mask,
                      heads: int, ws: int, shift: int):
    """The library's composition of ``fused_msa_block(_shifted)`` (no one
    PyTorch call computes it): ``torch.roll`` where shifted, the qkv
    ``F.linear``, the windows cut, ``F.scaled_dot_product_attention`` with
    the RPB (+ the window's mask), the windows put back, the output
    ``F.linear``."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops.windowing import (window_partition,
                                                          window_reverse)

    b, h, w, _ = x.shape
    c_loc = w_qkv.shape[1] // 3
    n, nw = ws * ws, (h // ws) * (w // ws)
    wq_t, wp_t = w_qkv.t().contiguous(), w_proj.t().contiguous()
    # (1 or nW, heads, N, N), broadcast over the images
    m = (bias[None] if mask is None
         else bias[None] + mask[:, None]).to(x.dtype)

    def run():
        xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
        win = window_partition(F.linear(xr, wq_t, b_qkv), ws).reshape(
            b, nw, n, 3, heads, c_loc // heads)
        q, k, v = (win[:, :, :, i].transpose(2, 3).contiguous()
                   for i in range(3))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=m)
        o = window_reverse(o.transpose(2, 3).reshape(-1, ws, ws, c_loc), ws,
                           h, w)
        return F.linear(o, wp_t, b_proj)
    return run


def front_library(x, gamma, beta, w1, b1, w2, b2):
    """The library's composition of ``hab_front``'s first two outputs:
    ``F.layer_norm``, two cuDNN convs on channels-last views with
    channels-last filters, ``F.gelu`` (no single PyTorch call computes the
    function; the sums are left out)."""
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last
    k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)

    def run():
        y = F.layer_norm(x, (x.shape[-1],), gamma, beta, 1e-5)
        t1 = F.gelu(F.conv2d(y.permute(0, 3, 1, 2), k1, b1, padding=1))
        return F.conv2d(t1, k2, b2, padding=1)
    return run


def mlp_tail_library(x, a, cv, tail, cs: float = 0.0, shift: int = 0,
                     rs: float = 1.0):
    """The library's composition of ``mlp_block`` (a None) and its sum3
    forms (no one PyTorch call computes them): ``torch.roll`` where
    shifted, the 3-way sum, ``F.layer_norm``, the fc1 ``F.linear``,
    ``F.gelu``, the fc2 ``F.linear`` and the residual add. ``a`` may be a
    call that makes the attention input."""
    import torch
    import torch.nn.functional as F

    gamma, beta, w1, b1, w2, b2 = tail
    w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()

    def run():
        s = x
        if a is not None:
            ar = a() if callable(a) else a
            ar = torch.roll(ar, (shift, shift), (1, 2)) if shift else ar
            s = x + ar + cv * cs
        y = F.layer_norm(s, (s.shape[-1],), gamma, beta, 1e-5)
        out = F.linear(F.gelu(F.linear(y, w1_t, b1)), w2_t, b2)
        return out + (s if rs == 1.0 else s * rs)
    return run


def hab_block_library(lnx, x, cv, msa, tail):
    """The library's composition of ``fused_hab_block`` (no one PyTorch
    call computes it): :func:`msa_block_library` unmasked and unshifted,
    then :func:`mlp_tail_library` of its output in the 3-way sum."""
    attn = msa_block_library(lnx, *msa, None, HEADS, WS, 0)
    return mlp_tail_library(x, attn, cv, tail, 0.01)


def gated_ffn_library(x, gamma, beta, ffn):
    """The library's composition of ``gated_dconv_ffn_block`` (gamma
    None: ``gated_dconv_ffn``; no one PyTorch call computes either):
    ``F.layer_norm``, the fc1 ``F.linear``, the depthwise 3 x 3
    ``F.conv2d`` (groups 2M) on the channels-last view, the gate
    d[:M] * silu(d[M:]), the fc2 ``F.linear`` and the residual add."""
    import torch.nn.functional as F

    w1, b1, wd, bd, w2, b2 = ffn
    m2 = w1.shape[1]
    w1_t, w2_t = w1.t().contiguous(), w2.t().contiguous()
    kd = wd.permute(2, 0, 1)[:, None].contiguous()

    def run():
        y = x if gamma is None else F.layer_norm(x, (x.shape[-1],), gamma,
                                                 beta, 1e-5)
        h = F.linear(y, w1_t, b1).permute(0, 3, 1, 2)
        d = F.conv2d(h, kd, bd, padding=1, groups=m2).permute(0, 2, 3, 1)
        out = F.linear(d[..., :m2 // 2] * F.silu(d[..., m2 // 2:]), w2_t,
                       b2)
        return out if gamma is None else out + x
    return run


def front_sums_rel_err(got, ref) -> float:
    """Largest error of ``hab_front``'s two sums (gap_cab, gap16) over the
    sum of the magnitudes each adds up."""
    mass = (ref[1].float().abs().sum(dim=(1, 2)),
            ref[0][..., :ref[3].shape[1]].float().abs().sum(dim=(1, 2)))
    return max(((g - r).abs() / m.clamp_min(1.0)).max().item()
               for g, r, m in zip(got[2:], ref[2:], mass))


def kernel_bound(name: str, b: int, hw: int, esize: int, shifted_mask: int):
    """(bound_ms, bound_by) of one call on (b, hw, hw, C) activations of
    esize bytes: the larger of the bytes the function must move (each input
    read once, each output written once) over the HBM rate and its
    operations over the card's peak for their type (matrix products at the
    tensor cores' bf16 rate, the rest at the float32 rate)."""
    tok = b * hw * hw
    nwin = tok // (WS * WS)
    n, nk, d = WS * WS, OW * OW, C // HEADS
    act = tok * C * esize
    mm = vec = 0.0
    if name.startswith("fused_msa_block"):
        return msa_block_bound(b, hw, WS, esize, shifted_mask
                               if name.endswith("shifted") else 0)
    if name == "fused_hab_block":
        # fused_msa_block and mlp_block_sum3 together, less one write and
        # one read of the attention image
        mm = (2 * tok * C * 3 * C + 2 * tok * C * C
              + 4 * nwin * HEADS * n * n * d + 4 * tok * C * HID)
        byts = (4 * act + (4 * C * C + 4 * C) * esize + HEADS * n * n * 4
                + (2 * C * HID + HID + 3 * C) * esize)
    elif name == "fused_ocab_block":
        # the q, kv and output projections once a pixel, the attention
        mm = 2 * tok * C * 4 * C + 4 * nwin * HEADS * n * nk * d
        byts = 2 * act + (4 * C * C + 6 * C) * esize + HEADS * n * nk * 4
    elif name.startswith("mlp_block"):
        return mlp_tail_bound(name, tok, C, HID, esize)
    elif name == "gated_dconv_ffn_block":
        return gated_ffn_bound(tok, C, HID, C, esize, True)
    elif name == "ln_split":
        vec = 8 * tok * C
        byts = 2 * act + tok * PDIM * esize + 2 * C * esize
    elif name == "hab_front":
        return front_bound(b, tok, C, FRONT_MID, esize)
    elif name == "fused_ocab_attention":
        mm = 4 * nwin * HEADS * n * nk * d
        byts = 4 * act + HEADS * n * nk * 4
    else:
        raise KeyError(name)
    t_ops = max(mm / PEAK["bf16"], vec / PEAK["f32"])
    t_bytes = byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def front_bound(b: int, tok: int, c: int, mid: int, esize: int):
    """(bound_ms, bound_by) of one ``hab_front`` call on b images of tok
    pixels in all: the two 3 x 3 convs as matrix products; LayerNorm, GELU
    and the two sums elementwise; x in, ln1 and cab_mid out, the weights
    and the float32 sums once."""
    mm = 2 * 2 * tok * 9 * c * mid
    vec = 8 * tok * c + 8 * tok * mid + tok * (c + PDIM)
    byts = (3 * tok * c * esize + (18 * c * mid + 3 * c + mid) * esize
            + 4 * b * (c + PDIM))
    t_ops = max(mm / PEAK["bf16"], vec / PEAK["f32"])
    t_bytes = byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def gated_ffn_bound(tok: int, c: int, m: int, c_out: int, esize: int,
                    block: bool):
    """(bound_ms, bound_by) of one gated FFN call on tok pixels, C c, M m,
    C_out c_out: x read and out written once with the weights (the
    block's LayerNorm parameters too), over the HBM rate, against fc1 and
    fc2 at the tensor cores' bf16 rate and the depthwise 3 x 3 at the
    float32 rate."""
    mm = 2 * tok * c * 2 * m + 2 * tok * m * c_out
    vec = 2 * 9 * tok * 2 * m
    byts = (tok * (c + c_out) + 2 * c * m + m * c_out + 22 * m + c_out
            + (2 * c if block else 0)) * esize
    t_ops = max(mm / PEAK["bf16"], vec / PEAK["f32"])
    t_bytes = byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def mlp_tail_bound(name: str, tok: int, c: int, hid: int, esize: int):
    """(bound_ms, bound_by) of one ``mlp_block(_sum3(_shifted))`` call on
    tok pixels of width c at hidden width hid: its inputs (one image, three
    for the sum3 forms) read and out written once with the weights, over
    the HBM rate, against the two products at the tensor cores' bf16
    rate."""
    inputs = 3 if "sum3" in name else 1
    byts = ((inputs + 1) * tok * c + 2 * c * hid + hid + 3 * c) * esize
    t_ops, t_bytes = 4 * tok * c * hid / PEAK["bf16"], byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def msa_block_bound(b: int, hw: int, ws: int, esize: int,
                    mask_windows: int, c: int = C, heads: int = HEADS):
    """(bound_ms, bound_by) of one ``fused_msa_block(_shifted)`` call on
    (b, hw, hw, c) activations at window ws: x read and out written once,
    the weights, the float32 RPB and ``mask_windows`` windows of float32
    mask read once, over the HBM rate, against the two projections and the
    attention's two products at the tensor cores' bf16 rate."""
    tok = b * hw * hw
    n = ws * ws
    mm = (2 * tok * c * 3 * c + 2 * tok * c * c
          + 4 * (tok // n) * heads * n * n * (c // heads))
    byts = (2 * tok * c * esize + (4 * c * c + 4 * c) * esize
            + (heads + mask_windows) * n * n * 4)
    t_ops, t_bytes = mm / PEAK["bf16"], byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_msa_block_kernels() -> None:
    """Phase 3 for rows 1 and 2 beyond ``check_kernels`` (which checks and
    times the unshifted block without a mask and the shifted one at the
    flagship chunk, window 16), in bf16 on a chunk of four 160 x 160 tiles,
    each case against its plain version within TOL_BF16: at the flagship
    width an explicit (1, N, N) zero mask (timed) and a head group's slice
    (c_loc = C / 2), shifted; at SwinIR's window 8 and the widths of
    swinir (C 180, 6 heads), swinir_light (C 60, 6 heads of 10) and
    swinir_real_l (C 240, 8 heads: the projections' K above their 192-row
    slab) the unshifted block without a mask and the shifted one (both
    timed beside plain, bound, exp floor and the library's composition)
    and the head slice, shifted."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops.attention import shift_attn_mask

    b, hw, dtype = 4, 160, torch.bfloat16
    # (label, mask: None, "zeros" or "shift", the head slice, timed)
    window8 = (("no mask", None, False, True), ("shifted", "shift", False,
                                                 True),
               ("head slice, shifted", "shift", True, False))
    for c, heads, ws, cases in (
            (C, HEADS, WS, (("zero mask", "zeros", False, True),
                            ("head slice, shifted", "shift", True, False))),
            *((net["embed_dim"], net["num_heads"][0], net["window_size"],
               window8) for net in (SWINIR, SWINIR_LIGHT, SWINIR_REAL_L))):
        n, ss, nwin = ws * ws, ws // 2, (hw // ws) ** 2
        t = _device_randn(dtype, ws + c)
        x = t(b, hw, hw, c)
        full = (t(c, 3 * c, s=c ** -0.5), t(3 * c, s=0.1),
                t(c, c, s=c ** -0.5), t(c, s=0.1),
                t(heads, n, n, s=0.5, dt=torch.float32))
        # the first half of the heads: their q, k and v columns, their rows
        # of the output projection
        cols = torch.cat([torch.arange(i * c, i * c + c // 2)
                          for i in range(3)]).cuda()
        half = (full[0][:, cols].contiguous(), full[1][cols].contiguous(),
                full[2][:c // 2].contiguous(), full[3],
                full[4][:heads // 2].contiguous())
        masks = {None: None, "zeros": torch.zeros((1, n, n), device="cuda"),
                 "shift": torch.from_numpy(
                     shift_attn_mask(hw, hw, ws, ss)).cuda()}
        for label, mask_kind, sliced, timed in cases:
            msa, mask = (half if sliced else full), masks[mask_kind]
            sh = ss if mask_kind == "shift" else 0
            hd = msa[4].shape[0]
            fn = ca.fused_msa_block_shifted if sh else ca.fused_msa_block
            kw = dict(heads=hd, window_size=ws, **(
                dict(shift=sh) if sh else {}))

            def plain(msa=msa, mask=mask, sh=sh, hd=hd):
                return ca.msa_block_shifted_reference(
                    x, *msa, mask, hd, ws, sh) if sh else (
                    ca.msa_block_reference(x, *msa, mask, hd, ws))
            got = fn(x, *msa, mask, **kw)
            torch.cuda.synchronize()
            err, ok = max_err_and_tol(got, plain(), TOL_BF16)
            del got
            line = (f"  {fn.__name__:24s} C {c} window {ws} {label:20s} "
                    f"{tuple(x.shape)} bf16 max|kernel-plain| {err:.3e} "
                    f"(rel tol {TOL_BF16:.1e})")
            if timed:
                ms = time_ms(lambda: fn(x, *msa, mask, **kw))
                plain_ms = time_ms(plain, reps=5, warmup=1)
                lib_ms = time_ms(msa_block_library(x, *msa, mask, hd, ws,
                                                   sh))
                bound_ms, by = msa_block_bound(
                    b, hw, ws, 2, 0 if mask is None else mask.shape[0], c,
                    heads)
                floor = exp_floor_ms(b * nwin, heads, n, n)
                line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                         f"bound {bound_ms:.4f} ms ({by})  exp floor "
                         f"{floor:.4f} ms  library {lib_ms:.3f} ms"
                         + COMPOSITIONS[fn.__name__])
            log(line)
            if not ok:
                raise AssertionError(f"{fn.__name__} ({label}, C {c}, window "
                                     f"{ws}) disagrees with its plain "
                                     f"version: {err}")
        del x, full, half, masks
        torch.cuda.empty_cache()


def check_mlp_tail_kernels() -> None:
    """Phase 3 for rows 3, 4 and 6 beyond ``check_kernels`` (which checks
    and times them at the flagship width, C 180, hidden 360), in bf16 on a
    chunk of four 160 x 160 tiles, each within TOL_BF16 of its plain
    version: at the widths of swinir_light (C 60, hidden 120),
    swinir_real_l (C 240, hidden 480) and the zoo's SwinIR with MLP ratio
    4 (C 180, hidden 720), all three timed beside plain, bound and the
    library's composition; and at a tensor-parallel worker's hidden slice
    (C 180, hidden 90, a quarter of the residual), untimed."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_ffn as cf

    b, hw, dtype = 4, 160, torch.bfloat16
    for c, hid, rs, timed in ((60, 120, 1.0, True), (240, 480, 1.0, True),
                              (180, 720, 1.0, True), (180, 90, 0.25, False)):
        t = _device_randn(dtype, c + hid)
        x, a, cv = t(b, hw, hw, c), t(b, hw, hw, c), t(b, hw, hw, c)
        tail = (1.0 + t(c, s=0.1), t(c, s=0.1), t(c, hid, s=c ** -0.5),
                t(hid, s=0.1), t(hid, c, s=hid ** -0.5), t(c, s=0.1))
        kw = dict(residual_scale=rs)
        cases = (
            (cf.mlp_block, (x, *tail), kw,
             lambda: cf.mlp_block_reference(x, *tail, residual_scale=rs),
             (None, None, 0.0, 0)),
            (cf.mlp_block_sum3, (x, a, cv, *tail), dict(kw, conv_scale=0.01),
             lambda: cf.mlp_block_sum3_reference(x, a, cv, *tail, 0.01,
                                                 residual_scale=rs),
             (a, cv, 0.01, 0)),
            (cf.mlp_block_sum3_shifted, (x, a, cv, *tail),
             dict(kw, conv_scale=0.01, shift=4),
             lambda: cf.mlp_block_sum3_shifted_reference(
                 x, a, cv, *tail, 0.01, 4, residual_scale=rs),
             (a, cv, 0.01, 4)))
        for fn, args, fkw, plain, lib_args in cases:
            got = fn(*args, **fkw)
            torch.cuda.synchronize()
            err, ok = max_err_and_tol(got, plain(), TOL_BF16)
            del got
            line = (f"  {fn.__name__:24s} C {c} hidden {hid} rs {rs} "
                    f"{tuple(x.shape)} bf16 max|kernel-plain| {err:.3e} "
                    f"(rel tol {TOL_BF16:.1e})")
            if timed:
                ms = time_ms(lambda: fn(*args, **fkw))
                plain_ms = time_ms(plain, reps=5, warmup=1)
                lib_ms = time_ms(mlp_tail_library(x, *lib_args[:2], tail,
                                                  *lib_args[2:], rs=rs))
                bound_ms, by = mlp_tail_bound(fn.__name__, b * hw * hw, c,
                                              hid, 2)
                line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                         f"bound {bound_ms:.4f} ms ({by})  library "
                         f"{lib_ms:.3f} ms" + COMPOSITIONS[fn.__name__])
            log(line)
            if not ok:
                raise AssertionError(f"{fn.__name__} (C {c}, hidden {hid}) "
                                     f"disagrees with its plain version: "
                                     f"{err}")
        del x, a, cv, tail, cases
        torch.cuda.empty_cache()


def check_gated_ffn_kernels() -> None:
    """Phase 3 for row 7 beyond ``check_kernels`` (which checks and times
    ``gated_dconv_ffn_block`` at the fork's width, C 180, M 360, and checks
    the bare entry there), in bf16 on a chunk of four 160 x 160 tiles, each
    within TOL_BF16 of its plain version and timed beside plain, bound and
    the library's composition: ``gated_dconv_ffn_block`` at HAT-S's width
    (C 144, M 288) and the bare ``gated_dconv_ffn`` at the fork's width
    with C_out 36."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_ffn as cf

    b, hw, dtype = 4, 160, torch.bfloat16
    for c, m, c_out, block in ((144, 288, 144, True), (C, HID, 36, False)):
        t = _device_randn(dtype, c + m + c_out)
        x = t(b, hw, hw, c)
        ffn = (t(c, 2 * m, s=c ** -0.5), t(2 * m, s=0.5),
               t(3, 3, 2 * m, s=1 / 3), t(2 * m, s=0.1),
               t(m, c_out, s=m ** -0.5), t(c_out, s=0.1))
        if block:
            norm = (1.0 + t(c, s=0.1), t(c, s=0.1))
            fn, ref, args = (cf.gated_dconv_ffn_block, cf.ffn_block_reference,
                             (x, *norm, *ffn))
            library = gated_ffn_library(x, *norm, ffn)
        else:
            fn, ref, args = cf.gated_dconv_ffn, cf.ffn_reference, (x, *ffn)
            library = gated_ffn_library(x, None, None, ffn)

        def plain(ref=ref, args=args):
            return ref(*args)
        got = fn(*args)
        torch.cuda.synchronize()
        err, ok = max_err_and_tol(got, plain(), TOL_BF16)
        del got
        ms = time_ms(lambda: fn(*args))
        plain_ms = time_ms(plain, reps=5, warmup=1)
        lib_ms = time_ms(library)
        bound_ms, by = gated_ffn_bound(b * hw * hw, c, m, c_out, 2, block)
        log(f"  {fn.__name__:24s} C {c} M {m} C_out {c_out} "
            f"{tuple(x.shape)} bf16 max|kernel-plain| {err:.3e} (rel tol "
            f"{TOL_BF16:.1e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
            f"bound {bound_ms:.4f} ms ({by})  library {lib_ms:.3f} ms"
            + COMPOSITIONS[fn.__name__])
        if not ok:
            raise AssertionError(f"{fn.__name__} (C {c}, M {m}, C_out "
                                 f"{c_out}) disagrees with its plain "
                                 f"version: {err}")
        del x, ffn, args, library
        torch.cuda.empty_cache()


def check_front_kernels() -> None:
    """Phase 3 for row 18 beyond ``check_kernels`` (which checks and times
    ``hab_front`` at the fork's width, C / MID 180 / 60, on the flagship
    chunk), in bf16: HAT-S's width (C / MID 144 / 6) on a chunk of four
    160 x 160 tiles, timed beside plain, bound and the library's
    composition, and the fork's width on a ragged 2 x 13 x 19 image. ln1
    and cab_mid within TOL_BF16 of the plain version, the two sums within
    TOL_BF16 of the magnitudes they add up."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_hab as ch

    dtype = torch.bfloat16
    for b, h, w, c, mid, timed in ((4, 160, 160, 144, 6, True),
                                   (2, 13, 19, C, FRONT_MID, False)):
        t = _device_randn(dtype, c + mid + h)
        x = t(b, h, w, c)
        front = (1.0 + t(c, s=0.1), t(c, s=0.1),
                 t(3, 3, c, mid, s=(9 * c) ** -0.5), t(mid, s=0.1),
                 t(3, 3, mid, c, s=(9 * mid) ** -0.5), t(c, s=0.1))

        def plain(x=x, front=front):
            return ch.hab_front_reference(x, *front, 1e-5, PDIM)
        got = ch.hab_front(x, *front, pdim=PDIM)
        torch.cuda.synchronize()
        ref = plain()
        err, ok = max_err_and_tol(got[:2], ref[:2], TOL_BF16)
        rel = front_sums_rel_err(got, ref)
        ok = ok and rel <= TOL_BF16
        del got, ref
        line = (f"  hab_front C {c} MID {mid} {tuple(x.shape)} bf16 "
                f"max|kernel-plain| {err:.3e} (rel tol {TOL_BF16:.1e}); sums "
                f"rel err {rel:.2e}")
        if timed:
            ms = time_ms(lambda: ch.hab_front(x, *front, pdim=PDIM))
            plain_ms = time_ms(plain, reps=5, warmup=1)
            lib_ms = time_ms(front_library(x, *front))
            bound_ms, by = front_bound(b, b * h * w, c, mid, 2)
            line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound "
                     f"{bound_ms:.4f} ms ({by})  library {lib_ms:.3f} ms"
                     + COMPOSITIONS["hab_front"])
        log(line)
        if not ok:
            raise AssertionError(f"hab_front (C {c}, MID {mid}, "
                                 f"{tuple(x.shape)}) disagrees with its "
                                 f"plain version: {err}, sums {rel}")
        del x, front
        torch.cuda.empty_cache()


def max_err_and_tol(got, ref, tol_rel: float):
    """Largest |kernel - plain| over the outputs, and whether each output
    lies within tol_rel * max(1, max|plain|)."""
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    worst, ok = 0.0, len(got) == len(ref)
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"{g.shape} {g.dtype} vs plain {r.shape} "
                                 f"{r.dtype}")
        err = (g.float() - r.float()).abs().max().item()
        ok = ok and err <= tol_rel * max(1.0, r.float().abs().max().item())
        worst = max(worst, err)
    return worst, ok


def check_kernels() -> dict:
    """Phase 3. Returns name -> {max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms} at the main paths' shape (a chunk of 4 tiles of
    160 x 160, bf16)."""
    import torch

    fns = wrappers()
    results = {}
    for b, hw, dtype, timed in ((2, 64, torch.float32, False),
                                (2, 160, torch.float32, False),
                                (2, 64, torch.bfloat16, False),
                                (4, 160, torch.bfloat16, True)):
        tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
        cases = kernel_cases(b, hw, dtype, seed=hw + b)
        for name, (args, kw, plain, library) in cases.items():
            got = fns[name](*args, **kw)
            torch.cuda.synchronize()
            ref = plain()
            sums = ""
            if name == "hab_front":
                # ln1 and cab_mid by the rule of every kernel, the two sums
                # by their error relative to the magnitudes they add
                err, ok = max_err_and_tol(got[:2], ref[:2], tol_rel)
                rel = front_sums_rel_err(got, ref)
                ok = ok and rel <= tol_rel
                sums = f"; sums rel err {rel:.2e}"
            else:
                err, ok = max_err_and_tol(got, ref, tol_rel)
            if name == "ln_split":
                # x1 is ln1's first pdim channels, bit for bit
                ok = ok and torch.equal(got[1], got[0][..., :PDIM])
            line = (f"  {name:24s} B{b} {hw}x{hw} {str(dtype)[6:]:8s} "
                    f"max|kernel-plain| {err:.3e} (rel tol {tol_rel:.1e})"
                    + sums)
            del got, ref
            if timed and name in KERNELS:
                ms = time_ms(lambda: fns[name](*args, **kw))
                plain_ms = time_ms(plain)
                lib_ms = time_ms(library()) if library else None
                bound_ms, by = kernel_bound(
                    name, b, hw, 2, (hw // WS) ** 2)
                results[name] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=by, library_ms=lib_ms)
                line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                         f"bound {bound_ms:.4f} ms ({by})")
                if name in SOFTMAX_SHAPES:
                    floor = exp_floor_ms(*SOFTMAX_SHAPES[name](
                        b * hw * hw // (WS * WS)))
                    line += f"  exp floor {floor:.4f} ms"
                if lib_ms is not None:
                    line += f"  library {lib_ms:.3f} ms"
                    line += COMPOSITIONS.get(name, "")
            log(line)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {err}")
        del cases
        torch.cuda.empty_cache()
    return results


def check_ln_split() -> dict:
    """Row 8 at the fork's chunk shape in bf16, timed two ways
    (``tools/ln_split_timing.py``): on one input again and again and on two
    inputs in turn (reads from HBM), each through the wrapper (one call)
    and through the C entry (20 launches: the kernel alone), beside
    ``F.layer_norm`` and the bound. Returns the keys it adds to row 8's
    entry of the kernels line."""
    from super_resolution_tpu_torch.tools.ln_split_timing import timing

    t = timing()
    if (t["max_abs_err"] > TOL_BF16 * max(1.0, t["max_abs_plain"])
            or not t["x1_bit_equal"]):
        raise AssertionError(f"ln_split disagrees with its plain version: "
                             f"{t}")
    log(f"  ln_split {tuple(t['shape'])} bf16, one input / two in turn: "
        f"wrapper {t['wrapper_ms']:.4f} / {t['wrapper_two_buffers_ms']:.4f} "
        f"ms, kernel alone {t['entry_ms']:.4f} / "
        f"{t['entry_two_buffers_ms']:.4f} ms, F.layer_norm "
        f"{t['layer_norm_ms']:.4f} / {t['layer_norm_two_buffers_ms']:.4f} ms "
        f"(20 in a row {t['layer_norm_loop_ms']:.4f} / "
        f"{t['layer_norm_loop_two_buffers_ms']:.4f}); bound "
        f"{t['bound_ms']:.4f} ms (bytes); float32 first version "
        f"{t['float32_wrapper_ms']:.4f} ms")
    return dict(ms_two_buffers=t["wrapper_two_buffers_ms"],
                kernel_alone_ms=t["entry_ms"],
                kernel_alone_two_buffers_ms=t["entry_two_buffers_ms"],
                library_two_buffers_ms=t["layer_norm_two_buffers_ms"])


def attention_cases(dtype, seed: int, window_shape, image_shape=None):
    """Inputs of the attention-only wrappers: name -> (args, kwargs, plain
    version, the library's attention on the same windows). The two on cut
    windows get ``window_shape``; the two on a qkv image ``image_shape``,
    if given."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops import cuda_window_attention as cw
    from super_resolution_tpu_torch.ops.attention import attention_with_bias
    from super_resolution_tpu_torch.ops.windowing import window_partition

    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0, dt=dtype):
        a = rng.standard_normal(shape, dtype=np.float32) * s
        return torch.from_numpy(a).to("cuda", dt)

    bw, heads, nq, nk, d = window_shape
    q, k, v = t(bw, heads, nq, d), t(bw, heads, nk, d), t(bw, heads, nk, d)
    bias = t(heads, nq, nk, s=0.5, dt=torch.float32)
    mask = bias.to(dtype)[None]
    cases = {}
    for name in ("fused_attention", "fused_attention_v3"):
        cases[name] = (
            (q, k, v, bias), {},
            lambda: attention_with_bias(q, k, v, bias),
            lambda: (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)))
    if image_shape is None:
        return cases

    b, h, w, c, iheads, ws = image_shape
    n, idim = ws * ws, c // iheads
    qkv = t(b, h, w, 3 * c)
    ibias = t(iheads, n, n, s=0.5, dt=torch.float32)
    kw = dict(heads=iheads, window_size=ws)

    def sdpa():
        """The library's attention on windows cut beforehand: it has no
        windowing of its own."""
        win = window_partition(qkv, ws).reshape(-1, n, 3, iheads, idim)
        qh, kh, vh = (win[:, :, i].transpose(1, 2).contiguous()
                      for i in range(3))
        m = ibias.to(dtype)[None]
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=m)

    for name in ("msa_qtile_attention", "msa_flash_attention"):
        cases[name] = ((qkv, ibias), kw,
                       lambda: cw.msa_qtile_reference(qkv, ibias, iheads, ws),
                       sdpa)
    return cases


def attention_bound(bw: int, heads: int, nq: int, nk: int, d: int,
                    esize: int, mask_windows: int = 0, proj_dim: int = 0):
    """(bound_ms, bound_by) of attention with a dense float32 bias over bw
    windows: q, k, v, out and the bias each moved once over the HBM rate,
    against the two products at the tensor cores' bf16 rate and the
    softmax's elementwise work at the float32 rate. ``mask_windows``: the
    windows of a float32 shift mask, read once. ``proj_dim``: the q and
    output projections of ``fused_psa_block`` as matrix operations, their
    two (C, C) weights and biases as bytes (x takes q's place)."""
    mm = 4 * bw * heads * nq * nk * d + 4 * bw * nq * proj_dim * proj_dim
    vec = SOFTMAX_OPS * bw * heads * nq * nk
    byts = (bw * heads * (2 * nq + 2 * nk) * d * esize
            + (heads + mask_windows) * nq * nk * 4
            + 2 * (proj_dim + 1) * proj_dim * esize)
    t_ops = max(mm / PEAK["bf16"], vec / PEAK["f32"])
    t_bytes = byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def exp_floor_ms(bw: int, heads: int, nq: int, nk: int, *_) -> float:
    """Least time for the bw * heads * nq * nk exponentials of the softmax
    on the special-function units; stated beside the bound, not in it."""
    return bw * heads * nq * nk / EXP_RATE * 1e3


def check_attention_kernels() -> dict:
    """Phase 3 for the attention-only kernels. Returns name -> timing at
    the ESC / ESC-XL chunk shapes in bf16; the rectangular case of
    fused_attention and fused_attention_v3 is checked and timed beside."""
    import torch

    fns = wrappers()
    b, h, w, c, iheads, ws = IMAGE_SHAPE
    bounds = {name: attention_bound(*WINDOW_SHAPE, 2)
              for name in ("fused_attention", "fused_attention_v3")}
    image_shape = (b * (h // ws) * (w // ws), iheads, ws * ws, ws * ws,
                   c // iheads)
    image_bound = attention_bound(*image_shape, 2)
    bounds.update(msa_qtile_attention=image_bound,
                  msa_flash_attention=image_bound)
    floors = {name: exp_floor_ms(*(image_shape if name.startswith("msa")
                                   else WINDOW_SHAPE))
              for name in bounds}
    results = {}
    for shape, image in ((WINDOW_SHAPE, IMAGE_SHAPE),
                         (WINDOW_RECT_SHAPE, None)):
        for dtype in (torch.float32, torch.bfloat16):
            tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
            timed = dtype == torch.bfloat16
            cases = attention_cases(dtype, shape[3], shape, image)
            for name, (args, kw, plain, library) in cases.items():
                got = fns[name](*args, **kw)
                torch.cuda.synchronize()
                ref = plain()
                err, ok = max_err_and_tol(got, ref, tol_rel)
                del ref
                line = (f"  {name:24s} {tuple(args[0].shape)} x "
                        f"{tuple(args[-1].shape)} {str(dtype)[6:]:8s} "
                        f"max|kernel-plain| {err:.3e} (rel tol "
                        f"{tol_rel:.1e})")
                if timed:
                    ms = time_ms(lambda: fns[name](*args, **kw))
                    plain_ms = time_ms(plain, reps=5, warmup=1)
                    lib_ms = time_ms(library())
                    if shape == WINDOW_SHAPE:
                        bound_ms, by = bounds[name]
                        floor = floors[name]
                        results[name] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=by,
                            library_ms=lib_ms)
                    else:
                        bound_ms, by = attention_bound(*shape, 2)
                        floor = exp_floor_ms(*shape)
                    design = (f" (design {floor * EXP_PASSES[name]:.4f} ms)"
                              if name in EXP_PASSES else "")
                    line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
                             f"  bound {bound_ms:.4f} ms ({by})  exp floor "
                             f"{floor:.4f} ms{design}  library "
                             f"{lib_ms:.3f} ms")
                log(line)
                if not ok:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version: {err}")
            del cases
            torch.cuda.empty_cache()
    return results


def _device_randn(dtype, seed: int):
    """t(*shape, s, dt): seeded normal tensors on the card."""
    import torch

    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0, dt=dtype):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(s)
        return torch.from_numpy(a).to("cuda", dt)
    return t


def _shifted_and_not(bias, shift_mask, dtype):
    """(label, kernel mask, library mask) without and with the shift mask;
    the library takes bias + mask as one (1, nW or 1, heads, Nq, Nk)
    tensor."""
    return [("", None, bias.to(dtype)[None, None]),
            (" shifted", shift_mask,
             (bias[None] + shift_mask[:, None]).to(dtype)[None])]


def msa_attention_cases(dtype, seed: int, shape) -> dict:
    """Inputs of ``fused_msa_attention`` on a whole qkv image: label ->
    (wrapper name, args, kwargs, plain version, the library's attention on
    windows cut beforehand, the bound's arguments)."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops.attention import shift_attn_mask
    from super_resolution_tpu_torch.ops.windowing import window_partition

    t = _device_randn(dtype, seed)
    b, h, w, c, heads, ws = shape
    n, d, nwin = ws * ws, c // heads, (h // ws) * (w // ws)
    qkv = t(b, h, w, 3 * c)
    bias = t(heads, n, n, s=0.5, dt=torch.float32)
    shift = torch.from_numpy(shift_attn_mask(h, w, ws, ws // 2)).cuda()
    zeros = torch.zeros((1, n, n), device="cuda")
    win = window_partition(qkv, ws).reshape(b, nwin, n, 3, heads, d)
    qh, kh, vh = (win[:, :, :, i].transpose(2, 3).contiguous()
                  for i in range(3))                  # (b, nW, heads, N, d)
    cases = {}
    for label, mask, m in _shifted_and_not(bias, shift, dtype):
        cases[f"fused_msa_attention{label} d{d}"] = (
            "fused_msa_attention", (qkv, bias, mask),
            dict(heads=heads, window_size=ws),
            lambda mask=mask: ca.msa_attention_reference(
                qkv, bias, zeros if mask is None else mask, heads, ws),
            lambda m=m: F.scaled_dot_product_attention(qh, kh, vh,
                                                       attn_mask=m),
            (b * nwin, heads, n, n, d, qkv.element_size(),
             0 if mask is None else nwin, 0))
    return cases


def psa_block_cases(dtype, seed: int, shape) -> dict:
    """Inputs of ``fused_psa_block`` on a whole image, as
    :func:`msa_attention_cases`; the library's side is two ``F.linear``
    calls around its attention."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.models.srformer_arch import (
        psa_shift_mask)
    from super_resolution_tpu_torch.ops import cuda_psa as cp
    from super_resolution_tpu_torch.ops.windowing import window_partition

    t = _device_randn(dtype, seed)
    b, h, w, c, heads, ws = shape
    n, nk, d, nwin = ws * ws, ws * ws // 4, c // heads, (h // ws) * (w // ws)
    x = t(b, h, w, c)
    proj = (t(c, c, s=c ** -0.5), t(c, s=0.1), t(c, c, s=c ** -0.5),
            t(c, s=0.1))
    kvw = t(b * nwin, nk, 2 * c)
    bias = t(heads, n, nk, s=0.5, dt=torch.float32)
    shift = torch.from_numpy(psa_shift_mask(h, w, ws, ws // 2)).cuda()
    zeros = torch.zeros((1, n, nk), device="cuda")
    xw = window_partition(x, ws).reshape(b, nwin, n, c)
    wq_t, wp_t = proj[0].t().contiguous(), proj[2].t().contiguous()
    kh, vh = (kvw[..., i * c:(i + 1) * c].reshape(b, nwin, nk, heads, d)
              .transpose(2, 3).contiguous() for i in range(2))

    def library(m):
        q = F.linear(xw, wq_t, proj[1]).reshape(b, nwin, n, heads, d)
        o = F.scaled_dot_product_attention(q.transpose(2, 3), kh, vh,
                                           attn_mask=m)
        return F.linear(o.transpose(2, 3).reshape(b, nwin, n, c), wp_t,
                        proj[3])

    cases = {}
    for label, mask, m in _shifted_and_not(bias, shift, dtype):
        cases[f"fused_psa_block{label} d{d}"] = (
            "fused_psa_block", (x, *proj, kvw, bias, mask),
            dict(heads=heads, window_size=ws),
            lambda mask=mask: cp.psa_block_reference(
                x, *proj, kvw, bias, zeros if mask is None else mask, heads,
                ws),
            lambda m=m: library(m),
            (b * nwin, heads, n, nk, d, x.element_size(),
             0 if mask is None else nwin, c))
    return cases


def check_image_attention_kernels() -> dict:
    """Phase 3 for ``fused_msa_attention`` and ``fused_psa_block``: at the
    chunk shapes of ATD and SRFormer and of their light forms, without and
    with the shift mask, in float32 and bf16. Returns name -> timing of the
    shifted call at the full width in bf16."""
    import torch

    fns = wrappers()
    results = {}
    for light, (msa_shape, psa_shape) in enumerate(zip(MSA_SHAPES,
                                                       PSA_SHAPES)):
        for dtype in (torch.float32, torch.bfloat16):
            tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
            cases = {**msa_attention_cases(dtype, 7 + light, msa_shape),
                     **psa_block_cases(dtype, 9 + light, psa_shape)}
            for label, (name, args, kw, plain, library,
                        bound_args) in cases.items():
                got = fns[name](*args, **kw)
                torch.cuda.synchronize()
                ref = plain()
                err, ok = max_err_and_tol(got, ref, tol_rel)
                del ref
                line = (f"  {label:30s} {tuple(args[0].shape)} "
                        f"{str(dtype)[6:]:8s} max|kernel-plain| {err:.3e} "
                        f"(rel tol {tol_rel:.1e})")
                if dtype == torch.bfloat16:
                    ms = time_ms(lambda: fns[name](*args, **kw))
                    plain_ms = time_ms(plain, reps=5, warmup=1)
                    lib_ms = time_ms(library)
                    bound_ms, by = attention_bound(*bound_args)
                    floor = exp_floor_ms(*bound_args)
                    if not light and "shifted" in label:
                        results[name] = dict(
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=by,
                            library_ms=lib_ms)
                    design = (f" (design {floor * EXP_PASSES[name]:.4f} ms)"
                              if name in EXP_PASSES else "")
                    line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms"
                             f"  bound {bound_ms:.4f} ms ({by})  exp floor "
                             f"{floor:.4f} ms{design}  library "
                             f"{lib_ms:.3f} ms")
                log(line)
                if not ok:
                    raise AssertionError(f"{label} disagrees with its plain "
                                         f"version: {err}")
            del cases
            torch.cuda.empty_cache()
    return results


def scc_inputs(dtype, seed: int, shape, win, base):
    """(qv image, sl_w, sl_b, w_proj, b_proj, bias) of ``fused_scc_block``
    on the card."""
    import torch

    t = _device_randn(dtype, seed)
    b, h, w, c, heads = shape
    L, bl = win[0] * win[1], base[0] * base[1]
    return (t(b, h, w, c), t(L // bl, s=(L // bl) ** -0.5), t(1, s=0.1)[0],
            t(c, c, s=c ** -0.5), t(c, s=0.1),
            t(heads, L, bl, s=0.5, dt=torch.float32))


def scc_library(qv, sl_w, sl_b, w_proj, b_proj, bias, heads: int, win,
                base):
    """The library's composition of ``fused_scc_block`` (no one PyTorch
    call computes it): the windows cut, the base projection as one
    ``torch.einsum``, per head the correlation with its bias
    (``torch.baddbmm``) and its product with vs (``torch.bmm``), the
    channel Gram and its product with v (``torch.bmm``), the output
    ``F.linear`` and the windows put back."""
    import torch
    import torch.nn.functional as F

    from super_resolution_tpu_torch.ops import cuda_scc as cs

    _, h, w, c = qv.shape
    c2, L = c // 2, win[0] * win[1]
    d = c2 // heads
    P, _ = cs.scc_base_projection(*win, *base, sl_w, sl_b)
    w_t = w_proj.t().contiguous()
    bias_t = bias.to(qv.dtype)

    def run():
        x = cs.rect_win_partition(qv, *win)
        q, v = x[..., :c2], x[..., c2:]
        vs = torch.einsum("ml,blc->bmc", P, v) + sl_b
        parts = []
        for hh in range(heads):
            qh, vh = q[..., hh * d:(hh + 1) * d], vs[..., hh * d:(hh + 1) * d]
            corr = torch.baddbmm(bias_t[hh].expand(x.shape[0], -1, -1), qh,
                                 vh.transpose(1, 2), alpha=1.0 / d)
            parts.append(torch.bmm(corr, vh))
        corr_c = torch.bmm(q.transpose(1, 2), v) / L
        parts.append(torch.bmm(v, corr_c.transpose(1, 2)))
        o = F.linear(torch.cat(parts, -1), w_t, b_proj)
        return cs.rect_win_reverse(o, *win, h, w)
    return run


def scc_bound(shape, win, base, esize: int):
    """(bound_ms, bound_by) of one ``fused_scc_block`` call: the image read
    and written once, the float32 bias and the weights read once, over the
    HBM rate, against its products (the base projection, the correlation
    and its product with vs per head, the channel Gram and its product
    with v, the output projection) at the tensor cores' bf16 rate and the
    scale and bias of every correlation at the float32 rate."""
    b, h, w, c, heads = shape
    L, bl, c2 = win[0] * win[1], base[0] * base[1], c // 2
    tok = b * h * w
    mm = tok * (2 * c2 + 4 * bl * c2 + 4 * c2 * c2 + 2 * c * c)
    vec = 2 * tok * heads * bl
    byts = (2 * tok * c * esize + heads * L * bl * 4
            + (c * c + c + L // bl + 1) * esize)
    t_ops = max(mm / PEAK["bf16"], vec / PEAK["f32"])
    t_bytes = byts / PEAK["hbm"]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_scc_kernel() -> dict:
    """Phase 3 for ``fused_scc_block``: at the chunk shape of HiT-SRF at
    each window size of a group, and at a rectangular window, in float32
    and bf16. A chunk forward launches every window size equally often, so
    the kernels line reports the means over the six sizes; the time of each
    stands beside them (``ms_by_window``)."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_scc as cs

    fn = wrappers()["fused_scc_block"]
    b, h, w, c, heads, bs = SCC_SHAPE
    cases = [((b, h, w, c, heads), (ws, ws), (min(ws, bs),) * 2)
             for ws in SCC_WINDOWS] + [SCC_RECT]
    rows = []
    for shape, win, base in cases:
        kw = dict(heads=shape[4], window_size=win, base=base)
        for dtype in (torch.float32, torch.bfloat16):
            tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
            args = scc_inputs(dtype, win[0] + win[1], shape, win, base)

            def plain():
                return cs.scc_block_reference(*args, shape[4], win, base)

            got = fn(*args, **kw)
            torch.cuda.synchronize()
            ref = plain()
            err, ok = max_err_and_tol(got, ref, tol_rel)
            line = (f"  fused_scc_block window {win} base {base} "
                    f"{tuple(args[0].shape)} {str(dtype)[6:]:8s} "
                    f"max|kernel-plain| {err:.3e} (rel tol {tol_rel:.1e})")
            if dtype == torch.bfloat16:
                # the worst element's bound is loose at the output's scale;
                # the error over the whole image, of the kernel and of the
                # bf16 plain version, against the float32 plain version
                exact = cs.scc_block_reference(*(a.float() for a in args),
                                               shape[4], win, base)
                l2 = [((x.float() - exact).norm() / exact.norm()).item()
                      for x in (got, ref)]
                del exact
                ok = ok and l2[0] <= TOL_SCC_BF16_L2
                line += (f" rel L2 to float32 plain {l2[0]:.2e} (tol "
                         f"{TOL_SCC_BF16_L2:.0e}; bf16 plain {l2[1]:.2e})")
                ms = time_ms(lambda: fn(*args, **kw))
                plain_ms = time_ms(plain, reps=5, warmup=1)
                lib_ms = time_ms(scc_library(*args, shape[4], win, base))
                bound_ms, by = scc_bound(shape, win, base, 2)
                if (shape, win, base) != SCC_RECT:
                    rows.append(dict(window=win[0], max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bound_ms,
                                     bound_by=by, library_ms=lib_ms))
                line += (f"  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                         f"bound {bound_ms:.4f} ms ({by})  library "
                         f"{lib_ms:.3f} ms" + COMPOSITIONS["fused_scc_block"])
            del ref
            log(line)
            if not ok:
                raise AssertionError(f"fused_scc_block at window {win} "
                                     f"disagrees with its plain version: "
                                     f"{err}")
            del args
            torch.cuda.empty_cache()
    mean = {k: statistics.fmean(r[k] for r in rows)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return {"fused_scc_block": dict(
        max_abs_err=max(r["max_abs_err"] for r in rows), **mean,
        bound_by=rows[0]["bound_by"],
        ms_by_window={r["window"]: r["ms"] for r in rows})}


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return float("inf") if mse == 0 else -10.0 * float(np.log10(mse))


def n_forwards(h: int, w: int, ws: int, tile: dict) -> int:
    """Chunk forwards the tile engine makes for an LR request, which the
    runner pads to a multiple of the window ws first."""
    from super_resolution_tpu_torch.runtime.tile import _axis_plan

    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    tiles = (_axis_plan(hp, tile["tile_size"], tile["tile_pad"])[0]
             * _axis_plan(wp, tile["tile_size"], tile["tile_pad"])[0])
    return -(-tiles // tile["chunk"])


def net_scale(net: dict) -> int:
    """The ESC family's ``upscaling_factor``, the others' ``upscale``."""
    return net.get("upscaling_factor", net.get("upscale"))


# the runner of each network type; the ESC family, ATD, SRFormer and HiT-SRF
# run under the one their option files name, ESRModel
RUNNERS = {"HATClassic": "HATModel", "HAT": "HATModel",
           "SwinIR": "SwinIRModel"}


def path_options(label: str, bf16: bool = True) -> dict:
    """Options of a path's runner, with the tile settings of its first
    run."""
    net = PATHS[label]["net"]
    return dict(name=f"chip_smoke_{label}",
                model_type=RUNNERS.get(net["type"], "ESRModel"),
                scale=net_scale(net), manual_seed=0, network_g=net,
                tile=PATHS[label]["runs"][0][0],
                val=dict(inference_dtype="bf16") if bf16 else {})


def widen(net) -> None:
    """Widen seeded weights where the seeded scheme leaves a branch silent:
    the zero-initialised dynamic-kernel heads of the ESC conv attention get
    small random weights and the RPB tables a wider spread, so the dynamic
    conv and the bias act."""
    import torch

    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "dwc_proj.3" in name:
                p.copy_(torch.empty(p.shape).normal_(std=0.02, generator=gen))
            elif name.endswith(("relative_position_bias_table",
                                "relative_position_bias")):
                p.copy_(torch.empty(p.shape).normal_(std=0.2, generator=gen))


def make_predictor(label: str, device: str, bf16: bool, state=None):
    """A Predictor of one main path. With no ``state`` its seeded weights
    are widened (:func:`widen`); with ``state`` it takes those weights."""
    from super_resolution_tpu_torch.predict import Predictor

    pred = Predictor(path_options(label, bf16), device=device)
    if state is None:
        widen(pred.model.net_g)
    else:
        pred.model.net_g.load_state_dict(state, strict=True)
    pred.model._eval_net = None
    return pred


def category_ids(pred, serve, tile, lq) -> list:
    """The token each pixel falls to in every AC-MSA of an ATD predictor
    while it serves one request: the argmax that sorts the pixels into
    groups."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[1].argmax(-1)))
        for m in pred.model.eval_net().modules()
        if type(m).__name__ == "AC_MSA"]
    serve(pred, tile, lq)
    for hook in hooks:
        hook.remove()
    return seen


def main_path(label: str, first_outputs: dict) -> dict:
    """Phase 4, one path. Returns the launch counts of the timed pass and
    adds the output of its first request to ``first_outputs``."""
    import torch

    spec = PATHS[label]
    calls, net = spec["calls"], spec["net"]
    scale = net_scale(net)
    pred = make_predictor(label, "cuda", bf16=True)
    rng = np.random.default_rng(0)
    # every request of every run: (tile settings, (h, w), image)
    jobs = [(tile, hw, rng.random((*hw, 3), dtype=np.float32))
            for tile, requests in spec["runs"] for hw in requests]

    def serve(predictor, tile, lq):
        predictor.model.opt["tile"] = tile
        return predictor.predict_array(lq)

    for tile, _, lq in jobs:   # warm-up: cuDNN plans, cached kernel operands
        serve(pred, tile, lq)
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    outs, times = [], []
    for tile, _, lq in jobs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(serve(pred, tile, lq))   # ends in a device-to-host copy
        times.append(time.perf_counter() - t0)
    counts = {name: fn.launches for name, fn in fns.items()}

    # the runner pads to the network's window, 16 where it names none
    fwd = sum(n_forwards(h, w, net.get("window_size", 16), tile)
              for tile, (h, w), _ in jobs)
    for name, count in counts.items():
        if count != calls.get(name, 0) * fwd:
            raise AssertionError(f"{label}: {name}: {count} launches, "
                                 f"expected {calls.get(name, 0)} x {fwd} "
                                 f"chunk forwards")
    log(f"  launches in the timed pass ({fwd} chunk forwards): {counts}")
    first_outputs[label] = outs[0]
    if "same_as" in spec:
        other = first_outputs[spec["same_as"]]
        log(f"  first request against path {spec['same_as']} on the same "
            f"weights: PSNR {psnr(outs[0], other):.2f} dB, max abs "
            f"difference {np.abs(outs[0] - other).max():.3e}")
        if psnr(outs[0], other) < PSNR_MIN_DB:
            raise AssertionError(f"{label} differs from {spec['same_as']}")

    # float32 references on the same weights: the float32 kernels on the
    # card for every request, the plain path on the host CPU for the first
    state = {k: v.cpu() for k, v in pred.model.net_g.state_dict().items()}
    is_atd = net["type"] == "ATD"
    ids16 = category_ids(pred, serve, *jobs[0][::2]) if is_atd else []
    del pred
    torch.cuda.empty_cache()
    gpu32 = make_predictor(label, "cuda", bf16=False, state=state)
    if is_atd:
        # the discrete step: pixels that bf16 sorts into another group
        ids32 = category_ids(gpu32, serve, *jobs[0][::2])
        moved = [float((a != b).float().mean()) for a, b in zip(ids16, ids32)]
        log(f"  share of pixels whose AC-MSA category differs between bf16 "
            f"and float32, first request: layer 0 {moved[0]:.4%}, last "
            f"layer {moved[-1]:.4%}, mean of {len(moved)} layers "
            f"{sum(moved) / len(moved):.4%}")
    cpu = (make_predictor(label, "cpu", bf16=False, state=state)
           if spec["cpu_reference"] else None)
    for i, ((tile, (h, w), lq), out, sec) in enumerate(zip(jobs, outs,
                                                           times)):
        if (out.shape != (scale * h, scale * w, 3)
                or not np.isfinite(out).all()):
            raise AssertionError(f"request {h}x{w}: output {out.shape}, "
                                 f"finite {np.isfinite(out).all()}")
        k32 = serve(gpu32, tile, lq)
        line = (f"  request {h}x{w} (tile {tile['tile_size']}) -> "
                f"{scale * h}x{scale * w}: {sec * 1e3:.1f} ms, "
                f"{scale * scale * h * w / sec / 1e6:.3f} out-Mpix/s; "
                f"out mean {out.mean():.4f} std {out.std():.4f}; "
                f"PSNR bf16 kernels vs f32 kernels {psnr(out, k32):.2f} dB")
        checks = [psnr(out, k32)]
        if i < spec["cpu_reference"]:
            t0 = time.perf_counter()
            p32 = serve(cpu, tile, lq)
            checks.append(psnr(out, p32))
            line += (f"; vs f32 plain (CPU, {time.perf_counter() - t0:.1f} s)"
                     f" {checks[-1]:.2f} dB; max|f32 kernels - f32 plain| "
                     f"{np.abs(k32 - p32).max():.3e}")
        log(line)
        if min(checks) < PSNR_MIN_DB:
            raise AssertionError(f"request {h}x{w}: PSNR {min(checks):.2f} "
                                 f"dB < {PSNR_MIN_DB}")
    del gpu32, cpu
    torch.cuda.empty_cache()
    return counts


# phase 5: the evaluation paths of test.py on the disk backend. A synthetic
# Set5: its names and GT sizes (H x W), the LR made with the MATLAB bicubic
# at 1 / 4; and one 300 x 400 LR image for the tiled option file
SET5 = {"baby": (512, 512), "bird": (288, 288), "butterfly": (256, 256),
        "head": (280, 280), "woman": (228, 344)}
TILE_LR = (300, 400)
# kernel launches a forward of the option files' HAT x4 (6 RHAGs of 6 HABs
# and an OCAB; ocab_esc_enable is off, so the OCAB is fused_ocab_block) and
# of ESC x4 (5 blocks)
_EVAL_HAT = {"ln_split": 36, "gated_dconv_ffn_block": 36,
             "fused_ocab_block": 6, "mlp_block": 6}
# label -> option file, dtype, launches a forward; each runs the option file
# unedited but for its data roots, weights and results root
EVAL_PATHS = {
    "eval_hat_f32": dict(yml="options/test/HAT_SRx4.yml", bf16=False,
                         calls=_EVAL_HAT),
    "eval_hat_bf16": dict(yml="options/test/HAT_SRx4.yml", bf16=True,
                          calls=_EVAL_HAT),
    "eval_esc_f32": dict(yml="options/esc/test/ESC_DIV2K_X4.yml",
                         bf16=False, calls={"fused_attention": 5}),
    "eval_esc_bf16": dict(yml="options/esc/test/ESC_DIV2K_X4.yml",
                          bf16=True, calls={"fused_attention": 5}),
    "eval_tile": dict(yml="options/test/HAT_tile_example.yml", bf16=True,
                      calls=_EVAL_HAT),
}
# the whole-image shapes of the kernels on those paths: Set5's 57 x 86 and
# 70 x 70 LR images padded to the HAT's window 16, and ESC's six windows of
# 32 x 32 on the first
EVAL_IMAGES = [(64, 96), (80, 80)]
EVAL_HAT_ROWS = ["ln_split", "gated_dconv_ffn_block", "fused_ocab_block",
                 "fused_ocab_attention", "mlp_block"]
EVAL_ESC_WINDOWS = (6, 4, 1024, 1024, 16)


def check_whole_image_kernels() -> None:
    """Phase 3 at the whole-image shapes of phase 5 (one image, H != W):
    the HAT's rows on (1, 64, 96, 180) and (1, 80, 80, 180) and ESC's
    window attention on six windows, in float32 and bf16, each against its
    plain version and timed."""
    import torch

    fns = wrappers()
    for dtype in (torch.float32, torch.bfloat16):
        tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
        cases = [(f"1x{h}x{w}", name, case)
                 for h, w in EVAL_IMAGES
                 for name, case in kernel_cases(1, (h, w), dtype,
                                                seed=h + w).items()
                 if name in EVAL_HAT_ROWS]
        cases.append((str(EVAL_ESC_WINDOWS), "fused_attention",
                      attention_cases(dtype, 5, EVAL_ESC_WINDOWS)[
                          "fused_attention"]))
        for shape, name, (args, kw, plain, _) in cases:
            got = fns[name](*args, **kw)
            torch.cuda.synchronize()
            err, ok = max_err_and_tol(got, plain(), tol_rel)
            ms = time_ms(lambda: fns[name](*args, **kw))
            log(f"  {name:24s} {shape:22s} {str(dtype)[6:]:8s} "
                f"max|kernel-plain| {err:.3e} (rel tol {tol_rel:.1e})  "
                f"kernel {ms:.3f} ms")
            if not ok:
                raise AssertionError(f"{name} at {shape} disagrees with its "
                                     f"plain version: {err}")
        del cases
        torch.cuda.empty_cache()


def write_eval_sets(root: str) -> dict:
    """Synthetic images under root as the option files expect them: Set5's
    GT (seeded smooth content and noise, uint8), its LR by the port's
    MATLAB bicubic at 1 / 4 rounded to uint8, once named as the GT
    (HAT_SRx4.yml) and once '<name>x4' (ESC_DIV2K_X4.yml's filename_tmpl),
    the smallest pair alone, and one large LR image."""
    from super_resolution_tpu_torch.utils.img import imwrite
    from super_resolution_tpu_torch.utils.matlab import imresize

    dirs = {k: os.path.join(root, k) for k in
            ("gt", "lq", "lq_x4", "small_gt", "small_lq", "large")}
    rng = np.random.default_rng(0)

    def image(h, w):
        yy, xx = np.mgrid[0:h, 0:w] / 64.0
        base = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                   + xx[..., None] * rng.uniform(0.5, 2)
                                   + np.arange(3))
        img = np.clip(base + rng.normal(0, 0.04, (h, w, 3)), 0, 1)
        return (img * 255).round().astype(np.uint8)

    smallest = min(SET5, key=lambda n: SET5[n][0] * SET5[n][1])
    for name, (h, w) in SET5.items():
        gt = image(h, w)
        lq = imresize(gt.astype(np.float32) / 255.0, 0.25)
        lq = (np.clip(lq, 0, 1) * 255).round().astype(np.uint8)
        imwrite(gt, os.path.join(dirs["gt"], f"{name}.png"))
        imwrite(lq, os.path.join(dirs["lq"], f"{name}.png"))
        imwrite(lq, os.path.join(dirs["lq_x4"], f"{name}x4.png"))
        if name == smallest:
            imwrite(gt, os.path.join(dirs["small_gt"], f"{name}.png"))
            imwrite(lq, os.path.join(dirs["small_lq"], f"{name}.png"))
    imwrite(image(*TILE_LR), os.path.join(dirs["large"], "large.png"))
    return dict(dirs, smallest=smallest)


def eval_weights(yml: str, path: str) -> None:
    """The option file's network with the runner's seeded weights (its
    ``manual_seed``), widened as the main paths' (:func:`widen`), saved as
    {"params_ema": state}: the file's param_key_g and strict_load_g act."""
    import torch

    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(yml)
    net = build_network(opt["network_g"])
    init_weights(net, torch.Generator().manual_seed(opt["manual_seed"]))
    widen(net)
    torch.save({"params_ema": net.state_dict()}, path)


class EvalClock:
    """While a path runs, wraps the runners' inference and per-image tail:
    for each image the inference seconds (to a synchronised card), the
    host seconds of tensor2img, the PNG and the metrics, and the output on
    the host (copied outside both clocks)."""

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.runtime import sr_model as m

        self.infer, self.host, self.outputs = [], [], []
        run = m.HATModel._run_inference
        post = m.SRModel._validation_postprocess
        self._undo = [(m.HATModel, "_run_inference", run),
                      (m.SRModel, "_validation_postprocess", post)]

        def timed_run(model):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(model)
            torch.cuda.synchronize()
            self.infer.append(time.perf_counter() - t0)
            self.outputs.append(model.output[0].float().cpu().numpy())

        def timed_post(model, *args, **kw):
            t0 = time.perf_counter()
            post(model, *args, **kw)
            self.host.append(time.perf_counter() - t0)

        m.HATModel._run_inference = timed_run
        m.SRModel._validation_postprocess = timed_post
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self._undo:
            setattr(cls, name, fn)


def image_metrics(png: str, gt: str, metrics: dict) -> dict:
    """The option file's metrics of one saved PNG against its GT, as the
    runner computes them (both uint8 BGR)."""
    from super_resolution_tpu_torch.metrics import calculate_metric
    from super_resolution_tpu_torch.utils.img import imread

    sr, ref = imread(png), imread(gt)
    ref = ref[:sr.shape[0], :sr.shape[1]]
    return {m: calculate_metric({"img": sr, "img2": ref}, o)
            for m, o in metrics.items()}


def check_against_cpu(yml: str, sets: dict, pth: str, vis: str,
                      root: str) -> None:
    """The float32 metrics of the smallest image on the card against the
    port's own test pipeline on the host CPU (plain versions of every
    kernel), on the same weights: within 0.01 dB and 1e-4."""
    from super_resolution_tpu_torch.runtime.test_pipeline import \
        test_from_yaml
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(yml)
    name = sets["smallest"]
    data = dict(opt["datasets"]["test_1"], dataroot_gt=sets["small_gt"],
                dataroot_lq=sets["small_lq"])
    t0 = time.perf_counter()
    cpu = test_from_yaml(yml, os.path.join(root, "cpu"), device="cpu",
                         datasets={"test_1": data},
                         path=dict(opt["path"], pretrain_network_g=pth))
    cpu = cpu[data["name"]]
    card = image_metrics(os.path.join(vis, f"{name}_{opt['name']}.png"),
                         os.path.join(sets["gt"], f"{name}.png"),
                         opt["val"]["metrics"])
    log(f"  {name}, float32: card {card}, host CPU {cpu} "
        f"({time.perf_counter() - t0:.1f} s)")
    if (abs(card["psnr"] - cpu["psnr"]) > 0.01
            or abs(card["ssim"] - cpu["ssim"]) > 1e-4):
        raise AssertionError(f"{name}: card {card} against CPU {cpu}")


def eval_path(label: str, sets: dict, root: str, card: str,
              f32_outputs: dict) -> dict:
    """Phase 5, one path: the port's test pipeline on an unedited option
    file, its data roots, weights and results root overridden, run twice
    (the second run finds the card's per-shape state warm; each builds its
    own runner). Each run's launches, outputs, PNGs and metrics are
    checked. Returns the launch counts of the second run; keeps the
    float32 paths' outputs in ``f32_outputs`` for the bf16 path of the
    same file."""
    import torch

    from super_resolution_tpu_torch.runtime.test_pipeline import (
        test_from_yaml, test_pipeline)
    from super_resolution_tpu_torch.utils.img import imread
    from super_resolution_tpu_torch.utils.options import yaml_load

    spec = EVAL_PATHS[label]
    yml, calls = spec["yml"], spec["calls"]
    opt = yaml_load(yml)
    data = dict(opt["datasets"]["test_1"])
    pth = os.path.join(root, os.path.basename(yml) + ".pth")
    if not os.path.exists(pth):
        eval_weights(yml, pth)
    tiled = "tile" in opt
    if tiled:
        data["dataroot_lq"] = sets["large"]
    else:
        data["dataroot_gt"] = sets["gt"]
        data["dataroot_lq"] = sets["lq_x4" if "filename_tmpl" in data
                                   else "lq"]
    scale = opt["scale"]
    if tiled:
        fwd = n_forwards(*TILE_LR, opt["network_g"]["window_size"],
                         opt["tile"])
        shapes = [(scale * TILE_LR[0], scale * TILE_LR[1], 3)]
    else:
        # the GT sizes are multiples of 4: the SR is GT-sized
        fwd, shapes = len(SET5), [(*SET5[k], 3) for k in sorted(SET5)]
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}

    def run(out_root):
        if label == "eval_hat_f32":
            # the file as it is, through the CLI's entry
            return test_pipeline(out_root, argv=[
                "-opt", yml, "--force_yml",
                f"datasets:test_1:dataroot_gt={data['dataroot_gt']}",
                f"datasets:test_1:dataroot_lq={data['dataroot_lq']}",
                f"path:pretrain_network_g={pth}"])
        extra = dict(inference_dtype="bf16") if spec["bf16"] else {}
        return test_from_yaml(
            yml, out_root, device="cuda", datasets={"test_1": data},
            path=dict(opt["path"], pretrain_network_g=pth), **extra)

    for attempt in ("first", "second"):
        out_root = os.path.join(root, label, attempt)
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with EvalClock() as clock:
            results = run(out_root)
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in fns.items()}
        for name, count in counts.items():
            if count != calls.get(name, 0) * fwd:
                raise AssertionError(f"{label}: {name}: {count} launches, "
                                     f"expected {calls.get(name, 0)} x "
                                     f"{fwd} forwards")
        for out, shape in zip(clock.outputs, shapes, strict=True):
            if out.shape != shape or not np.isfinite(out).all():
                raise AssertionError(
                    f"{label}: output {out.shape}, expected {shape}, "
                    f"finite {np.isfinite(out).all()}")
        for value in results[data["name"]].values():
            if not np.isfinite(value):
                raise AssertionError(f"{label}: metric {value}")
        vis = os.path.join(out_root, "results", opt["name"],
                           "visualization", data["name"])
        pngs = sorted(os.listdir(vis)) if opt["val"].get("save_img") else []
        if opt["val"].get("save_img") and len(pngs) != len(shapes):
            raise AssertionError(f"{label}: {len(pngs)} PNGs for "
                                 f"{len(shapes)} images")
        for png, shape in zip(pngs, shapes):
            got = imread(os.path.join(vis, png)).shape
            if got != shape:
                raise AssertionError(f"{label}: {png} is {got}, not "
                                     f"{shape}")
        n = len(shapes)
        infer, host = sum(clock.infer) / n, sum(clock.host) / n
        log(f"[eval:{label}] {card}: {attempt} run, {n} images, "
            f"{wall / n:.3f} s an image wall = inference {infer:.3f} + host "
            f"tensor2img, PNG and metrics {host:.3f} + set-up and reading "
            f"{wall / n - infer - host:.3f}; per image inference "
            f"{[round(t, 4) for t in clock.infer]}, host "
            f"{[round(t, 4) for t in clock.host]}")
    log(f"  launches a run ({fwd} forwards): "
        f"{ {k: v for k, v in counts.items() if v} }; {len(pngs)} PNGs; "
        f"results {results}")
    base = label.rsplit("_", 1)[0]
    if label.endswith("_f32"):
        f32_outputs[base] = clock.outputs
    elif base in f32_outputs:
        worst = min(psnr(a, b) for a, b in zip(clock.outputs,
                                               f32_outputs.pop(base)))
        log(f"  PSNR bf16 vs float32 on the card, worst image {worst:.2f} dB")
        if worst < PSNR_MIN_DB:
            raise AssertionError(f"{label}: PSNR {worst:.2f} dB < "
                                 f"{PSNR_MIN_DB}")
    if label == "eval_hat_f32":
        check_against_cpu(yml, sets, pth, vis, root)
    del clock
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 6
# the kernels a train step runs, with the entries that give them a backward
# (kernel forward, autograd through the plain version backward)
TRAIN_ROWS = {"ln_split": ("cuda_hab", "ln_split_ad", "ln_split_reference"),
              "gated_dconv_ffn_block": ("cuda_ffn", "gated_dconv_ffn_block_ad",
                                        "ffn_block_reference"),
              "fused_ocab_block": ("cuda_attention", "fused_ocab_block_ad",
                                   "ocab_block_reference"),
              "mlp_block": ("cuda_ffn", "mlp_block_ad",
                            "mlp_block_reference")}
# a train step's training shape: LQ patches of 64 x 64 (gt_size 256, x4)
TRAIN_SHAPE = (4, 64)
# synthetic DF2K-sub pairs: GT 480 x 480 crops as DF2K_HR_sub holds them,
# enough for one batch of 32
TRAIN_PAIRS, TRAIN_GT = 32, 480
# the launches a step of the flagship HAT x4 files: rows 7, 8 once (the one
# HAB at drop-path rate 0), rows 5, 6 once an RHAG; twice under remat
_TRAIN_ROOTS = {"datasets:train:dataroot_gt": "train_gt",
                "datasets:train:dataroot_lq": "train_lq",
                "datasets:val:dataroot_gt": "val_gt",
                "datasets:val:dataroot_lq": "val_lq"}
# label -> option file, the batch it runs at (None: the file's), the data
# roots it is given, the launches a step and an eval image
# The training files of phases 6 and 7 run 2 of their 6 RHAGs (ESC: 2 of
# its 5 blocks), added to a copy of each file: at full depth, with phase
# 13, the whole script took 1251 s of its 1200 on a slower host, most of
# it these files' runs and first losses on the host CPU. Their launches
# scale with the depth.
CUT_HAT = {"network_g:depths": [6, 6], "network_g:num_heads": [6, 6]}
CUT_ESC = {"network_g:n_blocks": 2}
_HAT2_STEP = {"ln_split": 1, "gated_dconv_ffn_block": 1,
              "fused_ocab_block": 2, "mlp_block": 2}
_HAT2_IMAGE = {"ln_split": 12, "gated_dconv_ffn_block": 12,
               "fused_ocab_block": 2, "mlp_block": 2}
TRAIN_PATHS = {
    "train_f32": dict(yml="options/train/train_HAT_SRx4_from_scratch.yml",
                      batch=4, roots=_TRAIN_ROOTS, added=CUT_HAT,
                      per_step=_HAT2_STEP, per_image=_HAT2_IMAGE),
    "train_amp_remat": dict(yml="options/train/train_HAT_SRx4_amp_remat.yml",
                            batch=None, roots=_TRAIN_ROOTS, added=CUT_HAT,
                            per_step={k: 2 * v for k, v in
                                      _HAT2_STEP.items()},
                            per_image=_HAT2_IMAGE),
}
TRAIN_ITERS, TRAIN_EVERY = 6, 3


def check_autograd_entry(wrapper, ad, plain, args, kw, dtype,
                         what: str) -> None:
    """One autograd entry on the card: the forward against the plain
    version, every input's gradient against autograd through the plain
    version (a random cotangent), one launch a forward; forward + backward
    times of the entry and of the plain version under autograd."""
    import torch

    tol_rel = TOL_F32 if dtype == torch.float32 else TOL_BF16
    leaves = [a.detach().clone().requires_grad_() for a in args]
    wrapper.launches = 0
    out = ad(*leaves, **kw)
    launches = wrapper.launches
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cts = [torch.randn(o.shape, generator=gen, device="cuda",
                       dtype=o.dtype) for o in outs]
    grads = torch.autograd.grad(outs, leaves, cts)
    ref_leaves = [a.detach().clone().requires_grad_() for a in args]
    ref = plain(*ref_leaves, **kw)
    refs = ref if isinstance(ref, tuple) else (ref,)
    ref_grads = torch.autograd.grad(refs, ref_leaves, cts)
    torch.cuda.synchronize()
    err, ok = max_err_and_tol(tuple(o.detach() for o in outs),
                              tuple(r.detach() for r in refs), tol_rel)
    gerr, gok = max_err_and_tol(tuple(grads), tuple(ref_grads), tol_rel)
    name = getattr(ad, "__name__", str(ad))
    if not (ok and gok and launches == 1):
        raise AssertionError(f"{name} {dtype}: forward err {err}, gradient "
                             f"err {gerr}, {launches} launches")
    del out, outs, grads, ref, refs, ref_grads

    def step(fn, xs):
        o = fn(*xs, **kw)
        return torch.autograd.grad(o if isinstance(o, tuple) else (o,), xs,
                                   cts)
    ms = time_ms(lambda: step(ad, leaves), reps=5)
    plain_ms = time_ms(lambda: step(plain, ref_leaves), reps=5)
    peak = 0.0
    for fn, xs in ((ad, leaves), (plain, ref_leaves)):
        torch.cuda.reset_peak_memory_stats()
        step(fn, xs)
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"  {name:26s} {what} {str(dtype)[6:]:8s} forward "
        f"max|entry-plain| {err:.3e}, gradients {gerr:.3e} (rel tol "
        f"{tol_rel:.1e}), {launches} launch a forward; forward + backward "
        f"{ms:.3f} ms, plain under autograd {plain_ms:.3f} ms; peak memory "
        f"{peak:.2f} GiB")
    torch.cuda.empty_cache()


def check_train_functions() -> None:
    """Phase 6 (a): the four kernels of a train step through their
    autograd entries at the training shape (4, 64, 64, 180), float32 (TF32
    off) and bf16 (:func:`check_autograd_entry`)."""
    import importlib

    import torch

    for dtype in (torch.float32, torch.bfloat16):
        cases = kernel_cases(*TRAIN_SHAPE, dtype, seed=64)
        for name, (mod, ad_name, plain_name) in TRAIN_ROWS.items():
            module = importlib.import_module(
                f"super_resolution_tpu_torch.ops.{mod}")
            args, kw, _, _ = cases[name]
            check_autograd_entry(
                getattr(module, name), getattr(module, ad_name),
                getattr(module, plain_name), args, kw, dtype,
                f"B{TRAIN_SHAPE[0]} {TRAIN_SHAPE[1]}x{TRAIN_SHAPE[1]}")
        del cases
        torch.cuda.empty_cache()


def write_train_pairs(root: str, sets: dict) -> dict:
    """TRAIN_PAIRS synthetic pairs as DF2K-sub holds them: GT crops of
    TRAIN_GT x TRAIN_GT (seeded smooth content and noise, uint8) and their
    LR by the port's MATLAB bicubic at 1 / 4 and at 1 / 2, same names, and
    a meta_info_file listing the GT. And the validation sets: the pairs of
    phase 5's Set5 whose LR sides are window multiples (the HAT x4 files
    name SRModel, which does not pad, and the HAT's windows need them, in
    the JAX package too), and at x2 its images whose x2 LR sides are
    window multiples, up to 288 x 288."""
    from super_resolution_tpu_torch.utils.img import (img2tensor, imread,
                                                      imwrite)
    from super_resolution_tpu_torch.utils.matlab import imresize

    dirs = {k: os.path.join(root, k) for k in (
        "train_gt", "train_lq", "train_lq2", "val_gt", "val_lq", "val2_gt",
        "val2_lq")}
    dirs["train_meta"] = os.path.join(root, "train_meta.txt")
    for name, (h, w) in SET5.items():
        if h % (4 * WS) == 0 and w % (4 * WS) == 0:
            for src, dst in (("gt", "val_gt"), ("lq", "val_lq")):
                os.makedirs(dirs[dst], exist_ok=True)
                shutil.copy(os.path.join(sets[src], f"{name}.png"),
                            dirs[dst])
        if h % (2 * WS) == 0 and w % (2 * WS) == 0 and h * w <= 288 ** 2:
            os.makedirs(dirs["val2_lq"], exist_ok=True)
            os.makedirs(dirs["val2_gt"], exist_ok=True)
            shutil.copy(os.path.join(sets["gt"], f"{name}.png"),
                        dirs["val2_gt"])
            gt = imread(os.path.join(sets["gt"], f"{name}.png"),
                        float32=True)
            lq = imresize(img2tensor(gt), 0.5)
            imwrite((np.clip(lq, 0, 1) * 255).round().astype(np.uint8),
                    os.path.join(dirs["val2_lq"], f"{name}.png"))
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:TRAIN_GT, 0:TRAIN_GT] / 48.0
    with open(dirs["train_meta"], "w") as meta:
        for i in range(TRAIN_PAIRS):
            base = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                       + xx[..., None] * rng.uniform(0.5, 2)
                                       + np.arange(3))
            gt = np.clip(base + rng.normal(0, 0.04, base.shape), 0, 1)
            gt = (gt * 255).round().astype(np.uint8)
            name = f"{i:04d}_s001.png"
            imwrite(gt, os.path.join(dirs["train_gt"], name))
            for key, s in (("train_lq", 0.25), ("train_lq2", 0.5)):
                lq = imresize(gt.astype(np.float32) / 255.0, s)
                imwrite((np.clip(lq, 0, 1) * 255).round().astype(np.uint8),
                        os.path.join(dirs[key], name))
            meta.write(f"{name} ({TRAIN_GT},{TRAIN_GT},3)\n")
    return dirs


class TrainClock:
    """While a training run goes, wraps the runners: each step's seconds (to
    a synchronised card), logs, kernel launches and momentum resets, the
    first batch and the weights before the first update, and each
    validation's launches, images and PSNR."""

    def __init__(self, fns: dict):
        self.fns = fns

    def _counts(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.runtime import esr_model as e
        from super_resolution_tpu_torch.runtime import sr_model as m

        self.steps, self.logs, self.step_counts = [], [], []
        self.val_counts, self.val_images, self.psnr = [], [], []
        self.resets, self.first_batch, self.first_state = [], None, None
        self.tb = None
        val, reset = m.SRModel.validation, e.reset_momentum
        self._undo = [(m.SRModel, "validation", val),
                      (e, "reset_momentum", reset)]
        self._iter = 0

        def timed(step):
            def timed_step(model, batch, current_iter):
                if self.first_batch is None:
                    self.first_batch = batch
                    self.first_state = {
                        k: v.detach().cpu().clone() for k, v in
                        model.net_g.state_dict().items()}
                before = self._counts()
                self._iter = current_iter
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(model, batch, current_iter)
                torch.cuda.synchronize()
                self.steps.append(time.perf_counter() - t0)
                self.logs.append(model.get_current_log())
                self.step_counts.append({k: v - before[k] for k, v in
                                         self._counts().items()})
            return timed_step

        for cls in (m.SRModel, e.ESRModel):
            step = cls.__dict__["optimize_parameters"]
            self._undo.append((cls, "optimize_parameters", step))
            cls.optimize_parameters = timed(step)

        def counted_val(model, loader, current_iter, save_img=False,
                        tb_logger=None):
            before = self._counts()
            self.tb = tb_logger
            val(model, loader, current_iter, save_img, tb_logger)
            self.val_counts.append({k: v - before[k] for k, v in
                                    self._counts().items()})
            self.val_images.append(len(loader))
            self.psnr.append(model.metric_results["psnr"])

        def logged_reset(optimizer):
            self.resets.append(self._iter)
            reset(optimizer)

        m.SRModel.validation = counted_val
        e.reset_momentum = logged_reset
        return self

    @property
    def losses(self) -> list:
        return [lg["l_pix"] for lg in self.logs]

    def __exit__(self, *exc):
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)


def first_step_loss(net_opt: dict, state: dict, batch: dict, device: str,
                    seed: int | None = None) -> float:
    """The L1 loss of the first step's forward in float32 on ``device``:
    with ``seed``, in training mode with the same drop-path draws (the
    SRModel runner's generator is a CPU one seeded with manual_seed + 1;
    a network whose forward takes no generator runs without it, as the
    runner's step does); without, deterministic, as ESRModel's step
    runs."""
    import inspect

    import torch

    from super_resolution_tpu_torch.models import build_network

    net = build_network(net_opt)
    net.load_state_dict(state, strict=True)
    net = net.to(device).train(seed is not None)
    lq = torch.from_numpy(batch["lq"]).to(device)
    gt = torch.from_numpy(batch["gt"]).to(device)
    with torch.no_grad():
        if seed is None or "generator" not in inspect.signature(
                net.forward).parameters:
            sr = net(lq)
        else:
            sr = net(lq, generator=torch.Generator().manual_seed(seed + 1))
        return float((sr - gt).abs().mean())


def _state_diff(a: dict, b: dict):
    import torch

    return torch.cat([(a[k].float() - v.float()).abs().flatten()
                      for k, v in b.items() if v.is_floating_point()])


def train_path(label: str, spec: dict, sets: dict, root: str,
               card: str) -> dict:
    """Phases 6 (b), (c) and 7 (b): ``train.py``'s pipeline on an unedited
    training option file, but for its data roots, total_iter, val_freq,
    save_checkpoint_freq, print_freq, a pretrained network where it names
    one and, where ``spec`` says so, a smaller batch, through the CLI's
    entry: TRAIN_ITERS steps with validation and a checkpoint every
    TRAIN_EVERY; then a run resumed from net_g_3 to the end, held against
    the uninterrupted one. Options ``spec['added']`` names are added to the
    loaded file (a copy under ``root``) and logged. Checked: finite losses,
    the first step's loss against the float32 forward on the host CPU
    (float32) or on the card (bf16), the checkpoints strict-loadable, the
    launches a step and an eval image, the momentum resets and the start of
    MESA where the strategy has them. Returns the uninterrupted run's launch
    counts."""
    import torch
    import yaml

    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline
    from super_resolution_tpu_torch.utils.options import yaml_load

    yml = spec["yml"]
    opt = yaml_load(yml)
    added = spec.get("added") or {}
    if added:
        for key, value in added.items():
            node = opt
            *parents, last = key.split(":")
            for k in parents:
                node = node[k]
            node[last] = value
        yml = os.path.join(root, f"{label}.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(opt, f)
        log(f"  added to {spec['yml']}: {added}")
    net = opt["network_g"]
    esr = opt["model_type"] == "ESRModel"
    amp = bool(opt.get("use_amp") if esr else opt["train"].get("use_amp"))
    batch = spec["batch"] or opt["datasets"]["train"]["batch_size_per_gpu"]
    force = [f"{key}={sets[name]}" for key, name in spec["roots"].items()]
    force += [f"train:total_iter={TRAIN_ITERS}", f"val:val_freq={TRAIN_EVERY}",
              f"logger:save_checkpoint_freq={TRAIN_EVERY}",
              "logger:print_freq=1",
              f"datasets:train:batch_size_per_gpu={batch}"]
    if opt["path"].get("pretrain_network_g"):
        force.append("path:pretrain_network_g=~")
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    runs = {}
    for run in ("whole", "resumed"):
        run_root = os.path.join(root, label, run)
        argv = ["-opt", yml, "--device", "cuda", "--force_yml", *force]
        if run == "resumed":
            ckpt = os.path.join(root, label, "whole", "experiments",
                                opt["name"], "models", f"net_g_{TRAIN_EVERY}")
            argv += [f"path:resume_state={ckpt}"]
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TrainClock(fns) as clock:
            model, last = train_pipeline(run_root, argv=argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[run] = dict(clock=clock, model=model, wall=wall, peak=peak,
                         counts={n: fn.launches for n, fn in fns.items()})
        if last != TRAIN_ITERS or not np.isfinite(clock.losses).all():
            raise AssertionError(f"{label} {run}: last iteration {last}, "
                                 f"losses {clock.losses}")
        steps = clock.steps
        later = statistics.median(steps[1:]) if len(steps) > 1 else steps[0]
        extra = (f"; l_mesa {[round(lg['l_mesa'], 6) for lg in clock.logs]}"
                 f"; momentum resets at {clock.resets}"
                 if "mesa_opt" in opt["train"] else "")
        log(f"[train:{label}] {card}: {run} run, batch {batch}, "
            f"{len(steps)} steps: first {steps[0]:.3f} s, then "
            f"{later:.3f} s a step (median), {batch / later:.2f} images a "
            f"second; peak memory {peak:.2f} GiB; wall {wall:.1f} s; "
            f"losses {[round(v, 6) for v in clock.losses]}{extra}; PSNR "
            f"{[round(float(v), 4) for v in clock.psnr]}; tensorboard "
            f"{'a SummaryWriter' if clock.tb is not None else 'missing'}")
    whole, resumed = runs["whole"], runs["resumed"]

    # the launches a step and an eval image
    per_step, per_image = spec["per_step"], spec["per_image"]
    mesa_from = spec.get("mesa_from")
    for it, counts in enumerate(whole["clock"].step_counts, start=1):
        got = {k: v for k, v in counts.items() if v}
        want = (per_step if mesa_from is None or it < mesa_from
                else {k: 2 * v for k, v in per_step.items()})
        if got != want:
            raise AssertionError(f"{label}: step {it} launched {got}, "
                                 f"expected {want}")
    for counts, n in zip(whole["clock"].val_counts,
                         whole["clock"].val_images):
        got = {k: v / n for k, v in counts.items() if v}
        if got != per_image:
            raise AssertionError(f"{label}: an eval image launched {got}, "
                                 f"expected {per_image}")
    log(f"  launches a step {per_step}"
        f"{'' if mesa_from is None else f', twice from MESA at {mesa_from}'}"
        f"; an eval image {per_image}; the run "
        f"{ {k: v for k, v in whole['counts'].items() if v} }")

    # the strategy's events: resets every reset_momentum_iter, MESA's loss
    # 0 before its start and above 0 from it, in both runs
    every = opt["train"].get("reset_momentum_iter")
    if every or mesa_from is not None:
        for run, first in (("whole", 1), ("resumed", TRAIN_EVERY + 1)):
            clock = runs[run]["clock"]
            iters = range(first, TRAIN_ITERS + 1)
            want = [i for i in iters if every and i % every == 0]
            mesa = [lg["l_mesa"] > 0 for lg in clock.logs]
            if (clock.resets != want
                    or mesa != [i >= mesa_from for i in iters]):
                raise AssertionError(f"{label} {run}: resets "
                                     f"{clock.resets}, MESA on {mesa}")

    # the first step's loss against a float32 forward on the same batch,
    # weights and drop-path draws
    clock = whole["clock"]
    t0 = time.perf_counter()
    seed = None if esr else opt["manual_seed"]
    device = "cuda" if amp else "cpu"
    ref = first_step_loss(net, clock.first_state, clock.first_batch, device,
                          seed)
    rtol, where = ((2e-2, "float32 on the card") if amp
                   else (1e-4, "float32 on the host CPU"))
    log(f"  first step's loss {clock.losses[0]:.6f} against {ref:.6f}, "
        f"{where} ({time.perf_counter() - t0:.1f} s)")
    if abs(clock.losses[0] - ref) > rtol * abs(ref):
        raise AssertionError(f"{label}: first loss {clock.losses[0]} vs "
                             f"{ref}")

    # the checkpoints load strict into a runner of the file's options
    models = whole["model"].opt["path"]["models"]
    names = sorted(os.listdir(models))
    if names != [f"net_g_{TRAIN_EVERY}", f"net_g_{TRAIN_ITERS}"]:
        raise AssertionError(f"{label}: checkpoints {names}")
    for name in names:
        runner = build_model(dict(whole["model"].opt, path=dict(
            whole["model"].opt["path"],
            pretrain_network_g=os.path.join(models, name))), "cuda")
        del runner

    # resumed from net_g_3: the same losses, weights and EMA as the whole
    # run, within the card's run-to-run spread (its convolutions' backward
    # sums in no fixed order)
    lr = opt["train"]["optim_g"]["lr"]
    tail = whole["clock"].losses[TRAIN_EVERY:]
    diffs = _state_diff(resumed["model"].net_g.state_dict(),
                        whole["model"].net_g.state_dict())
    ema_diffs = _state_diff(resumed["model"].state.ema.state_dict(),
                            whole["model"].state.ema.state_dict())
    mean_diff, ema_diff = float(diffs.mean()), float(ema_diffs.mean())
    log(f"  resumed from net_g_{TRAIN_EVERY}: losses "
        f"{[round(v, 6) for v in resumed['clock'].losses]} against "
        f"{[round(v, 6) for v in tail]}; weights mean |diff| "
        f"{mean_diff:.3e}, max {float(diffs.max()):.3e}, EMA mean |diff| "
        f"{ema_diff:.3e} (lr {lr})")
    loss_rtol = 2e-2 if amp else 1e-3
    if (len(resumed["clock"].losses) != len(tail) or not np.allclose(
            resumed["clock"].losses, tail, rtol=loss_rtol)
            or mean_diff > lr / 100 or ema_diff > lr / 100):
        raise AssertionError(f"{label}: the resumed run left the whole "
                             f"one")
    counts = whole["counts"]
    del runs, whole, resumed, clock
    torch.cuda.empty_cache()
    return counts


def run_train_path(label: str, spec: dict, sets: dict, root: str,
                   card: str) -> dict:
    """:func:`train_path` with its banner and time."""
    t0 = time.perf_counter()
    batch = (f"batch {spec['batch']}" if spec["batch"]
             else "the file's batch")
    log(f"[train:{label}] train pipeline -> {spec['yml']}, {batch}, the "
        f"file's data roots and the iterations of its checks overridden")
    counts = train_path(label, spec, sets, root, card)
    log(f"[train:{label}] done in {time.perf_counter() - t0:.1f} s")
    return counts


# ---------------------------------------------------------------- phase 7
# ESC x4's train step (options/esc/train/ESC_DIV2K_X4.yml: batch 16, gt 256,
# LQ 64 x 64, so 2 x 2 windows of 32 an image) and the fork's HAT x2
# (train_HAT_SRx2_from_scratch.yml at batch 8, gt 128, LQ 64 x 64)
ESC_STEP = dict(b=16, lq=64, dim=64, heads=4)
ESC_XL_STEP_B = 2
FORK_STEP_B = 8
# the launches a step: ESC x4 and ESC-FP x4 have 5 blocks, each one
# fused_attention (twice under MESA: the EMA network's forward); the fork's
# HAT x2 runs fused_ocab_attention in each of its 6 OCABs, with rows 6 to 8
# as the x4 files; the ImageNet file's HAT x2 has fused_ocab_block there
_ESC_STEP = {"fused_attention": 5}
_ESC2 = {"fused_attention": 2}
_FORK2_STEP = {"ln_split": 1, "gated_dconv_ffn_block": 1,
               "fused_ocab_attention": 2, "mlp_block": 2}
_FORK2_IMAGE = {"ln_split": 12, "gated_dconv_ffn_block": 12,
                "fused_ocab_attention": 2, "mlp_block": 2}
_ESC_ROOTS = {"datasets:train:dataroot_gt": "train_gt",
              "datasets:train:dataroot_lq": "train_lq"}
for _i in range(1, 6):
    _ESC_ROOTS[f"datasets:val_{_i}:dataroot_gt"] = "val_gt"
    _ESC_ROOTS[f"datasets:val_{_i}:dataroot_lq"] = "val_lq"
_X2_VAL = {"datasets:val:dataroot_gt": "val2_gt",
           "datasets:val:dataroot_lq": "val2_lq"}
# the ESC strategy's options that no shipped file sets, added to
# ESC_DIV2K_X4.yml for esc_train_amp: MESA from int(0.67 * 6) = 4, a reset
# every 2 iterations, so that the resumed half holds both
ESC_STRATEGY = {"use_amp": True, "train:gradient_clip": 1.0,
                "train:reset_momentum_iter": 2,
                "train:mesa_opt": {"type": "L1Loss", "loss_weight": 1.0,
                                   "reduction": "mean", "start_ratio": 0.67}}
ESC_TRAIN_PATHS = {
    "esc_train_f32": dict(yml="options/esc/train/ESC_DIV2K_X4.yml",
                          batch=None, roots=_ESC_ROOTS, added=CUT_ESC,
                          per_step=_ESC2, per_image=_ESC2),
    "esc_train_amp": dict(yml="options/esc/train/ESC_DIV2K_X4.yml",
                          batch=None, roots=_ESC_ROOTS,
                          added={**ESC_STRATEGY, **CUT_ESC},
                          per_step=_ESC2, per_image=_ESC2,
                          mesa_from=4),
    "esc_dflip": dict(yml="options/esc/train/ESC_DFLIP_X4.yml", batch=None,
                      roots={k: v for k, v in _ESC_ROOTS.items()
                             if k != "datasets:train:dataroot_lq"},
                      added=CUT_ESC, per_step=_ESC2, per_image=_ESC2),
    "esc_fp_train": dict(yml="options/esc/train/ESC_FP_X4.yml", batch=None,
                         roots=_ESC_ROOTS, added=CUT_ESC,
                         per_step=_ESC2, per_image=_ESC2),
    # the file's batch of 32 does not fit in float32 without remat (about
    # 2.7 GiB of saved activations a sample)
    "fork_x2_train": dict(yml="options/train/train_HAT_SRx2_from_scratch.yml",
                          batch=FORK_STEP_B, roots={
                              "datasets:train:dataroot_gt": "train_gt",
                              "datasets:train:dataroot_lq": "train_lq2",
                              **_X2_VAL},
                          added=CUT_HAT, per_step=_FORK2_STEP,
                          per_image=_FORK2_IMAGE),
    "imagenet_train": dict(
        yml="options/train/train_HAT_SRx2_ImageNet_from_scratch.yml",
        batch=None, roots={"datasets:train:dataroot_gt": "train_gt",
                           "datasets:train:meta_info_file": "train_meta",
                           **_X2_VAL},
        added=CUT_HAT, per_step=_HAT2_STEP, per_image=_HAT2_IMAGE),
}


def esc_train_cases(dtype, seed: int) -> dict:
    """The operands of the four entries this phase adds, at a train step's
    shapes: name -> (ops module, entry, plain version, args, kwargs, shape
    note). Row 10 at ESC x4's step (q (64, 4, 1024, 16)); row 1 at window 16
    on the same images (ESC's route at windows up to 24: head dim 16, no
    mask); row 17 at ESC-XL's window 48 (dim 192, 12 heads, LQ 64 x 64
    padded to 96 x 96, batch ESC_XL_STEP_B: its plain backward holds
    (B, 4, 12, 2304, 2304) float32 scores); row 9 at the fork's HAT x2 step
    (B FORK_STEP_B, 64 x 64, C 180)."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops import cuda_window_attention as cw
    from super_resolution_tpu_torch.ops.attention import attention_with_bias

    rng = np.random.default_rng(seed)

    def t(*shape, s=1.0, dt=dtype):
        a = rng.standard_normal(shape).astype(np.float32) * s
        return torch.from_numpy(a).to("cuda", dt)

    b, lq, c, heads = (ESC_STEP[k] for k in ("b", "lq", "dim", "heads"))
    d = c // heads
    n10 = 32 * 32
    bw = b * (lq // 32) ** 2
    xl_c, xl_heads = ESC_XL["dim"], ESC_XL["num_heads"]
    fork_args, fork_kw, _, _ = kernel_cases(FORK_STEP_B, lq, dtype,
                                            seed)["fused_ocab_attention"]
    return {
        "fused_attention": (
            cw, "fused_attention_ad", attention_with_bias,
            (t(bw, heads, n10, d), t(bw, heads, n10, d), t(bw, heads, n10, d),
             t(heads, n10, n10, s=0.5, dt=torch.float32)),
            dict(scale=d ** -0.5), f"q {(bw, heads, n10, d)}"),
        "fused_msa_block": (
            ca, "fused_msa_block_ad",
            lambda *a, **k: ca.msa_block_reference(*a, None, **k),
            (t(b, lq, lq, c), t(c, 3 * c, s=c ** -0.5), t(3 * c, s=0.1),
             t(c, c, s=c ** -0.5), t(c, s=0.1),
             t(heads, 256, 256, s=0.5, dt=torch.float32)),
            dict(heads=heads, window_size=16, scale=d ** -0.5),
            f"x {(b, lq, lq, c)} window 16"),
        "msa_flash_attention": (
            cw, "msa_flash_attention_ad", cw.msa_qtile_reference,
            (t(ESC_XL_STEP_B, 96, 96, 3 * xl_c, s=0.5),
             t(xl_heads, 2304, 2304, s=0.5, dt=torch.float32)),
            dict(heads=xl_heads, window_size=48,
                 scale=(xl_c // xl_heads) ** -0.5),
            f"qkv {(ESC_XL_STEP_B, 96, 96, 3 * xl_c)} window 48"),
        "fused_ocab_attention": (
            ca, "fused_ocab_attention_ad", ca.ocab_attention_reference,
            fork_args, fork_kw, f"q {tuple(fork_args[0].shape)}"),
    }


def check_esc_train_functions() -> None:
    """Phase 7 (a): the four autograd entries ESC training and the fork's
    HAT x2 add (rows 10, 1, 17, 9), at a train step's shapes, float32 (TF32
    off) and bf16 (:func:`check_autograd_entry`)."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        for name, (mod, ad_name, plain, args, kw, what) in \
                esc_train_cases(dtype, seed=70).items():
            check_autograd_entry(getattr(mod, name), getattr(mod, ad_name),
                                 plain, args, kw, dtype, what)
            del args
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 8
# the four shipped real-world files: the fork's HAT x4 (every HAB fused: the
# runners' G runs deterministic, so rows 7, 8 in each of the 36 HABs, rows
# 5, 6 in each of the 6 OCABs) and ESCReal x4 (row 10 in each of its 10
# blocks); D and the VGG19 run no kernel of the port
# for the 1200 s limit the four files run 2 of their 6 RHAGs (ESC-Real 2 of
# its 10 blocks), as phases 6 and 7 do
_REAL_HAT_STEP = {"ln_split": 12, "gated_dconv_ffn_block": 12,
                  "fused_ocab_block": 2, "mlp_block": 2}
_REAL_ESC_STEP = {"fused_attention": 2}
REAL_TRAIN_PATHS = {
    "real_hat_mse": dict(
        yml="options/train/train_Real_HAT_SRx4_mse_model.yml",
        added=CUT_HAT, per_step=_REAL_HAT_STEP),
    "real_hat_gan": dict(
        yml="options/train/train_Real_HAT_GAN_SRx4_finetune_from_mse_model"
            ".yml", added=CUT_HAT, per_step=_REAL_HAT_STEP),
    "esc_real_mse": dict(yml="options/esc/train/ESC_Real_X4_MSE.yml",
                         added=CUT_ESC, per_step=_REAL_ESC_STEP),
    "esc_real_gan": dict(yml="options/esc/train/ESC_Real_X4_GAN.yml",
                         added=CUT_ESC, per_step=_REAL_ESC_STEP),
}
# synthetic GT images for the real-world dataset: sides from 400 to 480, so
# that its crop to the 400 canvas runs, 12 of them (ESC-Real's batch)
REAL_IMAGES, REAL_ITERS, REAL_EVERY = 12, 4, 2
# the synthesizer on the card against the CPU: the LQ within 1e-4, but for
# pixels one 8-bit level away (the chain ends in a rounding to 1/255), at
# most 0.5 % of them
SYNTH_ATOL, SYNTH_LEVEL_SHARE = 1e-4, 0.005


def write_real_gt(root: str) -> str:
    """REAL_IMAGES seeded smooth-plus-noise GT PNGs, 400 to 480 a side."""
    from super_resolution_tpu_torch.utils.img import imwrite

    out = os.path.join(root, "real_gt")
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(8)
    for i in range(REAL_IMAGES):
        h, w = 400 + 8 * (i % 11), 480 - 8 * (i % 7)
        yy, xx = np.mgrid[0:h, 0:w] / 40.0
        base = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                   + xx[..., None] * rng.uniform(0.5, 2)
                                   + np.arange(3))
        gt = np.clip(base + rng.normal(0, 0.04, base.shape), 0, 1)
        imwrite((gt * 255).round().astype(np.uint8),
                os.path.join(out, f"{i:04d}.png"))
    return out


def _synth_batch(n: int, seed: int) -> dict:
    """A loader batch of the real-world dataset's form at its canvas."""
    from super_resolution_tpu_torch.data.degradations import (
        circular_lowpass_kernel, random_mixed_kernels)

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:400, 0:400] / 40.0
    gt = np.stack([0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                       + xx[..., None] * rng.uniform(0.5, 2)
                                       + np.arange(3)) for _ in range(n)])
    kinds = ["iso", "aniso", "generalized_iso", "generalized_aniso",
             "plateau_iso", "plateau_aniso"]
    prob = [0.45, 0.25, 0.12, 0.03, 0.12, 0.03]

    def kernels(sigma):
        return np.stack([random_mixed_kernels(kinds, prob, 21, sigma, sigma,
                                              rng=rng) for _ in range(n)])

    return {"gt": gt.astype(np.float32),
            "kernel1": kernels((0.2, 3)).astype(np.float32),
            "kernel2": kernels((0.2, 1.5)).astype(np.float32),
            "sinc_kernel": np.stack([circular_lowpass_kernel(
                rng.uniform(np.pi / 3, np.pi), 21) for _ in range(n)])
            .astype(np.float32)}


def check_synth_card_vs_cpu() -> None:
    """Phase 8 (a): the degradation synthesizer of the shipped GAN file
    (its noise ranges at 0, its JPEG qualities fixed at 60 and 85, so the
    chain is deterministic) on the card against the CPU, four batches of 4
    at the canvas 400 -> gt 256, one seed; and its ms a batch on the
    card."""
    import torch

    from super_resolution_tpu_torch.runtime.realgan import \
        DegradationSynthesizer
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(REAL_TRAIN_PATHS["real_hat_gan"]["yml"])
    opt.update(noise_range=[0, 0], noise_range2=[0, 0],
               poisson_scale_range=[0, 0], poisson_scale_range2=[0, 0],
               jpeg_range=[60, 60], jpeg_range2=[85, 85])
    synth = {d: DegradationSynthesizer(opt, 3, d) for d in ("cpu", "cuda")}
    worst, share, ms = 0.0, 0.0, []
    for i in range(4):
        batch = _synth_batch(4, seed=i)
        out = {}
        for d in ("cpu", "cuda"):
            args = [torch.from_numpy(batch[k]).to(d) for k in
                    ("gt", "kernel1", "kernel2", "sinc_kernel")]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[d] = synth[d](*args)
            torch.cuda.synchronize()
            if d == "cuda":
                ms.append(1e3 * (time.perf_counter() - t0))
        diff = (out["cuda"][0].cpu() - out["cpu"][0]).abs()
        off = diff > SYNTH_ATOL
        worst = max(worst, float(diff.max()))
        share = max(share, float(off.float().mean()))
        lq_size = opt["gt_size"] // opt["scale"]
        if (tuple(out["cuda"][0].shape) != (4, lq_size, lq_size, 3)
                or float(diff.max()) > 1 / 255 + SYNTH_ATOL
                or not bool(((diff[off] - 1 / 255).abs()
                             <= SYNTH_ATOL).all())
                or float(off.float().mean()) > SYNTH_LEVEL_SHARE
                or not torch.equal(out["cuda"][1].cpu(), out["cpu"][1])):
            raise AssertionError(f"synthesizer batch {i}: card against "
                                 f"CPU max {float(diff.max())}, share "
                                 f"{float(off.float().mean())}")
    log(f"[real] synthesizer, card against CPU (noise 0, JPEG 60 / 85, 4 "
        f"batches of 4, 400 -> LQ 64): max |diff| {worst:.3e}, share of "
        f"pixels one 8-bit level away {share:.4f} (tolerance {SYNTH_ATOL} "
        f"and {SYNTH_LEVEL_SHARE}); card {[round(v, 2) for v in ms]} ms a "
        f"batch (the first with the card's first calls)")


class RealClock:
    """While a real-world run goes, wraps the runners: each iteration's
    seconds, logs and launches, the synthesizer's and the G and D steps'
    seconds (to a synchronised card), and the first iteration's weights,
    spectral-norm state and (lq, gt, gt_usm)."""

    def __init__(self, fns: dict):
        self.fns = fns

    def _counts(self) -> dict:
        return {name: fn.launches for name, fn in self.fns.items()}

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.runtime import realgan as r

        self.iters, self.logs, self.counts = [], [], []
        self.parts = {"synth": [], "g": [], "d": []}
        self.first = None
        cls = r.RealHATGANModel
        # the G and D steps are realgan's module functions, which the
        # runner's iteration looks up at each call
        self._undo = [(cls, "optimize_parameters",
                       cls.__dict__["optimize_parameters"]),
                      (r, "gan_g_step", r.gan_g_step),
                      (r, "gan_d_step", r.gan_d_step),
                      (r.DegradationSynthesizer, "__call__",
                       r.DegradationSynthesizer.__call__)]

        def timed(fn, key):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.parts[key].append(time.perf_counter() - t0)
                return out
            return run

        step = cls.optimize_parameters

        def timed_iteration(model, batch, current_iter):
            first = self.first is None
            if first:
                self.first = {"g": {k: v.detach().cpu().clone() for k, v in
                                    model.net_g.state_dict().items()},
                              "d": None if model.net_d is None else {
                                  k: v.detach().cpu().clone() for k, v in
                                  model.net_d.state_dict().items()}}
            before = self._counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, batch, current_iter)
            torch.cuda.synchronize()
            self.iters.append(time.perf_counter() - t0)
            self.logs.append(model.get_current_log())
            self.counts.append({k: v - before[k] for k, v in
                                self._counts().items() if v - before[k]})
            if first:
                self.first.update(lq=model.lq.cpu(), gt=model.gt.cpu(),
                                  gt_usm=model.gt_usm.cpu())

        cls.optimize_parameters = timed_iteration
        r.gan_g_step = timed(self._undo[1][2], "g")
        r.gan_d_step = timed(self._undo[2][2], "d")
        r.DegradationSynthesizer.__call__ = timed(self._undo[3][2], "synth")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)


def real_first_losses_on_cpu(model, first: dict) -> dict:
    """The first iteration's losses recomputed on the host CPU, in float32,
    forward only, from the run's first weights, spectral-norm state and
    synthesized batch: G's forward and losses (D's spectral norm moved by
    its fake pass), then D's real and fake passes, as the runner's step
    orders them (runtime/realgan.py)."""
    import torch

    from super_resolution_tpu_torch.losses import build_loss
    from super_resolution_tpu_torch.models import build_network

    opt, train = model.opt, model.opt["train"]
    net = build_network(opt["network_g"])
    net.load_state_dict(first["g"], strict=True)
    lq, gt, gt_usm = first["lq"], first["gt"], first["gt_usm"]
    l1_gt = gt_usm if model.l1_gt_usm else gt
    percep_gt = gt_usm if model.percep_gt_usm else gt
    gan_gt = gt_usm if model.gan_gt_usm else gt
    out = {}
    with torch.no_grad():
        sr = net.eval()(lq)
        out["l_g_pix"] = float(build_loss(train["pixel_opt"])(sr, l1_gt))
        total = out["l_g_pix"]
        if train.get("perceptual_opt"):
            p, _ = build_loss(train["perceptual_opt"])(sr, percep_gt)
            out["l_g_percep"] = float(p)
            total += out["l_g_percep"]
        if model.net_d is not None:
            d = build_network(opt["network_d"])
            d.load_state_dict(first["d"], strict=True)
            gan = build_loss(train["gan_opt"])
            out["l_g_gan"] = float(gan(d(sr, update_sn_stats=True), True))
            total += out["l_g_gan"]
            real = d(gan_gt, update_sn_stats=True)
            fake = d(sr, update_sn_stats=True)
            out.update(l_d_real=float(gan(real, True, is_disc=True)),
                       l_d_fake=float(gan(fake, False, is_disc=True)),
                       out_d_real=float(real.mean()),
                       out_d_fake=float(fake.mean()))
        out["l_g_total"] = total
    return out


def real_train_path(label: str, spec: dict, gt_root: str, vgg: str,
                    root: str, card: str) -> dict:
    """Phase 8 (b): a shipped real-world file through ``train.py``'s
    pipeline on the card at its published widths and batch, overridden in
    a copy (logged): the depth (``spec['added']``), the GT root, no
    pretrained G, the VGG19 .pth, a queue
    of two batches (so the pool's swap runs from the third iteration),
    total_iter, the checkpoint and print frequencies. REAL_ITERS
    iterations with a checkpoint every REAL_EVERY, then a run resumed from
    the first checkpoint. Checked: finite losses; the first iteration's
    losses against the host CPU's (:func:`real_first_losses_on_cpu`); the
    launches an iteration; that D and its spectral-norm ``u`` moved; the
    resumed run against the uninterrupted one. Returns the whole run's
    launch counts."""
    import torch
    import yaml

    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(spec["yml"])
    batch = opt["datasets"]["train"]["batch_size_per_gpu"]
    overrides = {"datasets:train:dataroot_gt": gt_root,
                 "path:pretrain_network_g": None,
                 "queue_size": 2 * batch,
                 "train:total_iter": REAL_ITERS,
                 "logger:save_checkpoint_freq": REAL_EVERY,
                 "logger:print_freq": 1, **spec["added"]}
    if opt["train"].get("perceptual_opt"):
        overrides["train:perceptual_opt:vgg_weights_path"] = vgg
    if "val" in opt["datasets"]:
        overrides["datasets:val:dataroot_lq"] = gt_root
    for key, value in overrides.items():
        node = opt
        *parents, last = key.split(":")
        for k in parents:
            node = node[k]
        node[last] = value
    yml = os.path.join(root, f"{label}.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(opt, f)
    log(f"  overrides of {spec['yml']}: {overrides}")
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    runs = {}
    for run in ("whole", "resumed"):
        argv = ["-opt", yml, "--device", "cuda"]
        if run == "resumed":
            ckpt = os.path.join(root, label, "whole", "experiments",
                                opt["name"], "models", f"net_g_{REAL_EVERY}")
            argv += ["--force_yml", f"path:resume_state={ckpt}"]
        for fn in fns.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with RealClock(fns) as clock:
            model, last = train_pipeline(os.path.join(root, label, run),
                                         argv=argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[run] = dict(clock=clock, model=model,
                         counts={n: fn.launches for n, fn in fns.items()})
        totals = [lg["l_g_total"] for lg in clock.logs]
        if last != REAL_ITERS or not np.isfinite(totals).all():
            raise AssertionError(f"{label} {run}: last iteration {last}, "
                                 f"losses {totals}")
        it = clock.iters
        later = statistics.median(it[1:]) if len(it) > 1 else it[0]
        parts = {k: (1e3 * statistics.median(v[1:] if len(v) > 1 else v)
                     if v else 0.0) for k, v in clock.parts.items()}
        log(f"[real:{label}] {card}: {run} run, {type(model).__name__}, "
            f"batch {batch}, {len(it)} iterations: first {it[0]:.3f} s, "
            f"then {later:.3f} s an iteration (median), "
            f"{batch / later:.2f} images a second; synthesizer "
            f"{parts['synth']:.1f} ms, G step {parts['g']:.1f} ms, D step "
            f"{parts['d']:.1f} ms (medians; the synthesizer "
            f"{100 * parts['synth'] / (1e3 * later):.1f} % of an "
            f"iteration); peak memory {peak:.2f} GiB; wall {wall:.1f} s; "
            f"l_g_total {[round(v, 6) for v in totals]}")
    whole, resumed = runs["whole"], runs["resumed"]
    clock, model = whole["clock"], whole["model"]

    # the launches an iteration: G's forward, once
    for i, counts in enumerate(clock.counts, start=1):
        if counts != spec["per_step"]:
            raise AssertionError(f"{label}: iteration {i} launched "
                                 f"{counts}, expected {spec['per_step']}")
    log(f"  launches an iteration {spec['per_step']}; the run "
        f"{ {k: v for k, v in whole['counts'].items() if v} }")

    # the first iteration's losses against the host CPU's
    t0 = time.perf_counter()
    ref = real_first_losses_on_cpu(model, clock.first)
    got = clock.logs[0]
    worst = max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in ref.items())
    log(f"  first iteration on the card {dict(sorted(got.items()))}; on "
        f"the host CPU {dict(sorted(ref.items()))}: max rel diff "
        f"{worst:.2e} ({time.perf_counter() - t0:.1f} s)")
    if sorted(ref) != sorted(k for k in got if k in ref) or worst > 1e-3:
        raise AssertionError(f"{label}: first losses {got} vs {ref}")

    # D and its spectral-norm state moved
    if model.net_d is not None:
        end = model.net_d.state_dict()
        moved = {k: float((end[k].cpu() - v).abs().max())
                 for k, v in clock.first["d"].items()}
        u_moved = min(v for k, v in moved.items() if k.endswith("weight_u"))
        w_moved = min(v for k, v in moved.items() if k.endswith("weight")
                      and "weight_" not in k)
        log(f"  D moved: every weight by at least {w_moved:.3e}, every "
            f"spectral-norm u by at least {u_moved:.3e}")
        if not (u_moved > 0 and w_moved > 0):
            raise AssertionError(f"{label}: D did not move: {moved}")

    # resumed from net_g_REAL_EVERY: the uninterrupted run's losses and
    # weights, within the card's run-to-run spread
    lr = opt["train"]["optim_g"]["lr"]
    tail = [lg["l_g_total"] for lg in clock.logs[REAL_EVERY:]]
    again = [lg["l_g_total"] for lg in resumed["clock"].logs]
    nets = [("G", model.net_g, resumed["model"].net_g),
            ("EMA", model.state.ema, resumed["model"].state.ema)]
    if model.net_d is not None:
        nets.append(("D", model.net_d, resumed["model"].net_d))
    means = {n: float(_state_diff(b.state_dict(), a.state_dict()).mean())
             for n, a, b in nets}
    log(f"  resumed from net_g_{REAL_EVERY}: l_g_total "
        f"{[round(v, 6) for v in again]} against "
        f"{[round(v, 6) for v in tail]}; mean |diff| {means} (lr {lr})")
    if (len(again) != len(tail) or not np.allclose(again, tail, rtol=1e-3)
            or max(means.values()) > lr / 100):
        raise AssertionError(f"{label}: the resumed run left the whole "
                             f"one")
    counts = whole["counts"]
    del runs, whole, resumed, clock, model
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 9
# HATX x2 (options/train/train_HAT_SRx2_ESC_OCAB_from_scratch.yml: embed
# 180, 6 x 6 HABXs, ESC OCAB with focus bias and top-k 0.6, batch 2, gt 128,
# tile validation 64 / 16): no kernel (JAX routes none of HATX to Pallas).
# Its paired train set reads the synthetic pairs through a meta_info_file
# that lists their GT names, as the file's DF2K-sub one does.
HATX_YML = "options/train/train_HAT_SRx2_ESC_OCAB_from_scratch.yml"
HATX_TRAIN_PATHS = {
    "hatx_train": dict(yml=HATX_YML, batch=None, roots={
        "datasets:train:dataroot_gt": "train_gt",
        "datasets:train:dataroot_lq": "train_lq2",
        "datasets:train:meta_info_file": "train_meta", **_X2_VAL},
        per_step={}, per_image={}),
}
# HybridHATNAF's stem ahead of the file's HATX, on one 64 x 64 image
NAF_STEM = dict(naf_width=64, naf_blocks=4)


def check_hybrid_hat_naf(card: str) -> dict:
    """Phase 9: one HybridHATNAF forward (NAF stem, then HATX at the HATX
    file's widths; seeded weights, float32) on the card against the host
    CPU. OCABX's top-k is discrete: a key whose score lies within rounding
    of the threshold may be kept on one device and not on the other, so the
    bound is 1e-3 of the output's scale, not TOL_F32."""
    import torch

    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.utils.options import yaml_load

    net = dict(yaml_load(HATX_YML)["network_g"])
    hat = {k: v for k, v in net.items()
           if k not in ("type", "upscale", "window_size")}
    model = build_network(dict(type="HybridHATNAF", **NAF_STEM,
                               window_size=net["window_size"],
                               upscale=net["upscale"], hat_kwargs=hat))
    init_weights(model, torch.Generator().manual_seed(9))
    model.eval()
    x = torch.from_numpy(np.random.default_rng(9).random(
        (1, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        ref = model(x)
        model.cuda()
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = model(x.cuda())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v - before[k] for k, v in _counts().items()}
    err = float((got.cpu() - ref).abs().max())
    tol = 1e-3 * max(1.0, float(ref.abs().max()))
    log(f"[hatx] {card}: HybridHATNAF (stem {NAF_STEM}, HATX of "
        f"{HATX_YML}) 1 x 64 x 64 float32: card against the host CPU max "
        f"|diff| {err:.3e} (tol {tol:.1e}), PSNR {psnr(got.cpu().numpy(), ref.numpy()):.2f} dB, "
        f"{ms:.1f} ms on the card")
    launched = {k: v for k, v in counts.items() if v}
    if not (torch.isfinite(got).all() and err <= tol and not launched
            and tuple(got.shape) == (1, 128, 128, 3)):
        raise AssertionError(f"HybridHATNAF: err {err}, shape "
                             f"{tuple(got.shape)}, launches {launched} "
                             f"(it runs no kernel)")
    del model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- phase 10
# the autograd entries of the arb encoders' training, at the shapes a step
# of their files gives them (batch 32; SwinIR: LQ 48 x 48, C 60 in 6 heads
# of 10, window 8, shift 4, MLP hidden 120: its unshifted blocks, shifted
# blocks and MLP tails, rows 1, 2 and 6; ATD-light: LQ 64 x 64, C 48 in 4
# heads, window 16, shifted; HiT-SRF: LQ 64 x 64, C 60 in 6 heads at
# windows 8 and 64 on base 8). Rows 1 and 6 had their entries before; the
# other three are new.
ARB_STEP_B = 32


def arb_entry_cases(dtype, seed: int) -> list:
    """(ops module, wrapper, entry, plain version, args, kwargs, shape
    note) of the entries' checks; row 14's operands as :func:`scc_inputs`
    draws them."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops import cuda_ffn as cf
    from super_resolution_tpu_torch.ops import cuda_scc as cs
    from super_resolution_tpu_torch.ops import cuda_window_attention as cw
    from super_resolution_tpu_torch.ops.attention import \
        shift_attn_mask_tensor

    t = _device_randn(dtype, seed)
    b = ARB_STEP_B
    cases = []
    c, heads, ws, hw = 60, 6, 8, 48
    swin = f"SwinIR encoder B{b} {hw}x{hw} C{c}"

    def msa_operands():
        return (t(b, hw, hw, c), t(c, 3 * c, s=c ** -0.5), t(3 * c, s=0.1),
                t(c, c, s=c ** -0.5), t(c, s=0.1),
                t(heads, 64, 64, s=0.5, dt=torch.float32))
    cases.append((ca, "fused_msa_block", "fused_msa_block_ad",
                  lambda *a, **k: ca.msa_block_reference(*a, None, **k),
                  msa_operands(), dict(heads=heads, window_size=ws),
                  f"{swin} unshifted"))
    cases.append((ca, "fused_msa_block_shifted",
                  "fused_msa_block_shifted_ad", ca.msa_block_shifted_reference,
                  (*msa_operands(),
                   shift_attn_mask_tensor(hw, hw, ws, 4, "cuda")),
                  dict(heads=heads, window_size=ws, shift=4),
                  f"{swin} shifted"))
    cases.append((cf, "mlp_block", "mlp_block_ad", cf.mlp_block_reference,
                  (t(b, hw, hw, c), 1.0 + t(c, s=0.1), t(c, s=0.1),
                   t(c, 2 * c, s=c ** -0.5), t(2 * c, s=0.1),
                   t(2 * c, c, s=(2 * c) ** -0.5), t(c, s=0.1)), {},
                  f"{swin} hidden {2 * c}"))
    c, heads, ws, hw = 48, 4, 16, 64
    cases.append((cw, "fused_msa_attention", "fused_msa_attention_ad",
                  cw.msa_attention_reference,
                  (t(b, hw, hw, 3 * c, s=0.5),
                   t(heads, 256, 256, s=0.5, dt=torch.float32)),
                  dict(mask=shift_attn_mask_tensor(hw, hw, ws, 8, "cuda"),
                       heads=heads, window_size=ws),
                  f"ATD-light encoder B{b} {hw}x{hw} C{c} shifted"))
    c, heads, hw = 60, 6, 64
    for win in (8, 64):
        cases.append((cs, "fused_scc_block", "fused_scc_block_ad",
                      cs.scc_block_reference, scc_inputs(
                          dtype, seed + win, (b, hw, hw, c, heads),
                          (win, win), (8, 8)),
                      dict(heads=heads, window_size=(win, win), base=(8, 8)),
                      f"HiT-SRF encoder B{b} {hw}x{hw} C{c} window {win}"))
    return cases


def check_arb_train_functions() -> None:
    """Phase 10 (a): the autograd entries of rows 1, 2, 6, 12 and 14 at the
    arb encoders' steps' shapes, float32 (TF32 off) and bf16
    (:func:`check_autograd_entry`)."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        for mod, name, ad_name, plain, args, kw, what in arb_entry_cases(
                dtype, seed=10):
            check_autograd_entry(getattr(mod, name), getattr(mod, ad_name),
                                 plain, args, kw, dtype, what)
            del args
            torch.cuda.empty_cache()


def _lte(encoder: dict) -> dict:
    """LTE over ``encoder`` as the LTE training files build it."""
    return {"name": "lte", "args": {
        "encoder_spec": encoder, "imnet_spec": {
            "name": "mlp", "args": {"out_dim": 3,
                                    "hidden_list": [256, 256, 256]}}}}


# every encoder at its published width (the JAX fields' defaults, which the
# training files keep) under LTE, and the launches of one forward: ESC's 5
# blocks one fused_attention each; SwinIR's 4 RSTBs of 6 blocks; ATD-light's
# 4 ATDBs of 6 layers; HiT-SRF's 4 groups of 6 blocks
ARB_ENCODERS = {
    "esc": {"fused_attention": 5},
    "edsr-baseline": {},
    "swinir": dict(zip(_SWIN, (12, 12, 24))),
    "rdn": {},
    "rcan": {},
    "ATDLight": {"fused_msa_attention": 24},
    "HiTSRF": {"fused_scc_block": 24},
}
# the encoders' forward: one 64 x 64 LR image queried at x3 (192 x 192)
ARB_LR, ARB_SCALE = 64, 3


def _counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()
            if name in KERNELS}


def arb_encoder_path(name: str, card: str) -> dict:
    """Phase 10 (b): LTE over one encoder at its published width, seeded
    weights, in float32 and with the encoder in bf16
    (``utils/precision.py``: a cast copy, bf16 activations, float32
    features into the head), two forwards each (the first's launches
    counted, the second timed). Checked: the launches of a forward; the
    encoder's bf16 features against its float32 ones at least PSNR_MIN_DB
    over the float32 features' peak (the LTE output adds the bilinear
    input skip, which would hide them), and the outputs likewise. Returns
    one float32 forward's launches."""
    import copy

    import torch

    from super_resolution_tpu_torch import arb
    from super_resolution_tpu_torch.arb.models import make_coord
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.utils.precision import (cast_floating,
                                                            wrap_apply)

    model = arb.make(_lte({"name": name, "args": {}}))
    init_weights(model, torch.Generator().manual_seed(10))
    model = model.cuda().eval()
    rng = np.random.default_rng(10)
    hq = ARB_LR * ARB_SCALE
    inp = torch.from_numpy(rng.random((1, ARB_LR, ARB_LR, 3),
                                      dtype=np.float32)).cuda()
    coord = torch.from_numpy(make_coord((hq, hq))[None]).cuda()
    cell = torch.full_like(coord, 2.0 / hq)

    class Bf16Trunk(torch.nn.Module):
        def __init__(self, enc):
            super().__init__()
            self.enc = cast_floating(enc, torch.bfloat16)

        def forward(self, x):
            return wrap_apply(self.enc, torch.bfloat16)(x)

    half = copy.deepcopy(model)
    half.encoder = Bf16Trunk(model.encoder)
    outs, feats = {}, {}
    with torch.no_grad():
        for label, net in (("float32", model), ("bf16", half)):
            before = _counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[label] = net(inp, coord, cell)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            launched = {k: v - before[k] for k, v in _counts().items()
                        if v - before[k]}
            if label == "float32":
                counts = {k: v - before[k] for k, v in _counts().items()}
            t0 = time.perf_counter()
            net(inp, coord, cell)
            torch.cuda.synchronize()
            second = (time.perf_counter() - t0) * 1e3
            feats[label] = net.encoder(inp).float()
            log(f"[arb:{name}] {card}: LTE over {name}, LR {ARB_LR}x"
                f"{ARB_LR} queried at x{ARB_SCALE}, {label}: {first:.1f} ms "
                f"the first call, {second:.1f} ms the second, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                f"launches {launched}")
            if launched != ARB_ENCODERS[name]:
                raise AssertionError(f"arb {name} {label}: launched "
                                     f"{launched}, expected "
                                     f"{ARB_ENCODERS[name]}")
    fa, fb = (feats[k].cpu().numpy() for k in ("float32", "bf16"))
    peak = float(np.abs(fa).max())
    feat_db = 10.0 * float(np.log10(peak ** 2 / np.mean((fb - fa) ** 2)))
    a, b = (outs[k].float().cpu().numpy().reshape(hq, hq, 3)
            for k in ("float32", "bf16"))
    db = psnr(b, a)
    log(f"  bf16 against float32: features {feat_db:.2f} dB over their "
        f"peak {peak:.3f}, output PSNR {db:.2f} dB; output finite "
        f"{bool(np.isfinite(a).all())}, shape {tuple(outs['float32'].shape)}")
    if not (np.isfinite(a).all() and min(db, feat_db) >= PSNR_MIN_DB):
        raise AssertionError(f"arb {name}: bf16 PSNR {db}, features "
                             f"{feat_db}")
    del model, half, outs, feats
    torch.cuda.empty_cache()
    return counts


def _arb_yml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# eval_arb: LIIF over SwinIR (train_swinir-liif.yml's model, no_upsampling
# dropped), float32; launches an image: one encoder forward
ARB_EVAL_MODEL = "options/arb/train-div2k/train_swinir-liif.yml"
ARB_EVAL_FILES = ("options/arb/test/test-fast-set5-4.yml",
                  "options/arb/test/test-div2k-4.yml")
ARB_EVAL_BSIZE = 30000
# synthetic DIV2K validation pairs for test-div2k-4 (GT sides, LR at x4)
ARB_DIV2K = [(256, 320), (240, 200)]


def _spec_without_no_upsampling(config: dict) -> dict:
    """The file's model spec, ``no_upsampling`` dropped from its encoder's
    args where the encoder has no such field (ESC, RDN and SwinIR; in JAX
    neither: ROADMAP queue 3)."""
    import copy
    import inspect

    from super_resolution_tpu_torch.arb.models import models

    spec = copy.deepcopy(config["model"])
    enc = spec["args"]["encoder_spec"]
    if "no_upsampling" not in inspect.signature(
            models[enc["name"]].__init__).parameters:
        enc.get("args", {}).pop("no_upsampling", None)
    return spec


def arb_eval_path(sets: dict, root: str, card: str) -> dict:
    """Phase 10 (c): ``eval_arb`` on test-fast-set5-4.yml (the synthetic
    Set5 and its '<name>x4' LR) in one call, then the same chunked at
    ARB_EVAL_BSIZE queries, equal to 1e-3 dB; and test-div2k-4.yml on
    synthetic DIV2K pairs chunked at ARB_EVAL_BSIZE (the file's 500000
    would take an image in one chunk). Both files' PairedImageDataset reads
    a ``scale`` the files lack, in JAX too: ``scale: 4`` is added. Returns
    the launches of the three runs."""
    import torch

    from super_resolution_tpu_torch import arb
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.utils.img import imwrite
    from super_resolution_tpu_torch.utils.matlab import imresize

    spec = _spec_without_no_upsampling(_arb_yml(ARB_EVAL_MODEL))
    model = arb.make(spec)
    init_weights(model, torch.Generator().manual_seed(11))
    div2k = {k: os.path.join(root, "arb_div2k", k) for k in ("HR", "X4")}
    rng = np.random.default_rng(11)
    for i, (h, w) in enumerate(ARB_DIV2K):
        yy, xx = np.mgrid[0:h, 0:w] / 48.0
        img = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                  + xx[..., None] * rng.uniform(0.5, 2)
                                  + np.arange(3))
        img = (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
        lq = np.clip(imresize(img.astype(np.float32) / 255.0, 0.25), 0, 1)
        imwrite(img, os.path.join(div2k["HR"], f"{i:04d}.png"))
        imwrite((lq * 255).round().astype(np.uint8),
                os.path.join(div2k["X4"], f"{i:04d}x4.png"))
    roots = {ARB_EVAL_FILES[0]: (sets["gt"], sets["lq_x4"]),
             ARB_EVAL_FILES[1]: (div2k["HR"], div2k["X4"])}
    start = _counts()
    results = {}
    for yml in ARB_EVAL_FILES:
        config = _arb_yml(yml)
        gt, lq = roots[yml]
        config["test_dataset"]["dataset"].update(dataroot_gt=gt,
                                                 dataroot_lq=lq, scale=4)
        chunked = dict(config, fast_eval=False, eval_bsize=ARB_EVAL_BSIZE)
        runs = ([("one call", config)] if config.get("fast_eval") else [])
        runs.append(("chunked", chunked))
        for how, cfg in runs:
            before = _counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            value = arb.eval_arb(cfg, model, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {k: v - before[k] for k, v in _counts().items()
                        if v - before[k]}
            results[(yml, how)] = value
            log(f"[arb:eval] {card}: {yml} (scale: 4 added to its "
                f"dataset) {how}"
                f"{f' at {ARB_EVAL_BSIZE} queries' if how == 'chunked' else ''}"
                f": PSNR {value:.4f} dB, {wall:.2f} s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
                f"launches {launched}")
            if not np.isfinite(value) or not launched:
                raise AssertionError(f"eval_arb {yml} {how}: PSNR {value}, "
                                     f"launches {launched}")
    one, chunked = (results[(ARB_EVAL_FILES[0], k)]
                    for k in ("one call", "chunked"))
    if abs(one - chunked) > 1e-3:
        raise AssertionError(f"eval_arb: one call {one} dB, chunked "
                             f"{chunked} dB")
    del model
    torch.cuda.empty_cache()
    return {k: v - start[k] for k, v in _counts().items()}


# train_arb: the five files JAX trains, and three whose encoder specs carry
# no_upsampling, dropped (logged); each at its own batch, 3 iterations (one
# epoch over 3 batches of synthetic GT images of 256 x 256)
ARB_TRAIN = {
    "train_edsr-baseline-liif.yml": {},
    "train_edsr-baseline-lte.yml": {},
    "train_edsr-baseline-metasr.yml": {},
    "train_atd-lte.yml": {"fused_msa_attention": 24},
    "train_hitsrf-lte.yml": {"fused_scc_block": 24},
    "train_esc-lte.yml": {"fused_attention": 5},
    "train_rdn-metasr.yml": {},
    "train_swinir-lte.yml": dict(zip(_SWIN, (12, 12, 24))),
}
ARB_TRAIN_ITERS, ARB_GT = 3, 256
# for the 1200 s limit the files of batch 32 train at 16 (their first loss is
# recomputed on the host CPU at that batch, which at 32 more than doubles
# the phase)
ARB_BATCH_MAX = 16


def arb_batch(config: dict) -> int:
    """The batch a train_arb file runs at here: its own, at most
    ARB_BATCH_MAX."""
    return min(config["train_dataset"]["batch_size"], ARB_BATCH_MAX)
# the first loss on the card (float32, TF32 off) against the host CPU's
ARB_LOSS_RTOL = 1e-4


def write_arb_gt(root: str) -> dict:
    """3 x the largest batch of synthetic GT images, ARB_GT a side, and a
    meta_info_file for each batch size listing 3 batches of them."""
    from super_resolution_tpu_torch.utils.img import imwrite

    batches = sorted({arb_batch(_arb_yml(f"options/arb/train-div2k/{f}"))
                      for f in ARB_TRAIN})
    gt = os.path.join(root, "arb_gt")
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:ARB_GT, 0:ARB_GT] / 40.0
    names = []
    for i in range(ARB_TRAIN_ITERS * batches[-1]):
        img = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                  + xx[..., None] * rng.uniform(0.5, 2)
                                  + np.arange(3))
        img = np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1)
        names.append(f"{i:04d}.png")
        imwrite((img * 255).round().astype(np.uint8),
                os.path.join(gt, names[-1]))
    metas = {}
    for b in batches:
        metas[b] = os.path.join(root, f"arb_meta_{b}.txt")
        with open(metas[b], "w") as f:
            f.writelines(f"{n} ({ARB_GT},{ARB_GT},3)\n"
                         for n in names[:ARB_TRAIN_ITERS * b])
    return dict(gt=gt, metas=metas)


class ArbClock:
    """While train_arb runs: the end of every optimizer step (to a
    synchronised card), the launches of each step, the first batch (as the
    loader gave it) and the parameters before the first update."""

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.data import TrainLoader

        self.ends, self.step_counts = [], []
        self.first_batch = self.first_params = None
        self._step = torch.optim.Adam.step
        self._epoch_iter = TrainLoader.epoch_iter
        clock = self

        def timed(opt, *a, **kw):
            if clock.first_params is None:
                clock.first_params = [p.detach().cpu().clone()
                                      for g in opt.param_groups
                                      for p in g["params"]]
            before = clock._last
            out = clock._step(opt, *a, **kw)
            torch.cuda.synchronize()
            clock.ends.append(time.perf_counter())
            clock._last = _counts()
            clock.step_counts.append({k: v - before[k] for k, v in
                                      clock._last.items() if v - before[k]})
            return out

        def kept(loader, *a, **kw):
            for batch in clock._epoch_iter(loader, *a, **kw):
                if clock.first_batch is None:
                    clock.first_batch = {k: np.array(v) for k, v in
                                         batch.items()
                                         if isinstance(v, np.ndarray)}
                yield batch
        torch.optim.Adam.step = timed
        TrainLoader.epoch_iter = kept
        self._last = _counts()
        torch.cuda.synchronize()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        from super_resolution_tpu_torch.data import TrainLoader

        torch.optim.Adam.step = self._step
        TrainLoader.epoch_iter = self._epoch_iter


def arb_first_loss_on_cpu(config: dict, params: list, batch: dict) -> float:
    """train_arb's first loss recomputed on the host CPU in float32: the
    file's model with the parameters the card held before its first update
    (in ``model.parameters()`` order, as the optimizer holds them), on the
    first batch; the buffers from the seeded initialisation train_arb
    makes."""
    import torch

    from super_resolution_tpu_torch.arb.models import make
    from super_resolution_tpu_torch.models.arch_util import init_weights

    model = make(config["model"])
    init_weights(model, torch.Generator().manual_seed(config.get("seed", 0)))
    own = list(model.parameters())
    if [p.shape for p in own] != [p.shape for p in params]:
        raise AssertionError("arb: the card's parameters do not match the "
                             "model's")
    with torch.no_grad():
        for p, v in zip(own, params):
            p.copy_(v)
        data = {k: torch.from_numpy(v) for k, v in batch.items()}
        pred = model.train()(data["inp"], data["coord"], data["cell"])
        return float((pred - data["gt"]).abs().mean())


def arb_train_path(name: str, data: dict, root: str, card: str) -> dict:
    """Phase 10 (d): ``train_arb`` on a shipped file (a copy: its GT root
    and the meta file of 3 batches, epoch_max 1, epoch_save 1; no_upsampling
    dropped where its encoder lacks the field), at its batch (at most
    ARB_BATCH_MAX), on the card.
    Checked: 3 finite losses, the first of them against the host CPU's
    on the same batch and weights within ARB_LOSS_RTOL, the launches a step
    (one forward's: the backward runs the plain versions), the checkpoints.
    Printed: s an iteration, peak memory. Returns the run's launches."""
    import torch

    from super_resolution_tpu_torch.arb.train import train_arb
    from super_resolution_tpu_torch.runtime.checkpoint import STATE_FILE

    yml = f"options/arb/train-div2k/{name}"
    config = _arb_yml(yml)
    spec = _spec_without_no_upsampling(config)
    dropped = spec != config["model"]
    config["model"] = spec
    ds = config["train_dataset"]
    batch = ds["batch_size"] = arb_batch(config)
    ds["dataset"] = dict(ds["dataset"], dataroot_gt=data["gt"],
                         meta_info_file=data["metas"][batch])
    config.update(epoch_max=1, epoch_save=1)
    config.pop("val_dataset", None)
    log(f"[arb:{name}] train_arb -> {yml}, batch {batch} (the file's "
        f"{_arb_yml(yml)['train_dataset']['batch_size']}), inp_size "
        f"{ds.get('inp_size')}, sample_q {ds.get('sample_q')}; overridden: "
        f"the GT root, a meta_info_file of {ARB_TRAIN_ITERS} batches, "
        f"epoch_max 1, epoch_save 1"
        f"{'; no_upsampling dropped from the encoder spec' if dropped else ''}")
    start = _counts()
    save = os.path.join(root, "arb_exp", name[:-4])
    torch.cuda.reset_peak_memory_stats()
    with ArbClock() as clock:
        _, losses = train_arb(config, save, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = np.diff([clock.start] + clock.ends)
    later = float(np.median(steps[1:]))
    log(f"[arb:{name}] {card}: {len(losses)} iterations, first "
        f"{steps[0]:.3f} s (set-up and loading included), then "
        f"{later:.3f} s an iteration (median), {batch / later:.2f} images "
        f"a second; peak memory {peak:.2f} GiB; losses "
        f"{[round(v, 6) for v in losses]}; launches a step "
        f"{clock.step_counts}")
    cpu = arb_first_loss_on_cpu(config, clock.first_params,
                                clock.first_batch)
    rel = abs(losses[0] - cpu) / abs(cpu)
    log(f"  first loss: card {losses[0]:.8f}, host CPU {cpu:.8f} on the "
        f"same batch and weights, relative diff {rel:.3e} (tol "
        f"{ARB_LOSS_RTOL:.0e})")
    want = ARB_TRAIN[name]
    saved = sorted(os.listdir(save))
    if (len(losses) != ARB_TRAIN_ITERS or not np.isfinite(losses).all()
            or not rel <= ARB_LOSS_RTOL
            or any(c != want for c in clock.step_counts)
            or saved != ["epoch-1", "epoch-last"]
            or not os.path.exists(os.path.join(save, "epoch-last",
                                               STATE_FILE))):
        raise AssertionError(f"arb {name}: losses {losses} (the first on "
                             f"the host CPU {cpu}), launches "
                             f"{clock.step_counts} (expected {want}), "
                             f"checkpoints {saved}")
    torch.cuda.empty_cache()
    return {k: v - start[k] for k, v in _counts().items()}


# --------------------------------------------------------------- phase 11
# training on the kernel routes phases 6 to 10 leave out: the autograd
# entries of rows 3, 4, 13, 15, 16, 18 and the bare gated FFN at the shapes
# the train steps below give them; train.py's SR runner on each network
# whose training reaches them, from train_HAT_SRx4_from_scratch.yml with
# network_g swapped (batch ROUTE_B, gt 256, so LQ 64 x 64); then the paired
# GAN runners and an ESRModel file with a perceptual loss
ROUTE_YML = "options/train/train_HAT_SRx4_from_scratch.yml"
ROUTE_B, ROUTE_ITERS = 4, 3
# SRFormer x4's step: LQ 64 x 64 padded to 72 x 72 (windows of 24)
PSA_STEP = (ROUTE_B, 72, 72, 180, 6, 24)
# ESC-XL x4's step: LQ 64 x 64 padded to 96 x 96 (windows of 48)
QTILE_STEP = (ROUTE_B, 96, 96, 192, 12, 48)
# the classic HAT's two routes train at 2 of their 6 RHAGs (the run's
# time limit); their launches scale with the depth
_TRAIN_CLASSIC = dict({k: v for k, v in CLASSIC.items()
                       if k != "stream_tail_rows"},
                      depths=[6, 6], num_heads=[HEADS, HEADS])
# label -> network_g (None: the file's own, the fork's HAT x4), the launches
# a step at drop-path rate 0, and those of one extra step at rate 0.1 (None:
# the network has no drop path). At 0.1 only the network's first block
# keeps its whole kernel route; the others keep their attention kernel
# (classic HAT, SwinIR, SRFormer) or none (the fork's HAB runs unfused)
ROUTE_TRAIN_PATHS = {
    "route_classic": dict(
        net=_TRAIN_CLASSIC,
        per_step={"fused_msa_block": 6, "fused_msa_block_shifted": 6,
                  "mlp_block_sum3": 6, "mlp_block_sum3_shifted": 6,
                  "fused_ocab_block": 2, "mlp_block": 2},
        per_step_dp={"fused_msa_block": 6, "fused_msa_block_shifted": 6,
                     "mlp_block_sum3": 1, "fused_ocab_block": 2,
                     "mlp_block": 2}),
    "route_classic_hab_block": dict(
        net=dict(_TRAIN_CLASSIC, hab_route="fused_hab_block"),
        per_step={"fused_hab_block": 6, "fused_msa_block_shifted": 6,
                  "mlp_block_sum3_shifted": 6, "fused_ocab_block": 2,
                  "mlp_block": 2},
        per_step_dp={"fused_hab_block": 1, "fused_msa_block": 5,
                     "fused_msa_block_shifted": 6, "fused_ocab_block": 2,
                     "mlp_block": 2}),
    "route_srformer": dict(net=SRFORMER, per_step={"fused_psa_block": 36},
                           per_step_dp={"fused_psa_block": 36}),
    "route_swinir": dict(net=SWINIR, per_step=dict(zip(_SWIN, (18, 18, 36))),
                         per_step_dp=dict(zip(_SWIN, (18, 18, 1)))),
    # ESC-XL cut to 2 of its 8 blocks: its first loss on the host CPU took
    # 50.7 s of the run's time limit at full depth
    "route_esc_xl_qtile": dict(
        net=dict(ESC_XL, attn_route="msa_qtile_attention", n_blocks=2),
        per_step={"msa_qtile_attention": 2}, per_step_dp=None),
    "route_fork_hab_front": dict(
        net=None, per_step={"hab_front": 36, "gated_dconv_ffn_block": 36,
                            "fused_ocab_block": 6, "mlp_block": 6},
        per_step_dp={"hab_front": 1, "gated_dconv_ffn_block": 1,
                     "fused_ocab_block": 6, "mlp_block": 6}),
}
# BasicSR's train_SRGAN_x4.yml and train_ESRGAN_x4.yml, their networks,
# losses and optimizers as published (no pretrained G: seeded weights),
# on RealESRGANPairedDataset over a meta_info of the synthetic pairs
GAN_B, GAN_ITERS, GAN_GT = 16, 3, 128
_GAN_TRAIN = {
    "optim_g": {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                "betas": [0.9, 0.99]},
    "optim_d": {"type": "Adam", "lr": 1e-4, "weight_decay": 0,
                "betas": [0.9, 0.99]},
    "scheduler": {"type": "MultiStepLR",
                  "milestones": [50000, 100000, 200000, 300000],
                  "gamma": 0.5},
    "total_iter": GAN_ITERS, "warmup_iter": -1,
    "pixel_opt": {"type": "L1Loss", "loss_weight": 1e-2,
                  "reduction": "mean"},
    "perceptual_opt": {"type": "PerceptualLoss",
                       "layer_weights": {"conv5_4": 1}, "vgg_type": "vgg19",
                       "use_input_norm": True, "range_norm": False,
                       "perceptual_weight": 1.0, "style_weight": 0,
                       "criterion": "l1"},
    "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                "real_label_val": 1.0, "fake_label_val": 0.0,
                "loss_weight": 5e-3},
    "net_d_iters": 1, "net_d_init_iters": 0}
GAN_TRAIN_PATHS = {
    "srgan_x4": dict(model_type="SRGANModel", train=_GAN_TRAIN,
                     net=dict(type="MSRResNet", num_in_ch=3, num_out_ch=3,
                              num_feat=64, num_block=16, upscale=4)),
    "esrgan_x4": dict(model_type="ESRGANModel",
                      train=dict(_GAN_TRAIN, ema_decay=0.999),
                      net=dict(type="RRDBNet", num_in_ch=3, num_out_ch=3,
                               num_feat=64, num_block=23, num_grow_ch=32)),
}
GAN_D = dict(type="VGGStyleDiscriminator", num_in_ch=3, num_feat=64)
# ESRModel with perceptual_opt: options/esc/train/ESC_DIV2K_X4.yml with the
# VGG19 loss of the GAN files added, at batch 4 (cut from the file's 16:
# the host CPU recomputes the first step's VGG19 on 256 x 256 images)
ESR_PERCEP_YML = "options/esc/train/ESC_DIV2K_X4.yml"
ESR_PERCEP_B = 4


def route_entry_cases(dtype, seed: int) -> list:
    """(ops module, wrapper, entry, plain version, args, kwargs, shape
    note) of the entries this phase adds, at the steps' shapes: rows 3, 4,
    15, the bare gated FFN and row 18 at the flagship HAT's (ROUTE_B, 64,
    64, 180) (:func:`kernel_cases`), row 13 at SRFormer's PSA_STEP without
    and with the shift mask, row 16 at ESC-XL's QTILE_STEP."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_ffn as cf
    from super_resolution_tpu_torch.ops import cuda_hab as ch
    from super_resolution_tpu_torch.ops import cuda_hab_block as chb
    from super_resolution_tpu_torch.ops import cuda_psa as cp
    from super_resolution_tpu_torch.ops import cuda_window_attention as cw

    hat = kernel_cases(ROUTE_B, 64, dtype, seed)
    what = f"HAT x4 step B{ROUTE_B} 64x64 C{C}"
    cases = [(mod, name, f"{name}_ad", plain, *hat[name][:2], what)
             for mod, name, plain in (
                 (cf, "mlp_block_sum3", cf.mlp_block_sum3_reference),
                 (cf, "mlp_block_sum3_shifted",
                  cf.mlp_block_sum3_shifted_reference),
                 (chb, "fused_hab_block", chb.hab_block_reference),
                 (cf, "gated_dconv_ffn", cf.ffn_reference),
                 (ch, "hab_front", ch.hab_front_reference))]
    for label, (_, args, kw, *_) in psa_block_cases(dtype, seed,
                                                    PSA_STEP).items():
        cases.append((cp, "fused_psa_block", "fused_psa_block_ad",
                      cp.psa_block_reference, args[:7],
                      dict(kw, mask=args[7]),
                      f"SRFormer x4 step {label} x {PSA_STEP[:4]}"))
    t = _device_randn(dtype, seed)
    b, h, w, c, heads, ws = QTILE_STEP
    cases.append((cw, "msa_qtile_attention", "msa_qtile_attention_ad",
                  cw.msa_qtile_reference,
                  (t(b, h, w, 3 * c, s=0.5),
                   t(heads, ws * ws, ws * ws, s=0.5, dt=torch.float32)),
                  dict(heads=heads, window_size=ws),
                  f"ESC-XL x4 step qkv {(b, h, w, 3 * c)} window {ws}"))
    return cases


def check_route_train_functions() -> None:
    """Phase 11 (a): the entries of :func:`route_entry_cases`, float32 (TF32
    off) and bf16 (:func:`check_autograd_entry`: forward and every input's
    gradient against the plain version under autograd, one launch a
    forward, forward + backward ms, the plain version's, peak memory)."""
    import torch

    for dtype in (torch.float32, torch.bfloat16):
        for mod, name, ad_name, plain, args, kw, what in route_entry_cases(
                dtype, seed=110):
            check_autograd_entry(getattr(mod, name), getattr(mod, ad_name),
                                 plain, args, kw, dtype, what)
            del args
            torch.cuda.empty_cache()


def _write_yml(opt: dict, root: str, label: str) -> str:
    import yaml

    path = os.path.join(root, f"{label}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def _rate(clock_steps: list, batch: int) -> str:
    later = (statistics.median(clock_steps[1:]) if len(clock_steps) > 1
             else clock_steps[0])
    return (f"first {clock_steps[0]:.3f} s, then {later:.3f} s a step "
            f"(median), {batch / later:.2f} images a second")


def route_train_path(label: str, spec: dict, sets: dict, root: str,
                     card: str) -> dict:
    """Phase 11 (b): ``train.py``'s pipeline on ROUTE_YML with network_g
    swapped (drop-path rate 0), batch ROUTE_B, its validation dropped,
    ROUTE_ITERS steps on the synthetic pairs, float32 (TF32 off). Checked:
    finite losses, the launches each step, the first loss against the host
    CPU's float32 forward (1e-4 relative). Then one more step at drop-path
    rate 0.1 through the same runner class on the run's last weights: its
    launches and a finite loss. Returns the run's launch counts."""
    import torch

    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(ROUTE_YML)
    opt["name"] = label
    if spec["net"] is not None:
        opt["network_g"] = dict(spec["net"])
    else:
        opt["network_g"]["front_route"] = "hab_front"
    if spec["per_step_dp"] is not None:
        opt["network_g"]["drop_path_rate"] = 0.0
    opt.pop("val")
    opt["datasets"].pop("val")
    opt["datasets"]["train"].update(dataroot_gt=sets["train_gt"],
                                    dataroot_lq=sets["train_lq"],
                                    batch_size_per_gpu=ROUTE_B)
    opt["train"]["total_iter"] = ROUTE_ITERS
    opt["logger"].update(print_freq=1, save_checkpoint_freq=10 ** 6,
                         use_tb_logger=False)
    yml = _write_yml(opt, root, label)
    net = opt["network_g"]
    log(f"[route:{label}] train pipeline -> {ROUTE_YML} with network_g "
        f"{net}, batch {ROUTE_B}, {ROUTE_ITERS} steps, no validation")
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with TrainClock(fns) as clock:
        model, last = train_pipeline(os.path.join(root, label),
                                     argv=["-opt", yml, "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {n: fn.launches for n, fn in fns.items()}
    if last != ROUTE_ITERS or not np.isfinite(clock.losses).all():
        raise AssertionError(f"{label}: last iteration {last}, losses "
                             f"{clock.losses}")
    for it, step_counts in enumerate(clock.step_counts, start=1):
        got = {k: v for k, v in step_counts.items() if v}
        if got != spec["per_step"]:
            raise AssertionError(f"{label}: step {it} launched {got}, "
                                 f"expected {spec['per_step']}")
    log(f"[route:{label}] {card}: TF32 off, batch {ROUTE_B}: "
        f"{_rate(clock.steps, ROUTE_B)}; peak memory {peak:.2f} GiB; wall "
        f"{wall:.1f} s; losses {[round(v, 6) for v in clock.losses]}; "
        f"launches a step {spec['per_step']}")
    t0 = time.perf_counter()
    ref = first_step_loss(net, clock.first_state, clock.first_batch, "cpu",
                          opt["manual_seed"])
    log(f"  first step's loss {clock.losses[0]:.6f} against {ref:.6f}, "
        f"float32 on the host CPU ({time.perf_counter() - t0:.1f} s)")
    if abs(clock.losses[0] - ref) > 1e-4 * abs(ref):
        raise AssertionError(f"{label}: first loss {clock.losses[0]} vs "
                             f"{ref}")
    if spec["per_step_dp"] is not None:
        state = {k: v.detach().clone() for k, v in
                 model.net_g.state_dict().items()}
        run_opt = dict(model.opt, network_g=dict(net, drop_path_rate=0.1))
        del model
        torch.cuda.empty_cache()
        runner = build_model(run_opt, "cuda")
        runner.net_g.load_state_dict(state, strict=True)
        runner.setup_training()
        before = {n: fn.launches for n, fn in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.optimize_parameters(clock.first_batch, 1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {n: fn.launches - before[n] for n, fn in fns.items()
               if fn.launches - before[n]}
        loss = float(runner.get_current_log()["l_pix"])
        log(f"  one step at drop-path rate 0.1: launches {got}, loss "
            f"{loss:.6f}, {secs:.3f} s (its first)")
        if got != spec["per_step_dp"] or not np.isfinite(loss):
            raise AssertionError(f"{label}: the step at rate 0.1 launched "
                                 f"{got}, expected {spec['per_step_dp']}; "
                                 f"loss {loss}")
        counts = {n: fn.launches for n, fn in fns.items()}
        del runner
    else:
        del model
        log("  no extra step: the network has no drop path")
    torch.cuda.empty_cache()
    return counts


def write_gan_meta(sets: dict, root: str) -> str:
    """A RealESRGANPairedDataset meta_info over the synthetic x4 pairs:
    'gt_rel, lq_rel' a line."""
    path = os.path.join(root, "gan_meta_info.txt")
    names = sorted(os.listdir(sets["train_gt"]))
    with open(path, "w") as f:
        f.writelines(f"{n}, {n}\n" for n in names)
    return path


def gan_train_path(label: str, spec: dict, sets: dict, meta: str, vgg: str,
                   root: str, card: str) -> dict:
    """Phase 11 (c): ``train.py``'s pipeline with ``model_type`` SRGANModel
    or ESRGANModel (RealHATGANModel without the synthesizer) at BasicSR's
    published widths, losses and optimizers, on RealESRGANPairedDataset
    over ``meta``, batch GAN_B, gt GAN_GT, GAN_ITERS iterations, float32
    (TF32 off). Checked: finite losses; the first iteration's G and D
    losses against the host CPU's (:func:`real_first_losses_on_cpu`; the
    mean logits, which lie near 0 at D's seeded init, to 1e-4 absolute);
    that D moved; no kernel launched (the CNNs and D run in cuDNN, as in
    JAX). Returns the launch counts."""
    import torch

    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline

    train = json.loads(json.dumps(spec["train"]))
    train["perceptual_opt"]["vgg_weights_path"] = vgg
    opt = {"name": label, "model_type": spec["model_type"], "scale": 4,
           "num_gpu": 1, "manual_seed": 0,
           "datasets": {"train": {
               "name": "synthetic", "type": "RealESRGANPairedDataset",
               "dataroot_gt": sets["train_gt"],
               "dataroot_lq": sets["train_lq"], "meta_info": meta,
               "io_backend": {"type": "disk"}, "gt_size": GAN_GT,
               "use_hflip": True, "use_rot": True,
               "batch_size_per_gpu": GAN_B, "dataset_enlarge_ratio": 1}},
           "network_g": dict(spec["net"]), "network_d": dict(GAN_D),
           "path": {"pretrain_network_g": None, "strict_load_g": True,
                    "resume_state": None},
           "train": train,
           "logger": {"print_freq": 1, "save_checkpoint_freq": 10 ** 6,
                      "use_tb_logger": False}}
    yml = _write_yml(opt, root, label)
    log(f"[gan:{label}] train pipeline -> {spec['model_type']} "
        f"{spec['net']} against {GAN_D}, batch {GAN_B}, gt {GAN_GT}, "
        f"{GAN_ITERS} iterations; VGG19: seeded random weights ({vgg})")
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with RealClock(fns) as clock:
        model, last = train_pipeline(os.path.join(root, label),
                                     argv=["-opt", yml, "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {n: fn.launches for n, fn in fns.items()}
    totals = [lg["l_g_total"] for lg in clock.logs]
    if (last != GAN_ITERS or not np.isfinite(totals).all()
            or type(model).__name__ != "RealHATGANModel" or model.high_order
            or any(counts.values())):
        raise AssertionError(f"{label}: last iteration {last}, losses "
                             f"{totals}, runner {type(model).__name__}, "
                             f"launches {counts}")
    parts = {k: 1e3 * statistics.median(v[1:] if len(v) > 1 else v)
             for k, v in clock.parts.items() if v}
    log(f"[gan:{label}] {card}: TF32 off, batch {GAN_B}: "
        f"{_rate(clock.iters, GAN_B)}; G step {parts['g']:.1f} ms, D step "
        f"{parts['d']:.1f} ms (medians); peak memory {peak:.2f} GiB; wall "
        f"{wall:.1f} s; l_g_total {[round(v, 6) for v in totals]}")
    t0 = time.perf_counter()
    ref = real_first_losses_on_cpu(model, clock.first)
    got = clock.logs[0]
    errs = {k: abs(got[k] - v) / (1.0 if k.startswith("out_d")
                                  else max(abs(v), 1e-12))
            for k, v in ref.items()}
    log(f"  first iteration on the card {dict(sorted(got.items()))}; on the "
        f"host CPU {dict(sorted(ref.items()))}: worst diff "
        f"{max(errs.values()):.2e} (relative; the mean logits absolute) "
        f"({time.perf_counter() - t0:.1f} s)")
    if sorted(ref) != sorted(got) or any(
            e > (1e-4 if k.startswith("out_d") else 1e-3)
            for k, e in errs.items()):
        raise AssertionError(f"{label}: first losses {got} vs {ref}")
    end = model.net_d.state_dict()
    moved = min(float((end[k].cpu() - v).abs().max())
                for k, v in clock.first["d"].items()
                if k.endswith("weight") and "bn" not in k)
    log(f"  D moved: every conv and linear weight by at least {moved:.3e}")
    if not moved > 0:
        raise AssertionError(f"{label}: D did not move")
    del model, clock
    torch.cuda.empty_cache()
    return counts


def esr_perceptual_path(sets: dict, vgg: str, root: str, card: str) -> dict:
    """Phase 11 (c): ESRModel with perceptual_opt through ``train.py``'s
    pipeline: ESR_PERCEP_YML with the GAN files' VGG19 loss added, batch
    ESR_PERCEP_B, its validation dropped, ROUTE_ITERS iterations, float32.
    Checked: finite losses, the launches a step, the first step's pixel and
    perceptual losses against the host CPU's (1e-4 relative). Returns the
    launch counts."""
    import torch

    from super_resolution_tpu_torch.losses import build_loss
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline
    from super_resolution_tpu_torch.utils.options import yaml_load

    label = "esr_perceptual"
    opt = yaml_load(ESR_PERCEP_YML)
    opt["name"] = label
    opt.pop("val", None)
    opt["datasets"] = {"train": dict(
        opt["datasets"]["train"], dataroot_gt=sets["train_gt"],
        dataroot_lq=sets["train_lq"], batch_size_per_gpu=ESR_PERCEP_B)}
    percep = dict(_GAN_TRAIN["perceptual_opt"], vgg_weights_path=vgg)
    opt["train"]["perceptual_opt"] = percep
    opt["train"]["total_iter"] = ROUTE_ITERS
    opt["path"]["pretrain_network_g"] = None
    opt["logger"].update(print_freq=1, save_checkpoint_freq=10 ** 6,
                         use_tb_logger=False)
    yml = _write_yml(opt, root, label)
    log(f"[esr:{label}] train pipeline -> {ESR_PERCEP_YML} with "
        f"perceptual_opt {percep} added, batch {ESR_PERCEP_B}, "
        f"{ROUTE_ITERS} steps, no validation")
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    with TrainClock(fns) as clock:
        model, last = train_pipeline(os.path.join(root, label),
                                     argv=["-opt", yml, "--device", "cuda"])
    counts = {n: fn.launches for n, fn in fns.items()}
    percs = [lg["l_percep"] for lg in clock.logs]
    if (last != ROUTE_ITERS or not np.isfinite(clock.losses + percs).all()
            or any({k: v for k, v in c.items() if v} != _ESC_STEP
                   for c in clock.step_counts)):
        raise AssertionError(f"{label}: last {last}, losses {clock.logs}, "
                             f"launches {clock.step_counts}")
    log(f"[esr:{label}] {card}: TF32 off, batch {ESR_PERCEP_B}: "
        f"{_rate(clock.steps, ESR_PERCEP_B)}; l_pix "
        f"{[round(v, 6) for v in clock.losses]}, l_percep "
        f"{[round(v, 6) for v in percs]}; launches a step {_ESC_STEP}")
    t0 = time.perf_counter()
    net = build_network(opt["network_g"])
    net.load_state_dict(clock.first_state, strict=True)
    lq, gt = (torch.from_numpy(clock.first_batch[k]) for k in ("lq", "gt"))
    with torch.no_grad():
        sr = net.eval()(lq)
        ref = {"l_pix": float(build_loss(opt["train"]["pixel_opt"])(sr, gt)),
               "l_percep": float(build_loss(percep)(sr, gt)[0])}
    got = {k: clock.logs[0][k] for k in ref}
    log(f"  first step {got} against {ref}, float32 on the host CPU "
        f"({time.perf_counter() - t0:.1f} s)")
    if any(abs(got[k] - v) > 1e-4 * abs(v) for k, v in ref.items()):
        raise AssertionError(f"{label}: first losses {got} vs {ref}")
    del model, clock
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- phase 12
# the rest of the evaluation surface. (a) test.py on HAT_tile_example.yml
# (the fork's HAT x4 at full width: embed 180, 6 x 6, window 16; tile 256 /
# pad 32, chunk 4; ocab_esc_enable off) with val: {bucketed_eval: true} and
# PSNR / SSIM added, over synthetic pairs: LR sides between 141 and 256 as
# Urban100 x4 gives, two pairs of each of two sizes (a bucket of two
# images), and one 300 x 400 LR of four tiles
BUCKET_YML = "options/test/HAT_tile_example.yml"
BUCKET_LR = {"u0": (141, 250), "u1": (141, 250), "u2": (190, 173),
             "u3": (190, 173), "u4": (256, 200), "u5": (225, 236),
             "u6": (300, 400)}
BUCKET_METRICS = {
    "psnr": {"type": "calculate_psnr", "crop_border": 4,
             "test_y_channel": True},
    "ssim": {"type": "calculate_ssim", "crop_border": 4,
             "test_y_channel": True}}
BUCKET_F32_TOL, BUCKET_BF16_MIN_DB = 1e-4, 45.0
# the kernel the traces of (a) and (d) must name: (a) runs bf16, on the
# tensor-core kernel; (d) trains float32, on the FMA kernel of row 7
TRACE_KERNEL = {"a": "mma_gated_dconv_ffn_kernel",
                "d": "gated_dconv_ffn_kernel"}
# (b) the x8 self-ensemble on HAT_SRx4.yml's network, one Set5 LR image
ENSEMBLE_YML, ENSEMBLE_IMAGE = "options/test/HAT_SRx4.yml", "butterfly"
# (d) three iterations of phase 6's float32 file on RawPack packs of phase
# 6's synthetic pairs, at phase 6's batch
RAWPACK_ITERS = 3


def write_bucket_pairs(root: str) -> dict:
    """BUCKET_LR's pairs under root: GT of 4 x the LR sides (seeded smooth
    content and noise, uint8) and the LR by area averaging at 1 / 4."""
    import cv2

    from super_resolution_tpu_torch.utils.img import imwrite

    dirs = {k: os.path.join(root, k) for k in ("bucket_gt", "bucket_lq")}
    rng = np.random.default_rng(12)
    for name, (h, w) in BUCKET_LR.items():
        yy, xx = np.mgrid[0:4 * h, 0:4 * w] / 96.0
        base = 0.5 + 0.35 * np.sin(yy[..., None] * rng.uniform(0.5, 2)
                                   + xx[..., None] * rng.uniform(0.5, 2)
                                   + np.arange(3))
        gt = np.clip(base + rng.normal(0, 0.04, base.shape), 0, 1)
        gt = (gt * 255).round().astype(np.uint8)
        imwrite(gt, os.path.join(dirs["bucket_gt"], f"{name}.png"))
        imwrite(cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA),
                os.path.join(dirs["bucket_lq"], f"{name}.png"))
    return dirs


def bucket_forwards(scale_ws: int, tile: dict, bucketed: bool) -> int:
    """Chunk forwards of BUCKET_LR through the runner: per image, or by
    buckets of the padded LR (runtime/batched_eval.py)."""
    from super_resolution_tpu_torch.runtime.batched_eval import group_images
    from super_resolution_tpu_torch.runtime.tile import _axis_plan

    padded = [(-(-h // scale_ws) * scale_ws, -(-w // scale_ws) * scale_ws)
              for h, w in BUCKET_LR.values()]
    if not bucketed:
        return sum(n_forwards(h, w, scale_ws, tile) for h, w in padded)
    ts, tp = tile["tile_size"], tile["tile_pad"]
    total = 0
    for idxs in group_images(padded, ts, tp).values():
        tiles = sum(_axis_plan(padded[i][0], ts, tp)[0]
                    * _axis_plan(padded[i][1], ts, tp)[0] for i in idxs)
        total += -(-tiles // min(tile["chunk"], tiles))
    return total


def trace_names(logdir: str, kernel: str) -> int:
    """The one Chrome trace under logdir: its kernel events whose name
    holds ``kernel`` (raises unless there is exactly one trace and it has
    some)."""
    traces = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"{logdir}: {len(traces)} traces, expected 1")
    with open(os.path.join(logdir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    hits = sum(1 for e in events if e.get("cat") == "kernel"
               and kernel in e.get("name", ""))
    size = os.path.getsize(os.path.join(logdir, traces[0])) / 2 ** 20
    log(f"  trace {traces[0]} ({size:.1f} MiB, {len(events)} events): "
        f"{hits} launches of {kernel}")
    if not hits:
        raise AssertionError(f"{logdir}: the trace names no {kernel}")
    return hits


def bucket_run(data: dict, pth: str, out_root: str, bucketed: bool,
               bf16: bool, profile: bool = False) -> dict:
    """One run of (a): test.py's pipeline on BUCKET_YML with the synthetic
    pairs, PSNR / SSIM and ``bucketed_eval`` set, on the card. Returns the
    results, each image's output on the host, the launch counts, the input
    shapes of each bucket's chunks, the wall and inference seconds (to a
    synchronised card) and the results directory."""
    import torch

    from super_resolution_tpu_torch.runtime import batched_eval
    from super_resolution_tpu_torch.runtime import sr_model as m
    from super_resolution_tpu_torch.runtime.test_pipeline import \
        test_from_yaml
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(BUCKET_YML)
    val = dict(opt["val"], bucketed_eval=bucketed, metrics=BUCKET_METRICS)
    extra = dict(inference_dtype="bf16") if bf16 else {}
    if profile:
        extra["logger"] = {"profile": {}}
    outputs, bucket_shapes, infer = [], [], []
    post, group = m.SRModel._validation_postprocess, \
        batched_eval.tile_forward_group
    run_one, run_all = m.HATModel._run_inference, \
        m.HATModel._bucketed_inference

    def timed(fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            infer.append(time.perf_counter() - t0)
            return out
        return call

    def keep(model, *a, **kw):
        outputs.append(model.output[0].float().cpu().numpy())
        return post(model, *a, **kw)

    def counted_group(apply_fn, imgs, *a, **kw):
        seen = set()

        def fwd(x):
            seen.add(tuple(x.shape))
            return apply_fn(x)
        out = group(fwd, imgs, *a, **kw)
        bucket_shapes.append(sorted(seen))
        return out

    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    m.SRModel._validation_postprocess = keep
    batched_eval.tile_forward_group = counted_group
    m.HATModel._run_inference = timed(run_one)
    m.HATModel._bucketed_inference = timed(run_all)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = test_from_yaml(
            BUCKET_YML, out_root, device="cuda", datasets={"test_1": data},
            val=val, path=dict(opt["path"], pretrain_network_g=pth), **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        m.SRModel._validation_postprocess = post
        batched_eval.tile_forward_group = group
        m.HATModel._run_inference = run_one
        m.HATModel._bucketed_inference = run_all
    return dict(results=results[data["name"]], outputs=outputs,
                counts={k: fn.launches for k, fn in fns.items()},
                shapes=bucket_shapes, wall=wall, infer=sum(infer),
                root=os.path.join(out_root, "results", opt["name"]))


def bucket_path(sets: dict, root: str, card: str) -> dict:
    """Phase 12 (a), (e) and (f): the bucketed route against the per-image
    route on the card; the trace of the bucketed run; the batched metrics
    and eval_folder on its outputs. Returns the timed bucketed run's
    launch counts."""
    import torch

    from super_resolution_tpu_torch.metrics import (calculate_psnr,
                                                    calculate_psnr_pt,
                                                    calculate_ssim,
                                                    calculate_ssim_pt)
    from super_resolution_tpu_torch.tools.eval_folder import evaluate
    from super_resolution_tpu_torch.utils.img import imread, tensor2img
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(BUCKET_YML)
    tile, ws = opt["tile"], opt["network_g"]["window_size"]
    pth = os.path.join(root, os.path.basename(BUCKET_YML) + ".pth")
    if not os.path.exists(pth):
        eval_weights(BUCKET_YML, pth)
    data = dict(name="Urban100Shapes", type="PairedImageDataset",
                dataroot_gt=sets["bucket_gt"], dataroot_lq=sets["bucket_lq"],
                io_backend={"type": "disk"})
    n = len(BUCKET_LR)
    shapes = [(4 * h, 4 * w, 3) for h, w in BUCKET_LR.values()]
    runs = {}
    # a first run of each route (the bucketed one traced) meets its shapes;
    # then the timed bf16 runs in the order bucketed, per image, per image,
    # bucketed
    for key, bucketed, bf16, profile in (
            ("bucketed_bf16_first", True, True, True),
            ("per_image_bf16_first", False, True, False),
            ("bucketed_bf16", True, True, False),
            ("per_image_bf16", False, True, False),
            ("per_image_bf16_2", False, True, False),
            ("bucketed_bf16_2", True, True, False),
            ("bucketed_f32", True, False, False),
            ("per_image_f32", False, False, False)):
        run = bucket_run(data, pth, os.path.join(root, "bucket", key),
                         bucketed, bf16, profile)
        runs[key] = run
        fwd = bucket_forwards(ws, tile, bucketed)
        for name, count in run["counts"].items():
            if count != _EVAL_HAT.get(name, 0) * fwd:
                raise AssertionError(f"bucket:{key}: {name}: {count} "
                                     f"launches, expected "
                                     f"{_EVAL_HAT.get(name, 0)} x {fwd}")
        if bucketed and any(len(s) != 1 for s in run["shapes"]):
            raise AssertionError(f"bucket:{key}: a bucket ran several "
                                 f"shapes: {run['shapes']}")
        for out, shape in zip(run["outputs"], shapes, strict=True):
            if out.shape != shape or not np.isfinite(out).all():
                raise AssertionError(f"bucket:{key}: output {out.shape}, "
                                     f"expected {shape}")
        if not all(np.isfinite(v) for v in run["results"].values()):
            raise AssertionError(f"bucket:{key}: metrics {run['results']}")
        log(f"[bucket:{key}] {card}: {n} images, {fwd} chunk forwards, "
            f"{run['wall'] / n:.3f} s an image wall, inference "
            f"{run['infer'] / n:.4f}; bucket shapes "
            f"{run['shapes'] or '-'}; launches "
            f"{ {k: v for k, v in run['counts'].items() if v} }; results "
            f"{run['results']}")
        if profile:
            trace_names(os.path.join(run["root"], "profile"),
                        TRACE_KERNEL["a"])
    f32 = max(float(np.abs(a - b).max()) for a, b in zip(
        runs["bucketed_f32"]["outputs"], runs["per_image_f32"]["outputs"]))
    bf16 = min(psnr(a, b) for a, b in zip(
        runs["bucketed_bf16"]["outputs"], runs["per_image_bf16"]["outputs"]))
    log(f"  bucketed against per-image: float32 max|diff| {f32:.3e} (tol "
        f"{BUCKET_F32_TOL:.0e}), bf16 worst PSNR {bf16:.2f} dB (min "
        f"{BUCKET_BF16_MIN_DB}); s an image (wall / inference): "
        + ", ".join(f"{k} {runs[k]['wall'] / n:.3f} / "
                    f"{runs[k]['infer'] / n:.4f}" for k in (
                        "bucketed_bf16", "per_image_bf16", "per_image_bf16_2",
                        "bucketed_bf16_2", "bucketed_f32", "per_image_f32")))
    if f32 > BUCKET_F32_TOL or bf16 < BUCKET_BF16_MIN_DB:
        raise AssertionError(f"bucketed against per-image: {f32}, {bf16}")

    # (f) the batched metrics of the bucketed bf16 run's outputs on the card
    # against the numpy protocol, on the same uint8 images
    t0 = time.perf_counter()
    worst = [0.0, 0.0]
    for out, name in zip(runs["bucketed_bf16"]["outputs"], sorted(BUCKET_LR)):
        sr8 = tensor2img(out)
        gt8 = imread(os.path.join(sets["bucket_gt"], f"{name}.png"))
        rgb = [torch.from_numpy(np.ascontiguousarray(v[:, :, ::-1]))
               .cuda()[None].float() / 255 for v in (sr8, gt8)]
        got = (float(calculate_psnr_pt(*rgb, 4, True)[0]),
               float(calculate_ssim_pt(*rgb, 4, True)[0]))
        ref = (calculate_psnr(sr8, gt8, 4, test_y_channel=True),
               calculate_ssim(sr8, gt8, 4, test_y_channel=True))
        worst = [max(worst[i], abs(got[i] - ref[i])) for i in range(2)]
    log(f"  calculate_psnr_pt / calculate_ssim_pt on the card against "
        f"numpy: worst |diff| {worst[0]:.2e} dB, {worst[1]:.2e} (tol 2e-3, "
        f"5e-4) ({time.perf_counter() - t0:.1f} s)")
    if worst[0] > 2e-3 or worst[1] > 5e-4:
        raise AssertionError(f"batched metrics against numpy: {worst}")
    t0 = time.perf_counter()
    vis = os.path.join(runs["bucketed_bf16"]["root"], "visualization",
                       data["name"])
    summary = evaluate(vis, sets["bucket_gt"], 4)
    res = runs["bucketed_bf16"]["results"]
    log(f"  eval_folder on its PNGs: {summary} "
        f"({time.perf_counter() - t0:.1f} s)")
    if (summary["n_images"] != n
            or abs(summary["psnr_y"] - res["psnr"]) > 1e-6
            or abs(summary["ssim_y"] - res["ssim"]) > 1e-6
            or not np.isfinite(summary["niqe"])):
        raise AssertionError(f"eval_folder {summary} against {res}")
    return runs["bucketed_bf16"]["counts"]


def ensemble_path(sets: dict, root: str, card: str) -> dict:
    """Phase 12 (b): ``test_selfensemble`` of HAT_SRx4.yml's runner at full
    width (float32, the widened seeded weights) on one Set5 LR image, on
    the card against the host CPU within phase 5's 1e-4; eight forwards'
    launches. Returns the launch counts."""
    import torch

    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.utils.img import img2tensor, imread
    from super_resolution_tpu_torch.utils.options import (process_options,
                                                          yaml_load)

    pth = os.path.join(root, os.path.basename(ENSEMBLE_YML) + ".pth")
    if not os.path.exists(pth):
        eval_weights(ENSEMBLE_YML, pth)
    opt = yaml_load(ENSEMBLE_YML)
    opt["path"]["pretrain_network_g"] = pth
    opt = process_options(opt, os.path.join(root, "ensemble"),
                          is_train=False)
    lq = img2tensor(imread(os.path.join(sets["lq"], f"{ENSEMBLE_IMAGE}.png"),
                           float32=True))[None]
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_model(opt, device)
        model.feed_data({"lq": lq})
        if device == "cuda":
            model.test_selfensemble()
            torch.cuda.synchronize()
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        model.test_selfensemble()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = {k: fn.launches for k, fn in fns.items()}
        outs[device] = (model.output[0].float().cpu().numpy(),
                        time.perf_counter() - t0)
        del model
    err = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    log(f"[ensemble] {card}: x8 self-ensemble of {ENSEMBLE_YML}'s network "
        f"on {ENSEMBLE_IMAGE} ({lq.shape[1]} x {lq.shape[2]}), float32: "
        f"card {outs['cuda'][1]:.3f} s, host CPU {outs['cpu'][1]:.1f} s; "
        f"max|card - CPU| {err:.3e} (tol 1e-4); launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if outs["cuda"][0].shape != (4 * lq.shape[1], 4 * lq.shape[2], 3):
        raise AssertionError(f"ensemble output {outs['cuda'][0].shape}")
    if err > 1e-4:
        raise AssertionError(f"self-ensemble card against CPU: {err}")
    for name, count in counts.items():
        if count != 8 * _EVAL_HAT.get(name, 0):
            raise AssertionError(f"ensemble: {name}: {count} launches, "
                                 f"expected 8 x {_EVAL_HAT.get(name, 0)}")
    torch.cuda.empty_cache()
    return counts


def lmdb_path(sets: dict, root: str, card: str) -> dict:
    """Phase 12 (c): test.py on HAT_SRx4.yml (bf16, phase 5's weights)
    reading the synthetic Set5 from .lmdb folders written by the port's
    make_lmdb_from_imgs, against the same run on the disk folders: equal
    PSNR / SSIM. Returns the LMDB run's launch counts."""
    from super_resolution_tpu_torch.runtime.test_pipeline import \
        test_from_yaml
    from super_resolution_tpu_torch.utils.lmdb_util import \
        make_lmdb_from_imgs
    from super_resolution_tpu_torch.utils.options import yaml_load

    opt = yaml_load(ENSEMBLE_YML)
    pth = os.path.join(root, os.path.basename(ENSEMBLE_YML) + ".pth")
    t0 = time.perf_counter()
    lmdbs = {}
    for side in ("gt", "lq"):
        names = sorted(os.listdir(sets[side]))
        lmdbs[side] = os.path.join(root, f"set5_{side}.lmdb")
        make_lmdb_from_imgs(sets[side], lmdbs[side], names,
                            [os.path.splitext(n)[0] for n in names])
    log(f"[lmdb] Set5 written to {list(lmdbs.values())} "
        f"({time.perf_counter() - t0:.2f} s)")
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    results = {}
    for backend in ("disk", "lmdb"):
        data = dict(opt["datasets"]["test_1"], io_backend={"type": backend},
                    dataroot_gt=(sets["gt"] if backend == "disk"
                                 else lmdbs["gt"]),
                    dataroot_lq=(sets["lq"] if backend == "disk"
                                 else lmdbs["lq"]))
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = test_from_yaml(
            ENSEMBLE_YML, os.path.join(root, f"lmdb_{backend}"),
            device="cuda", datasets={"test_1": data},
            path=dict(opt["path"], pretrain_network_g=pth),
            inference_dtype="bf16")
        results[backend] = res[data["name"]]
        counts = {k: fn.launches for k, fn in fns.items()}
        log(f"[lmdb:{backend}] {card}: {results[backend]} "
            f"({time.perf_counter() - t0:.1f} s)")
    for metric, value in results["disk"].items():
        if abs(results["lmdb"][metric] - value) > 1e-9:
            raise AssertionError(f"lmdb {results['lmdb']} against disk "
                                 f"{results['disk']}")
    for name, count in counts.items():
        if count != len(SET5) * _EVAL_HAT.get(name, 0):
            raise AssertionError(f"lmdb: {name}: {count} launches")
    return counts


def rawpack_path(sets: dict, root: str, card: str) -> dict:
    """Phase 12 (d) and (e): RawPack built by g++ at first use; crop_batch
    against numpy crops; RAWPACK_ITERS iterations of phase 6's float32 file
    (phase 6's batch) with datasets.train a RawPackPairedDataset over packs
    of phase 6's synthetic pairs and logger.profile on the second
    iteration: finite losses, the first batch against numpy crops of the
    PNGs with the dataset's draws, the trace naming row 7's kernel.
    Returns the launch counts of the run."""
    import random

    from super_resolution_tpu_torch import native
    from super_resolution_tpu_torch.data import EnlargedSampler
    from super_resolution_tpu_torch.data.rawpack_dataset import (
        RawPackReader, pack_folder)
    from super_resolution_tpu_torch.runtime import sr_model as m
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_from_yaml
    from super_resolution_tpu_torch.utils.img import imread
    from super_resolution_tpu_torch.utils.options import yaml_load

    t0 = time.perf_counter()
    lib = native.build_native()
    log(f"[rawpack] {os.path.basename(lib)} built by g++ in "
        f"{time.perf_counter() - t0:.2f} s")
    packs = {}
    t0 = time.perf_counter()
    for side in ("gt", "lq"):
        packs[side] = os.path.join(root, f"train_{side}.srpk")
        n = pack_folder(sets[f"train_{side}"], packs[side])
    log(f"[rawpack] {n} pairs packed ({time.perf_counter() - t0:.2f} s)")
    names = sorted(os.listdir(sets["train_gt"]))
    gts = [imread(os.path.join(sets["train_gt"], f))[:, :, ::-1]
           for f in names]

    def numpy_crop(img, top, left, size, hflip, rot):
        out = img[top:top + size, left:left + size]
        if hflip:
            out = out[:, ::-1]
        if rot:
            out = out.transpose(1, 0, 2)
        return out

    reader = RawPackReader(packs["gt"])
    rng = np.random.default_rng(5)
    idxs = rng.integers(0, n, 16)
    tops, lefts = rng.integers(0, TRAIN_GT - 256, (2, 16))
    hflips, rots = rng.integers(0, 2, (2, 16))
    got = reader.crop_batch(idxs, tops, lefts, 256, hflips, rots)
    for k in range(16):
        if not np.array_equal(got[k], numpy_crop(gts[idxs[k]], tops[k],
                                                 lefts[k], 256, hflips[k],
                                                 rots[k])):
            raise AssertionError(f"crop_batch item {k} against numpy")
    log("  crop_batch of 16 crops of 256 with flips and transposes equals "
        "numpy's")

    spec = TRAIN_PATHS["train_f32"]
    opt = yaml_load(spec["yml"])
    train = opt["datasets"]["train"]
    scale, gt_size = opt["scale"], train["gt_size"]
    train = dict(name="rawpack", type="RawPackPairedDataset",
                 gt_pack=packs["gt"], lq_pack=packs["lq"], scale=scale,
                 gt_size=gt_size, use_hflip=train.get("use_hflip", True),
                 use_rot=train.get("use_rot", True),
                 batch_size_per_gpu=spec["batch"],
                 dataset_enlarge_ratio=1)
    first, losses = [], []
    step = m.SRModel.optimize_parameters

    def keep(model, batch, current_iter):
        if not first:
            first.append({k: np.array(v) for k, v in batch.items()
                          if k in ("lq", "gt")})
        step(model, batch, current_iter)
        losses.append(model.get_current_log())

    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    m.SRModel.optimize_parameters = keep
    t0 = time.perf_counter()
    try:
        model, it = train_from_yaml(
            spec["yml"], os.path.join(root, "rawpack"), device="cuda",
            datasets={"train": train},
            train=dict(opt["train"], total_iter=RAWPACK_ITERS),
            val=dict(opt["val"], val_freq=10 ** 6),
            logger=dict(opt["logger"], print_freq=1,
                        save_checkpoint_freq=10 ** 6, use_tb_logger=False,
                        profile={"start_iter": 1, "num_iters": 1}))
    finally:
        m.SRModel.optimize_parameters = step
    wall = time.perf_counter() - t0
    counts = {k: fn.launches for k, fn in fns.items()}
    log(f"[rawpack] {card}: {spec['yml']} on RawPackPairedDataset, batch "
        f"{spec['batch']}, {it} iterations in {wall:.1f} s; losses "
        f"{losses}; launches {({k: v for k, v in counts.items() if v})}")
    if it != RAWPACK_ITERS or len(losses) != RAWPACK_ITERS or not all(
            np.isfinite(v) for rec in losses for v in rec.values()):
        raise AssertionError(f"rawpack training: {it} iterations, {losses}")

    # the first batch: the loader's epoch-0 order and the dataset's draws
    # (seed manual_seed), cropped from the PNGs by numpy
    seed = model.opt["manual_seed"]
    sampler = EnlargedSampler(n)
    sampler.set_epoch(seed)
    draws = random.Random(seed)
    lq_size = gt_size // scale
    lqs = [imread(os.path.join(sets["train_lq"], f))[:, :, ::-1]
           for f in names]
    for k, i in enumerate(sampler.indices()[:spec["batch"]]):
        h, w = lqs[i].shape[:2]
        top, left = draws.randint(0, h - lq_size), draws.randint(0, w - lq_size)
        hflip = train["use_hflip"] and draws.random() < 0.5
        rot = train["use_rot"] and draws.random() < 0.5
        for key, img, t, l_, s in (("lq", lqs[i], top, left, lq_size),
                                   ("gt", gts[i], top * scale, left * scale,
                                    gt_size)):
            ref = numpy_crop(img, t, l_, s, hflip, rot).astype(
                np.float32) / 255.0
            if not np.array_equal(first[0][key][k], ref):
                raise AssertionError(f"rawpack first batch item {k} {key} "
                                     f"against numpy")
    log(f"  the first batch ({spec['batch']} items) equals the numpy crops "
        f"of the PNGs")
    trace_names(os.path.join(model.opt["path"]["experiments_root"],
                             "profile"), TRACE_KERNEL["d"])
    return counts


def eval_surface(sets: dict, root: str, card: str) -> dict:
    """Phase 12: label -> launch counts of (a) to (d)."""
    import torch

    by_path = {}
    sets.update(write_bucket_pairs(root))
    t0 = time.perf_counter()
    by_path["eval_bucketed"] = bucket_path(sets, root, card)
    log(f"[bucket] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["eval_selfensemble"] = ensemble_path(sets, root, card)
    log(f"[ensemble] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["eval_lmdb"] = lmdb_path(sets, root, card)
    log(f"[lmdb] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["train_rawpack"] = rawpack_path(sets, root, card)
    log(f"[rawpack] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return by_path


# --------------------------------------------------------------- phase 13
# video SR: the plain DCN and flow warp on the card against the host CPU,
# the seven video networks at their published widths (BasicSR's option
# files' numbers: EDVR-M / EDVR-L x4, TOFlow, DUF-52L x4, BasicVSR /
# IconVSR x4 at 64 features and 30 blocks, BasicVSR++ x4 at 64 channels
# and 7 blocks), then train.py and test.py through the video runners on
# synthetic REDS-layout clips. No kernel lies on this path: the DCN and the
# warp are plain PyTorch, as in JAX (XLA there, no pallas_call).
VIDEO_LR = (180, 320)              # a REDS frame, LR
VIDEO_DCN = {                      # (B, H, W, C_in, C_out, deformable groups)
    "edvr_l1": (1, 180, 320, 64, 64, 8),
    "basicvsrpp_align": (1, 180, 320, 128, 64, 16),
}
VIDEO_NETS = {                     # network, frames of a request, LR size
    "edvr_m": (dict(type="EDVR", num_feat=64, num_frame=5,
                    deformable_groups=8, num_extract_block=5,
                    num_reconstruct_block=10, with_tsa=True), 5, VIDEO_LR),
    "edvr_l": (dict(type="EDVR", num_feat=128, num_frame=5,
                    deformable_groups=8, num_extract_block=5,
                    num_reconstruct_block=40, with_tsa=True), 5, VIDEO_LR),
    "toflow": (dict(type="TOFlow", adapt_official_weights=True), 7,
               (256, 448)),
    "duf_52l": (dict(type="DUF", scale=4, num_layer=52), 7, VIDEO_LR),
    "basicvsr": (dict(type="BasicVSR", num_feat=64, num_block=30), 15,
                 VIDEO_LR),
    "iconvsr": (dict(type="IconVSR", num_feat=64, num_block=30,
                     keyframe_stride=5, temporal_padding=2), 15, VIDEO_LR),
    "basicvsrpp": (dict(type="BasicVSRPlusPlus", mid_channels=64,
                        num_blocks=7, max_residue_magnitude=10), 15,
                   VIDEO_LR),
}
# the small clip held against the host CPU: 3 frames where the network
# takes any count, else its own (IconVSR's keyframe padding needs 5)
VIDEO_SMALL = dict(side=64, frames=dict(edvr_m=5, edvr_l=5, toflow=7,
                                        duf_52l=7, basicvsr=3, iconvsr=5,
                                        basicvsrpp=3))
VIDEO_NET_TOL = 1e-3               # x max(1, max|CPU|): 30-60 layers deep
VIDEO_REPS = 3
VIDEO_RANGES = ("deform_conv", "flow_warp", "spynet")
# (c): batch 4 for EDVR-M and 1 for BasicVSR, 3 iterations; (d): one
# iteration at batch 1, BasicVSR's clip cut to 5 frames (its first losses
# on the host CPU run VGG19 and D on every frame)
VIDEO_TRAIN = dict(lr_side=64, frames=15, gan_frames=5, iters=3, freeze=2,
                   edvr_b=4, basicvsr_b=1)
VIDEO_VAL = dict(folders=("000", "011"), frames=5, lr_side=64)
VIDEO_D = dict(type="UNetDiscriminatorSN", num_in_ch=3, num_feat=64,
               skip_connection=True)


def seeded_video_net(net_opt: dict, seed: int):
    """The network at its seeded init, with every DCN's offset convolution
    drawn like the other convolutions (its init is 0, which would leave the
    sampling points on the grid)."""
    import torch

    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    net = build_network(dict(net_opt))
    gen = torch.Generator().manual_seed(seed)
    init_weights(net, gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset" in name:
                bound = 1.0 / math.sqrt(p[0].numel()) if p.ndim > 1 else 0.01
                p.uniform_(-bound, bound, generator=gen)
    return net.eval()


class VideoRanges:
    """While open, each call of the DCN, the flow warp and SpyNet's forward
    runs under a ``torch.profiler.record_function`` range named after it
    (VIDEO_RANGES) between two CUDA events (the networks' modules hold
    their own references, so each is patched there). ``spans()``: the
    summed CUDA-event ms of each name's calls."""

    def __enter__(self):
        import functools

        import torch

        from super_resolution_tpu_torch.models import (basicvsr_arch,
                                                       basicvsrpp_arch,
                                                       edvr_arch,
                                                       spynet_arch, tof_arch)

        self.events = []

        def ranged(fn, name):
            @functools.wraps(fn)
            def run(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.profiler.record_function(name):
                    start.record()
                    out = fn(*args, **kw)
                    end.record()
                self.events.append((name, start, end))
                return out
            return run

        self._undo = []
        for mod, attr, name in (
                (edvr_arch, "modulated_deform_conv2d", "deform_conv"),
                (basicvsrpp_arch, "modulated_deform_conv2d", "deform_conv"),
                (spynet_arch, "flow_warp", "flow_warp"),
                (tof_arch, "flow_warp", "flow_warp"),
                (basicvsr_arch, "flow_warp", "flow_warp"),
                (basicvsrpp_arch, "flow_warp", "flow_warp"),
                (spynet_arch.SpyNet, "forward", "spynet"),
                (tof_arch.SPyNetTOF, "forward", "spynet")):
            self._undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, ranged(getattr(mod, attr), name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._undo):
            setattr(mod, attr, fn)

    def spans(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = dict.fromkeys(VIDEO_RANGES, 0.0)
        for name, start, end in self.events:
            out[name] += start.elapsed_time(end)
        return out


def kernel_shares(events) -> dict:
    """From a profiler run's raw events: the device busy ms (every kernel,
    copy and set) and, for each VIDEO_RANGES name, the device ms of the
    kernels launched inside one of its ranges (a kernel is matched to its
    CUDA runtime launch by correlation id, the launch to a range by its
    host time). A kernel of a warp inside SpyNet counts for both."""
    import bisect

    import torch

    cuda = torch.autograd.DeviceType.CUDA
    launches, gpu = {}, []
    ranges = {name: [] for name in VIDEO_RANGES}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name not in ranges and not e.is_user_annotation():
                gpu.append((e.correlation_id(), e.duration_ns()))
        elif name in ranges:
            ranges[name].append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    out = {"busy": sum(d for _, d in gpu) / 1e6, "matched": 0}
    for name, spans in ranges.items():
        spans.sort()
        starts = [a for a, _ in spans]
        total = 0
        for corr, dur in gpu:
            t = launches.get(corr)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += dur
        out[name] = total / 1e6
    out["matched"] = sum(1 for corr, _ in gpu if corr in launches)
    out["kernels"] = len(gpu)
    return out


def video_profile(fwd) -> dict:
    """One forward under VideoRanges for the CUDA-event spans, then one
    under torch.profiler (CPU and CUDA activity) for the device busy time
    and each range's kernels' device time (:func:`kernel_shares`); both
    with their wall (CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def walled(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    with VideoRanges() as ranges:
        wall = walled(fwd)
        spans = ranges.spans()
    with VideoRanges():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_wall = walled(fwd)
    shares = kernel_shares(prof.profiler.kineto_results.events())
    return {"wall": wall, "spans": spans, "prof_wall": prof_wall, **shares}


def check_video_ops(card: str) -> None:
    """Phase 13 (a): the plain DCN at EDVR-M's L1 shape and at BasicVSR++'s
    alignment shape, and the flow warp, on the card against the host CPU
    (float32, TF32 off), with their CUDA-event ms."""
    import torch

    from super_resolution_tpu_torch.ops.deform_conv import \
        modulated_deform_conv2d
    from super_resolution_tpu_torch.ops.flow import flow_warp

    rng = np.random.default_rng(13)

    def t(*shape, s=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32))

    for label, (b, h, w, cin, cout, dg) in VIDEO_DCN.items():
        args = (torch.from_numpy(rng.random((b, h, w, cin), np.float32)),
                t(b, h, w, 2 * dg * 9, s=2.0),
                torch.sigmoid(t(b, h, w, dg * 9)),
                t(cout, cin, 3, 3, s=(cin * 9) ** -0.5), t(cout, s=0.1))
        ref = modulated_deform_conv2d(*args, padding=1, deformable_groups=dg)
        dev = [a.cuda() for a in args]
        torch.cuda.synchronize()
        got = modulated_deform_conv2d(*dev, padding=1, deformable_groups=dg)
        err = float((got.cpu() - ref).abs().max())
        tol = TOL_F32 * max(1.0, float(ref.abs().max()))
        ms = time_ms(lambda: modulated_deform_conv2d(
            *dev, padding=1, deformable_groups=dg), reps=5, warmup=1)
        cols = b * h * w * 9 * cin * 4 / 2 ** 20
        log(f"[video:ops] {card}: modulated_deform_conv2d {label} "
            f"({b}, {h}, {w}, {cin}) -> {cout}, dg {dg}: card against the "
            f"host CPU max |diff| {err:.3e} (tol {tol:.1e}); {ms:.3f} ms a "
            f"call (CUDA events, median of 5); column tensor {cols:.0f} MiB")
        if not (err <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"deform conv {label}: err {err}")
    x = torch.from_numpy(rng.random((1, *VIDEO_LR, 64), np.float32))
    flow = t(1, *VIDEO_LR, 2, s=3.0)
    for mode in ("zeros", "border"):
        ref = flow_warp(x, flow, padding_mode=mode)
        xd, fd = x.cuda(), flow.cuda()
        got = flow_warp(xd, fd, padding_mode=mode)
        err = float((got.cpu() - ref).abs().max())
        ms = time_ms(lambda: flow_warp(xd, fd, padding_mode=mode), reps=5,
                     warmup=1)
        log(f"[video:ops] {card}: flow_warp (1, {VIDEO_LR[0]}, "
            f"{VIDEO_LR[1]}, 64) {mode}: max |diff| {err:.3e} (tol "
            f"{TOL_F32:.0e}); {ms:.3f} ms a call")
        if not err <= TOL_F32:
            raise AssertionError(f"flow_warp {mode}: err {err}")


def video_net_path(label: str, card: str) -> dict:
    """Phase 13 (b), one network at its published width: a small clip on
    the card against the host CPU, then one REDS-size request with its ms,
    out-Mpix/s, peak memory and the profiler's shares. Returns the launch
    counts (none: no kernel lies on the path)."""
    import torch

    net_opt, frames, (h, w) = VIDEO_NETS[label]
    net = seeded_video_net(net_opt, 13)
    side = VIDEO_SMALL["side"]
    rng = np.random.default_rng(13)
    small = torch.from_numpy(rng.random(
        (1, VIDEO_SMALL["frames"][label], side, side, 3), np.float32))
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = net(small)
        cpu_s = time.perf_counter() - t0
        net.cuda()
        got = net(small.cuda()).cpu()
    err = float((got - ref).abs().max())
    tol = VIDEO_NET_TOL * max(1.0, float(ref.abs().max()))
    log(f"[video:{label}] {card}: {net_opt} on {tuple(small.shape)}: card "
        f"against the host CPU max |diff| {err:.3e} (tol {tol:.1e}), PSNR "
        f"{psnr(got.numpy(), ref.numpy()):.2f} dB (the CPU forward "
        f"{cpu_s:.1f} s)")
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"{label}: card against CPU err {err}")

    x = torch.from_numpy(rng.random((1, frames, h, w, 3),
                                    np.float32)).cuda()
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        out = net(x)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        ms = time_ms(lambda: net(x), reps=VIDEO_REPS, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        prof = video_profile(lambda: net(x))
        prof_s = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in fns.items()}
    mpix = out[0].numel() / 3 / 1e6
    log(f"[video:{label}] {card}: REDS-size request {tuple(x.shape)} -> "
        f"{tuple(out.shape)}: {ms:.1f} ms a clip (CUDA events, median of "
        f"{VIDEO_REPS}), {mpix / (ms / 1e3):.2f} out-Mpix/s, peak memory "
        f"{peak:.2f} GiB; the first forward {first:.2f} s, the two "
        f"profiled ones {prof_s:.1f} s")
    spans = ", ".join(f"{k} {prof['spans'][k]:.1f} ms "
                      f"({100 * prof['spans'][k] / prof['wall']:.1f}%)"
                      for k in VIDEO_RANGES if prof["spans"][k] > 0)
    log(f"  CUDA-event spans of the calls in a {prof['wall']:.1f} ms "
        f"forward: {spans or 'no DCN, warp or SpyNet'}")
    if prof["busy"] > 0 and prof["matched"]:
        shares = ", ".join(f"{k} {prof[k]:.1f} ms "
                           f"({100 * prof[k] / prof['busy']:.1f}%)"
                           for k in VIDEO_RANGES if prof[k] > 0)
        log(f"  torch.profiler: device busy {prof['busy']:.1f} ms of a "
            f"{prof['prof_wall']:.1f} ms forward (idle "
            f"{100 * (1 - prof['busy'] / prof['prof_wall']):.1f}%), "
            f"{prof['kernels']} device ops ({prof['matched']} matched to "
            f"their launch); kernels of {shares or 'no DCN, warp or SpyNet'}")
    else:
        log(f"  torch.profiler: device busy {prof['busy']:.1f} ms, "
            f"{prof['matched']} of {prof['kernels']} device ops matched to "
            f"a launch: the shares by profiler not measured")
    if not (torch.isfinite(out).all() and not any(counts.values())):
        raise AssertionError(f"{label}: non-finite output or launches "
                             f"{counts}")
    del net, x, out
    torch.cuda.empty_cache()
    return counts


def _smooth_frames(rng, n: int, side: int) -> list:
    """``n`` smooth random uint8 frames of side x side (noise blurred by a
    x8 bicubic upsampling, so the LR downsampling keeps some content)."""
    import cv2

    out = []
    for _ in range(n):
        base = (rng.random((side // 8, side // 8, 3)) * 255).astype(np.uint8)
        out.append(cv2.resize(base, (side, side),
                              interpolation=cv2.INTER_CUBIC))
    return out


def write_video_sets(root: str) -> dict:
    """Synthetic clips in REDS's layout: a training clip ``001`` of 100
    frames (GT 4 x VIDEO_TRAIN's LR side, LR by area), its meta file, and a
    validation tree of VIDEO_VAL's folders (REDS4's names)."""
    import cv2

    rng = np.random.default_rng(13)
    paths = {}

    def clips(name, folders, n, lr_side):
        for folder in folders:
            for side, sub in ((lr_side * 4, "gt"), (lr_side, "lq")):
                os.makedirs(os.path.join(root, name, sub, folder),
                            exist_ok=True)
            for i, img in enumerate(_smooth_frames(rng, n, lr_side * 4)):
                cv2.imwrite(os.path.join(root, name, "gt", folder,
                                         f"{i:08d}.png"), img)
                cv2.imwrite(os.path.join(root, name, "lq", folder,
                                         f"{i:08d}.png"),
                            cv2.resize(img, (lr_side, lr_side),
                                       interpolation=cv2.INTER_AREA))
        return (os.path.join(root, name, "gt"),
                os.path.join(root, name, "lq"))

    side = VIDEO_TRAIN["lr_side"]
    paths["train"] = clips("reds_train", ["001"], 100, side)
    meta = os.path.join(root, "reds_meta.txt")
    with open(meta, "w") as f:
        f.write(f"001 100 ({4 * side},{4 * side},3)\n")
    paths["meta"] = meta
    paths["val"] = clips("reds_val", VIDEO_VAL["folders"],
                         VIDEO_VAL["frames"], VIDEO_VAL["lr_side"])
    return paths


class VideoClock:
    """While a video run goes, wraps ``optimize_parameters`` of the video
    runners: each iteration's seconds (to a synchronised card) and logs,
    the first batch and weights, and the weights after each iteration of
    the parameters ``watch`` names."""

    def __init__(self, watch):
        self.watch = watch

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.runtime import video_models as vm

        self.iters, self.logs, self.states = [], [], []
        self.first = None
        self._undo = [(cls, cls.__dict__.get("optimize_parameters"))
                      for cls in (vm.VideoBaseModel, vm.VideoGANModel,
                                  vm.VideoRecurrentGANModel)]

        def wrap(step):
            def run(model, batch, current_iter):
                if self.first is None:
                    self.first = {
                        "batch": {k: batch[k] for k in ("lq", "gt")},
                        "g": {k: v.detach().cpu().clone() for k, v in
                              model.net_g.state_dict().items()},
                        "d": None if getattr(model, "net_d", None) is None
                        else {k: v.detach().cpu().clone() for k, v in
                              model.net_d.state_dict().items()}}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(model, batch, current_iter)
                torch.cuda.synchronize()
                self.iters.append(time.perf_counter() - t0)
                self.logs.append(model.get_current_log())
                self.states.append({k: v.detach().cpu().clone() for k, v in
                                    model.net_g.named_parameters()
                                    if self.watch(k)})
            return run

        for cls, _ in self._undo:
            cls.optimize_parameters = wrap(getattr(cls,
                                                   "optimize_parameters"))
        return self

    def __exit__(self, *exc):
        for cls, fn in self._undo:
            if fn is None:
                del cls.optimize_parameters
            else:
                cls.optimize_parameters = fn


def _video_train_opt(label: str, model_type: str, net: dict, data: dict,
                     batch: int, frames: int, train: dict,
                     total_iter: int) -> dict:
    dataset = ({"type": "REDSDataset", "num_frame": frames}
               if model_type in ("EDVRModel", "VideoGANModel") else
               {"type": "REDSRecurrentDataset", "num_frame": frames})
    side = VIDEO_TRAIN["lr_side"]
    return {
        "name": label, "model_type": model_type, "scale": 4, "num_gpu": 1,
        "manual_seed": 0, "network_g": dict(net),
        "datasets": {"train": dict(
            dataset, name="reds_synthetic", dataroot_gt=data["train"][0],
            dataroot_lq=data["train"][1], meta_info_file=data["meta"],
            val_partition="REDS4", io_backend={"type": "disk"},
            gt_size=4 * side, interval_list=[1], random_reverse=False,
            use_hflip=True, use_rot=True, batch_size_per_gpu=batch,
            dataset_enlarge_ratio=1)},
        "path": {"pretrain_network_g": None, "strict_load_g": True,
                 "resume_state": None},
        "train": dict({
            "ema_decay": 0.999,
            "optim_g": {"type": "Adam", "lr": 2e-4, "betas": [0.9, 0.99]},
            "scheduler": {"type": "CosineAnnealingRestartLR",
                          "periods": [300000], "restart_weights": [1],
                          "eta_min": 1e-7},
            "total_iter": total_iter, "warmup_iter": -1,
            "pixel_opt": {"type": "CharbonnierLoss", "loss_weight": 1.0,
                          "reduction": "mean"}}, **train),
        "logger": {"print_freq": 1, "save_checkpoint_freq": 10 ** 6,
                   "use_tb_logger": False}}


def _video_first_losses_on_cpu(model, first: dict) -> dict:
    """The first iteration's losses recomputed on the host CPU in float32
    from the run's first weights and batch: the pixel loss, and for the
    GAN runners the perceptual and GAN losses (the frames in the batch)
    and D's (D's spectral norm moved by G's fake pass first)."""
    import torch

    from super_resolution_tpu_torch.losses import build_loss
    from super_resolution_tpu_torch.models import build_network

    opt, train = model.opt, model.opt["train"]
    net = build_network(opt["network_g"])
    net.load_state_dict(first["g"], strict=True)
    lq = torch.from_numpy(first["batch"]["lq"])
    gt = torch.from_numpy(first["batch"]["gt"])
    out = {}
    with torch.no_grad():
        sr = net.eval()(lq)
        pix = float(build_loss(train["pixel_opt"])(sr, gt))
        if first["d"] is None:
            return {"l_pix": pix}
        flat = ((lambda v: v.reshape((-1,) + v.shape[-3:]))
                if model.video_frames else (lambda v: v))
        out["l_g_pix"] = total = pix
        p, _ = build_loss(train["perceptual_opt"])(flat(sr), flat(gt))
        out["l_g_percep"] = float(p)
        d = build_network(opt["network_d"])
        d.load_state_dict(first["d"], strict=True)
        gan = build_loss(train["gan_opt"])
        out["l_g_gan"] = float(gan(d(flat(sr), update_sn_stats=True), True))
        out["l_g_total"] = total + out["l_g_percep"] + out["l_g_gan"]
        real = d(flat(gt), update_sn_stats=True)
        fake = d(flat(sr), update_sn_stats=True)
        out.update(l_d_real=float(gan(real, True, is_disc=True)),
                   l_d_fake=float(gan(fake, False, is_disc=True)),
                   out_d_real=float(real.mean()),
                   out_d_fake=float(fake.mean()))
    return out


def video_train_path(label: str, opt: dict, watch, frozen_iters: int,
                     root: str, card: str) -> dict:
    """Phase 13 (c) and (d): ``train.py``'s pipeline on ``opt``; the first
    iteration's losses against the host CPU's; the parameters ``watch``
    names unchanged through the first ``frozen_iters`` iterations and moved
    after. Returns the launch counts."""
    import torch

    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline

    yml = _write_yml(opt, root, label)
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with VideoClock(watch) as clock:
        model, last = train_pipeline(os.path.join(root, label),
                                     argv=["-opt", yml, "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = {n: fn.launches for n, fn in fns.items()}
    key = "l_g_total" if "network_d" in opt else "l_pix"
    losses = [lg[key] for lg in clock.logs]
    b = opt["datasets"]["train"]["batch_size_per_gpu"]
    log(f"[video:{label}] {card}: {opt['model_type']} "
        f"{opt['network_g']['type']}, batch {b}, "
        f"{opt['datasets']['train']['num_frame']} frames of LR "
        f"{VIDEO_TRAIN['lr_side']} x {VIDEO_TRAIN['lr_side']}, TF32 off: "
        f"{_rate(clock.iters, b)}; peak memory {peak:.2f} GiB; wall "
        f"{wall:.1f} s; {key} {[round(v, 6) for v in losses]}")
    if (last != opt["train"]["total_iter"] or not np.isfinite(losses).all()
            or any(counts.values())):
        raise AssertionError(f"{label}: last iteration {last}, losses "
                             f"{losses}, launches {counts}")
    ref = _video_first_losses_on_cpu(model, clock.first)
    got = clock.logs[0]
    errs = {k: abs(got[k] - v) / (1.0 if k.startswith("out_d")
                                  else max(abs(v), 1e-12))
            for k, v in ref.items()}
    log(f"  first iteration on the card {dict(sorted(got.items()))}; on "
        f"the host CPU {dict(sorted(ref.items()))}: worst diff "
        f"{max(errs.values()):.2e} (relative; the mean logits absolute)")
    if any(e > (1e-4 if k.startswith("out_d") else 1e-3)
           for k, e in errs.items()):
        raise AssertionError(f"{label}: first losses {got} vs {ref}")
    start = {k: v for k, v in clock.first["g"].items() if watch(k)}
    moved = [max(float((s[k] - start[k]).abs().max()) for k in start)
             for s in clock.states]
    log(f"  the watched parameters ({len(start)} tensors) moved by at most "
        f"{[f'{m:.2e}' for m in moved]} after each iteration (frozen "
        f"through iteration {frozen_iters})")
    if any(moved[:frozen_iters]) or not all(m > 0 for m in
                                            moved[frozen_iters:]):
        raise AssertionError(f"{label}: watched parameters moved {moved}")
    if "network_d" in opt:
        end = model.net_d.state_dict()
        d_moved = max(float((end[k].cpu() - v).abs().max())
                      for k, v in clock.first["d"].items()
                      if k.endswith("weight_orig") or k.endswith("weight"))
        log(f"  D moved by up to {d_moved:.3e}")
        if not d_moved > 0:
            raise AssertionError(f"{label}: D did not move")
    del model, clock
    torch.cuda.empty_cache()
    return counts


def video_test_path(label: str, net: dict, model_type: str, dataset: str,
                    data: dict, root: str, card: str) -> dict:
    """Phase 13 (e): ``test.py``'s pipeline through a video test dataset on
    seeded weights saved as a .pth; prints the per-folder PSNR tables."""
    import torch

    from super_resolution_tpu_torch.runtime.test_pipeline import \
        test_pipeline

    pth = os.path.join(root, f"{label}.pth")
    torch.save({"params": seeded_video_net(net, 5).state_dict()}, pth)
    opt = {"name": label, "model_type": model_type, "scale": 4,
           "num_gpu": 1, "manual_seed": 0, "network_g": dict(net),
           "datasets": {"test_1": {
               "name": "REDS4_synthetic", "type": dataset,
               "dataroot_gt": data["val"][0], "dataroot_lq": data["val"][1],
               "cache_data": True, "num_frame": 5, "padding": "reflection",
               "io_backend": {"type": "disk"}}},
           "path": {"pretrain_network_g": pth, "strict_load_g": True},
           "val": {"save_img": False, "metrics": {"psnr": {
               "type": "calculate_psnr", "crop_border": 0,
               "test_y_channel": False}}}}
    yml = _write_yml(opt, root, label)
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = test_pipeline(os.path.join(root, label),
                            argv=["-opt", yml, "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in fns.items()}
    tables = results["REDS4_synthetic"]
    log(f"[video:{label}] {card}: test pipeline -> {model_type} "
        f"{net['type']} on {dataset} ({len(tables)} folders of "
        f"{VIDEO_VAL['frames']} frames, LR {VIDEO_VAL['lr_side']} a side) "
        f"in {wall:.1f} s; PSNR by folder and frame:")
    for folder, table in tables.items():
        log(f"  {folder}: {[round(float(v), 4) for v in table[:, 0]]} "
            f"mean {float(table.mean()):.4f} dB")
    if (sorted(tables) != sorted(VIDEO_VAL["folders"])
            or any(not np.isfinite(t).all() or t.shape[0] !=
                   VIDEO_VAL["frames"] for t in tables.values())
            or any(counts.values())):
        raise AssertionError(f"{label}: tables {tables}, launches {counts}")
    return counts


def video_phase(card: str, root: str) -> dict:
    """Phase 13: (a) the ops, (b) the seven networks, (c) train.py through
    EDVRModel and VideoRecurrentModel, (d) one iteration of each video GAN
    runner, (e) test.py through both video test datasets. Returns the
    launch counts of each path (all 0)."""
    by_path = {}
    t0 = time.perf_counter()
    check_video_ops(card)
    log(f"[video] (a) ops done in {time.perf_counter() - t0:.1f} s")
    for label in VIDEO_NETS:
        t1 = time.perf_counter()
        by_path[f"video_{label}"] = video_net_path(label, card)
        log(f"[video:{label}] done in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    data = write_video_sets(root)
    log(f"[video] synthetic REDS-layout clips written in "
        f"{time.perf_counter() - t1:.1f} s")
    edvr, basicvsr = VIDEO_NETS["edvr_m"][0], VIDEO_NETS["basicvsr"][0]
    its, freeze = VIDEO_TRAIN["iters"], VIDEO_TRAIN["freeze"]
    runs = {
        "video_edvr_train": (_video_train_opt(
            "video_edvr_train", "EDVRModel", edvr, data,
            VIDEO_TRAIN["edvr_b"], 5, {"tsa_iter": freeze,
                                       "dcn_lr_mul": 0.5}, its),
            lambda k: "fusion" not in k, freeze),
        "video_basicvsr_train": (_video_train_opt(
            "video_basicvsr_train", "VideoRecurrentModel", basicvsr, data,
            VIDEO_TRAIN["basicvsr_b"], VIDEO_TRAIN["frames"],
            {"fix_flow": freeze, "flow_lr_mul": 0.125}, its),
            lambda k: "spynet" in k, freeze),
    }
    import torch

    from super_resolution_tpu_torch.models.vgg_arch import \
        seeded_vgg19_state_dict
    vgg = os.path.join(root, "video_vgg19.pth")
    torch.save(seeded_vgg19_state_dict(0), vgg)
    gan_train = {
        "optim_d": {"type": "Adam", "lr": 1e-4, "betas": [0.9, 0.99]},
        "perceptual_opt": {
            "type": "PerceptualLoss", "vgg_weights_path": vgg,
            "layer_weights": {"conv5_4": 1}, "vgg_type": "vgg19",
            "use_input_norm": True, "perceptual_weight": 1.0,
            "style_weight": 0, "range_norm": False, "criterion": "l1"},
        "gan_opt": {"type": "GANLoss", "gan_type": "vanilla",
                    "real_label_val": 1.0, "fake_label_val": 0.0,
                    "loss_weight": 5e-3},
        "net_d_iters": 1, "net_d_init_iters": 0}
    for label, model_type, net, frames, extra, watch in (
            ("video_edvr_gan", "VideoGANModel", edvr, 5, {},
             lambda k: "conv_last" in k),
            ("video_basicvsr_gan", "VideoRecurrentGANModel", basicvsr,
             VIDEO_TRAIN["gan_frames"], {"fix_flow": 1, "lr_flow": 2.5e-5},
             lambda k: "spynet" in k)):
        opt = _video_train_opt(label, model_type, net, data, 1, frames,
                               dict(gan_train, **extra), 1)
        opt["network_d"] = dict(VIDEO_D)
        runs[label] = (opt, watch, 1 if extra else 0)
    for label, (opt, watch, frozen) in runs.items():
        t1 = time.perf_counter()
        by_path[label] = video_train_path(label, opt, watch, frozen, root,
                                          card)
        log(f"[video:{label}] done in {time.perf_counter() - t1:.1f} s")
    for label, net, model_type, dataset in (
            ("video_edvr_test", edvr, "EDVRModel", "VideoTestDataset"),
            ("video_basicvsr_test", basicvsr, "VideoRecurrentModel",
             "VideoRecurrentTestDataset")):
        t1 = time.perf_counter()
        by_path[label] = video_test_path(label, net, model_type, dataset,
                                         data, root, card)
        log(f"[video:{label}] done in {time.perf_counter() - t1:.1f} s")
    return by_path


def video_main() -> None:
    """Phase 13 alone (``python3 -c "import chip_smoke;
    chip_smoke.video_main()"``), TF32 off as in :func:`main`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        video_phase(card, root)
    log(f"[video] phase 13 done in {time.perf_counter() - t0:.1f} s")


# phase 14: the face stack, float32 with TF32 off, no kernel on the path.
# StyleGAN2 at BasicSR's train_StyleGAN2_256_Cmul2_FFHQ widths and
# regularisation periods (the path penalty every 4 iterations, R1 every 16)
FACE_SG_G = dict(type="StyleGAN2Generator", out_size=256, num_style_feat=512,
                 num_mlp=8, channel_multiplier=2, resample_kernel=[1, 3, 3, 1],
                 lr_mlp=0.01)
FACE_SG_D = dict(type="StyleGAN2Discriminator", out_size=256,
                 channel_multiplier=2, resample_kernel=[1, 3, 3, 1])
# batch, synthetic FFHQ faces, iterations: the 16th fires both penalties
FACE_SG_TRAIN = dict(batch=4, images=8, iters=16)
# HiFaceGAN on 512 x 512 faces at scale 1, BasicSR's perceptual layers
FACE_HF_G = dict(type="HiFaceGAN", num_in_ch=3, num_feat=64)
FACE_HF_D = dict(type="HiFaceGANDiscriminator", num_in_ch=3, num_out_ch=3,
                 conditional_d=True, num_d=2, n_layers_d=4, num_feat=64)
FACE_HF_TRAIN = dict(batch=1, images=2, iters=2, side=512)
# DFDNet's part boxes (x0, y0, x1, y1) on a 512 x 512 face, in the layout
# of an aligned FFHQ face, and the dictionary: atoms a part, atom side at
# each of the four feature scales (256, 128, 64, 32)
FACE_DFDNET_PARTS = [(150, 190, 230, 250), (282, 190, 362, 250),
                     (216, 240, 296, 330), (190, 340, 322, 410)]
FACE_DFDNET_ATOMS = dict(n=32, sides=(32, 16, 8, 4))
# FID: eval_folder's pairs and their side (under 96 + 2 x 4: one NIQE
# block gives no covariance, ROADMAP.md queue 3)
FACE_FID = dict(n=32, side=96)
FACE_TOL = 1e-3


def _face_launches_zero() -> dict:
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    for fn in fns.values():
        fn.launches = 0
    return fns


def _face_counts(fns: dict, label: str) -> dict:
    counts = {n: fn.launches for n, fn in fns.items()}
    if any(counts.values()):
        raise AssertionError(f"{label}: kernels launched {counts}")
    return counts


def _face_check(label: str, cpu, card) -> float:
    """max |card - cpu| against FACE_TOL x max(1, max |cpu|); raises."""
    import torch

    err = float((card.detach().float().cpu() - cpu).abs().max())
    tol = FACE_TOL * max(1.0, float(cpu.abs().max()))
    if not (err <= tol and bool(torch.isfinite(card).all())):
        raise AssertionError(f"{label}: card against CPU err {err} > {tol}")
    return err


def _seeded_net(opt: dict, seed: int):
    import torch

    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights

    net = build_network(opt)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.eval()


def write_faces(root: str, name: str, n: int, side: int, seed: int) -> str:
    """``n`` smooth synthetic side x side face-sized PNGs."""
    import cv2

    out = os.path.join(root, name)
    os.makedirs(out, exist_ok=True)
    for i, img in enumerate(_smooth_frames(np.random.default_rng(seed), n,
                                           side)):
        cv2.imwrite(os.path.join(out, f"{i:08d}.png"), img)
    return out


class FaceClock:
    """While phase 14's StyleGAN2 run goes: the seconds of each step by
    kind (D, D + R1, G, G + path length; to a synchronised card), each
    iteration's logs, and at iteration ``snap_iter`` its real batch, its
    draws and the weights (and mean path length) before each step."""

    def __init__(self, snap_iter: int):
        self.snap_iter = snap_iter

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.runtime.stylegan2_model import \
            StyleGAN2Model as cls

        self.cls = cls
        self.saved = {n: cls.__dict__[n] for n in
                      ("d_step", "g_step", "g_reg_step", "train_iteration")}
        self.times = {"d": [], "d_r1": [], "g": [], "g_path": []}
        self.logs, self.snap, self.it = [], None, None

        def host(sd):
            return {k: v.detach().cpu().clone() for k, v in sd.items()}

        def timed(kind_of, step):
            def run(model, part, *args):
                kind = kind_of(*args)
                if self.it == self.snap_iter:
                    self.snap[kind] = {
                        "g": host(model.net_g.state_dict()),
                        "d": host(model.net_d.state_dict()),
                        "mean": float(model.mean_path_length)}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(model, part, *args)
                torch.cuda.synchronize()
                self.times[kind].append(time.perf_counter() - t0)
                return out
            return run

        def iteration(model, draws, current_iter):
            self.it = current_iter
            if current_iter == self.snap_iter:
                self.snap = {"draws": draws, "real": model.real_img.cpu()}
            self.saved["train_iteration"](model, draws, current_iter)
            self.logs.append(model.get_current_log())

        cls.d_step = timed(lambda do_r1: "d_r1" if do_r1 else "d",
                           self.saved["d_step"])
        cls.g_step = timed(lambda: "g", self.saved["g_step"])
        cls.g_reg_step = timed(lambda: "g_path", self.saved["g_reg_step"])
        cls.train_iteration = iteration
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def _sg_losses_on_cpu(opt: dict, snap: dict) -> dict:
    """Iteration ``snap``'s losses on the host CPU in float32 from the
    weights before each step and the same draws (the penalties' values
    need first-order gradients only)."""
    import torch

    from super_resolution_tpu_torch.losses import build_loss
    from super_resolution_tpu_torch.losses.gan import (g_path_regularize,
                                                       r1_penalty)
    from super_resolution_tpu_torch.models import build_network

    tr = opt["train"]
    g, d = build_network(opt["network_g"]), build_network(opt["network_d"])
    cri = build_loss(tr["gan_opt"])
    draws, real = snap["draws"], snap["real"]

    def gen(part, **kw):
        return g(part["styles"], inject_index=part["inject"],
                 noise=part["noise"], **kw)

    out = {}
    g.load_state_dict(snap["d_r1"]["g"])
    d.load_state_dict(snap["d_r1"]["d"])
    with torch.no_grad():
        fake_pred = d(gen(draws["d"])[0])
    real = real.clone().requires_grad_(True)
    real_pred = d(real)
    out["l_d"] = float(cri(real_pred, True, is_disc=True)
                       + cri(fake_pred, False, is_disc=True))
    out["real_score"] = float(real_pred.mean())
    out["fake_score"] = float(fake_pred.mean())
    out["l_d_r1"] = float(tr["r1_reg_weight"] / 2 * r1_penalty(
        real_pred, real) * tr["net_d_reg_every"])
    g.load_state_dict(snap["g"]["g"])
    d.load_state_dict(snap["g"]["d"])
    with torch.no_grad():
        out["l_g"] = float(cri(d(gen(draws["g"])[0]), True))
    g.load_state_dict(snap["g_path"]["g"])
    fake, latents = gen(draws["path"], return_latents=True)
    penalty, length, _ = g_path_regularize(
        fake, latents, torch.tensor(snap["g_path"]["mean"]),
        noise=draws["path"]["path_noise"])
    out["l_g_path"] = float(tr["path_reg_weight"] * tr["net_g_reg_every"]
                            * penalty)
    out["path_length"] = float(length)
    return out


def _face_loss_errors(got: dict, ref: dict) -> dict:
    """Relative errors; the scores and mean logits against max(1, |v|)."""
    return {k: abs(got[k] - v) / (max(1.0, abs(v))
                                  if k.endswith("score") else abs(v))
            for k, v in ref.items()}


def face_top_kernels(fn, n: int = 4) -> str:
    """One call of ``fn`` under torch.profiler: the device's busy ms
    against the wall, and the ``n`` kernels of the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            by_name[e.name()] = (by_name.get(e.name(), 0.0)
                                 + e.duration_ns() / 1e6)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return (f"device busy {busy:.1f} ms of a {wall:.1f} ms call under the "
            f"profiler; " + "; ".join(
                f"{name[:70]} {ms:.1f} ms ({100 * ms / max(busy, 1e-9):.0f}%)"
                for name, ms in top))


def face_stylegan2(card: str, root: str) -> dict:
    """Phase 14 (a): both generators' forwards with explicit noise on the
    card against the host CPU; then train.py through StyleGAN2Model on a
    disk FFHQDataset, its 16th iteration's losses against the host CPU's,
    s a step of each kind, peak memory, the sample grid. Returns the
    launch counts of each path (none)."""
    import torch

    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline

    by_path = {}
    for label, net_opt in (("face_stylegan2_fir", FACE_SG_G),
                           ("face_stylegan2_bilinear",
                            {**{k: v for k, v in FACE_SG_G.items()
                                if k != "resample_kernel"},
                             "type": "StyleGAN2GeneratorBilinear"})):
        fns = _face_launches_zero()
        net = _seeded_net(net_opt, 14)
        g = torch.Generator().manual_seed(14)
        z = [torch.randn(2, 512, generator=g) for _ in range(2)]
        noise = [torch.randn(2, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                             generator=g) for i in range(net.num_layers)]
        t0 = time.perf_counter()
        with torch.no_grad():
            ref, _ = net(z, noise=noise, inject_index=7)
            cpu_s = time.perf_counter() - t0
            net.cuda()
            zc, nc = [v.cuda() for v in z], [v.cuda() for v in noise]
            got, _ = net(zc, noise=nc, inject_index=7)
            ms = time_ms(lambda: net(zc, noise=nc, inject_index=7), reps=5)
        err = _face_check(label, ref, got)
        log(f"[face:{label}] {card}: {net_opt['type']} 256 x 256, 512-dim "
            f"styles, 8 MLP layers, channel multiplier 2, batch 2 mixing "
            f"at 7: card against the host CPU max |diff| {err:.3e} (the "
            f"CPU forward {cpu_s:.1f} s); {ms:.2f} ms a forward")
        by_path[label] = _face_counts(fns, label)
        del net
    torch.cuda.empty_cache()

    label = "face_stylegan2_train"
    tr = FACE_SG_TRAIN
    faces = write_faces(root, "ffhq", tr["images"], 256, 14)
    opt = {"name": label, "model_type": "StyleGAN2Model", "num_gpu": 1,
           "manual_seed": 0,
           "datasets": {"train": {
               "name": "FFHQ", "type": "FFHQDataset", "dataroot_gt": faces,
               "io_backend": {"type": "disk"}, "use_hflip": True,
               "mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
               "batch_size_per_gpu": tr["batch"],
               "dataset_enlarge_ratio": 1}},
           "network_g": dict(FACE_SG_G), "network_d": dict(FACE_SG_D),
           "path": {"pretrain_network_g": None, "strict_load_g": True,
                    "resume_state": None,
                    "experiments_root": os.path.join(root, "face_exp")},
           "train": {"optim_g": {"type": "Adam", "lr": 2e-3},
                     "optim_d": {"type": "Adam", "lr": 2e-3},
                     "total_iter": tr["iters"], "warmup_iter": -1,
                     "gan_opt": {"type": "GANLoss",
                                 "gan_type": "wgan_softplus",
                                 "loss_weight": 1},
                     "r1_reg_weight": 10, "path_reg_weight": 2,
                     "net_g_reg_every": 4, "net_d_reg_every": 16,
                     "mixing_prob": 0.9},
           "val": {"num_val_samples": 16},
           "logger": {"print_freq": 4, "save_checkpoint_freq": 10 ** 6,
                      "use_tb_logger": False}}
    yml = _write_yml(opt, root, label)
    fns = _face_launches_zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FaceClock(tr["iters"]) as clock:
        model, last = train_pipeline(os.path.join(root, label),
                                     argv=["-opt", yml, "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.nondist_validation(None, last)
    grid = os.path.join(model.opt["path"]["visualization"], "train",
                        f"train_{last}.png")
    by_path[label] = _face_counts(fns, label)
    steps = ", ".join(f"{k} {statistics.median(v) * 1e3:.1f} ms (x{len(v)})"
                      for k, v in clock.times.items() if v)
    log(f"[face:{label}] {card}: StyleGAN2Model through train.py, batch "
        f"{tr['batch']}, {tr['iters']} iterations on {tr['images']} "
        f"synthetic 256 x 256 faces, TF32 off: s a step by kind (median): "
        f"{steps}; peak memory {peak:.2f} GiB; wall {wall:.1f} s; sample "
        f"grid {grid}")
    ref = _sg_losses_on_cpu(opt, clock.snap)
    got = clock.logs[-1]
    errs = _face_loss_errors(got, ref)
    log(f"  iteration {tr['iters']} (R1 and the path penalty) on the card "
        f"{dict(sorted(got.items()))}; on the host CPU "
        f"{dict(sorted(ref.items()))}: worst diff {max(errs.values()):.2e}")
    finite = all(np.isfinite(list(lg.values())).all() for lg in clock.logs)
    if (last != tr["iters"] or not finite or not os.path.isfile(grid)
            or len(clock.times["d_r1"]) != 1
            or len(clock.times["g_path"]) != tr["iters"] // 4
            or max(errs.values()) > FACE_TOL):
        raise AssertionError(f"{label}: last {last}, finite {finite}, "
                             f"steps {clock.times}, errors {errs}")
    draws = model.make_draws(tr["batch"], tr["iters"])
    for kind, step in (("D + R1", lambda: model.d_step(draws["d"], True)),
                       ("G", lambda: model.g_step(draws["g"])),
                       ("G + path", lambda: model.g_reg_step(
                           draws["path"]))):
        log(f"  one {kind} step: {face_top_kernels(step)}")
    del model, clock
    torch.cuda.empty_cache()
    return by_path


class _FirstIteration:
    """Wraps ``HiFaceGANModel.optimize_parameters`` while a run goes: each
    iteration's seconds (to a synchronised card) and logs, and the first
    batch with the weights before it."""

    def __enter__(self):
        import torch

        from super_resolution_tpu_torch.runtime.hifacegan_model import \
            HiFaceGANModel as cls

        self.cls, self.saved = cls, cls.__dict__["optimize_parameters"]
        self.iters, self.logs, self.first = [], [], None

        def run(model, batch, current_iter):
            if self.first is None:
                self.first = {
                    "batch": {k: batch[k] for k in ("lq", "gt")},
                    **{n: {k: v.detach().cpu().clone()
                           for k, v in net.state_dict().items()}
                       for n, net in (("g", model.net_g),
                                      ("d", model.net_d))}}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.saved(model, batch, current_iter)
            torch.cuda.synchronize()
            self.iters.append(time.perf_counter() - t0)
            self.logs.append(model.get_current_log())

        cls.optimize_parameters = run
        return self

    def __exit__(self, *exc):
        self.cls.optimize_parameters = self.saved


def face_hifacegan(card: str, root: str, vgg: str) -> dict:
    """Phase 14 (b): train.py through HiFaceGANModel on written 512 x 512
    pairs: the first iteration's losses against the host CPU's, s an
    iteration, peak memory."""
    import cv2
    import torch

    from super_resolution_tpu_torch.runtime import build_model
    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline

    label = "face_hifacegan"
    tr = FACE_HF_TRAIN
    gt = write_faces(root, "hf_gt", tr["images"], tr["side"], 15)
    lq = os.path.join(root, "hf_lq")
    os.makedirs(lq, exist_ok=True)
    for name in sorted(os.listdir(gt)):
        img = cv2.imread(os.path.join(gt, name))
        small = cv2.resize(img, (tr["side"] // 4, tr["side"] // 4),
                           interpolation=cv2.INTER_AREA)
        cv2.imwrite(os.path.join(lq, name),
                    cv2.resize(small, (tr["side"], tr["side"]),
                               interpolation=cv2.INTER_CUBIC))
    opt = {"name": label, "model_type": "HiFaceGANModel", "scale": 1,
           "num_gpu": 1, "manual_seed": 0,
           "datasets": {"train": {
               "name": "faces", "type": "PairedImageDataset",
               "dataroot_gt": gt, "dataroot_lq": lq,
               "io_backend": {"type": "disk"}, "gt_size": tr["side"],
               "use_hflip": True, "use_rot": False,
               "batch_size_per_gpu": tr["batch"],
               "dataset_enlarge_ratio": 1}},
           "network_g": dict(FACE_HF_G), "network_d": dict(FACE_HF_D),
           "path": {"pretrain_network_g": None, "strict_load_g": True,
                    "resume_state": None,
                    "experiments_root": os.path.join(root, "face_exp")},
           "train": {
               "optim_g": {"type": "Adam", "lr": 1e-4, "betas": [0.5, 0.999]},
               "optim_d": {"type": "Adam", "lr": 4e-4, "betas": [0.5, 0.999]},
               "scheduler": {"type": "MultiStepLR", "milestones": [600000],
                             "gamma": 0.5},
               "total_iter": tr["iters"], "warmup_iter": -1,
               "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0,
                             "reduction": "mean"},
               "perceptual_opt": {
                   "type": "PerceptualLoss", "vgg_weights_path": vgg,
                   "layer_weights": {"conv1_2": 0.1, "conv2_2": 0.1,
                                     "conv3_4": 1, "conv4_4": 1,
                                     "conv5_4": 1},
                   "vgg_type": "vgg19", "use_input_norm": True,
                   "perceptual_weight": 1.0, "style_weight": 0,
                   "range_norm": True, "criterion": "l1"},
               "gan_opt": {"type": "MultiScaleGANLoss", "gan_type": "hinge",
                           "loss_weight": 1.0},
               "feature_matching_opt": {"type": "GANFeatLoss",
                                        "loss_weight": 10.0},
               "net_d_iters": 1, "net_d_init_iters": 0},
           "logger": {"print_freq": 1, "save_checkpoint_freq": 10 ** 6,
                      "use_tb_logger": False}}
    yml = _write_yml(opt, root, label)
    fns = _face_launches_zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _FirstIteration() as clock:
        model, last = train_pipeline(os.path.join(root, label),
                                     argv=["-opt", yml, "--device", "cuda"])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _face_counts(fns, label)
    log(f"[face:{label}] {card}: HiFaceGANModel through train.py, "
        f"{FACE_HF_G['num_feat']} features, D {FACE_HF_D['num_d']} scales "
        f"of {FACE_HF_D['n_layers_d']} layers, batch {tr['batch']} of "
        f"{tr['side']} x {tr['side']}, TF32 off: "
        f"{_rate(clock.iters, tr['batch'])}; peak memory {peak:.2f} GiB; "
        f"wall {wall:.1f} s")
    del model
    torch.cuda.empty_cache()

    cpu = build_model(opt, "cpu")
    cpu.setup_training()
    cpu.net_g.load_state_dict(clock.first["g"])
    cpu.net_d.load_state_dict(clock.first["d"])
    cpu.feed_data(clock.first["batch"])
    with torch.no_grad():
        sr = cpu.net_g(cpu.lq)
        fake, real = cpu.discriminate(cpu.lq, sr, cpu.gt)
        ref = {"l_g_pix": float(cpu.cri_pix(sr, cpu.gt)),
               "l_g_percep": float(cpu.cri_perceptual(sr, cpu.gt)[0]),
               "l_g_gan": float(cpu.cri_gan(fake, True, is_disc=False)),
               "l_g_feat": float(cpu.cri_feat(fake, real)),
               "l_d_real": float(cpu.cri_gan(real, True, is_disc=True)),
               "l_d_fake": float(cpu.cri_gan(fake, False, is_disc=True))}
    ref["l_g_total"] = (ref["l_g_pix"] + ref["l_g_percep"] + ref["l_g_gan"]
                        + ref["l_g_feat"])
    got = clock.logs[0]
    errs = _face_loss_errors(got, ref)
    log(f"  first iteration on the card {dict(sorted(got.items()))}; on "
        f"the host CPU {dict(sorted(ref.items()))}: worst diff "
        f"{max(errs.values()):.2e} (relative)")
    finite = all(np.isfinite(list(lg.values())).all() for lg in clock.logs)
    if last != tr["iters"] or not finite or max(errs.values()) > FACE_TOL:
        raise AssertionError(f"{label}: last {last}, finite {finite}, "
                             f"errors {errs}")
    return {label: counts}


def face_dfdnet(card: str) -> dict:
    """Phase 14 (c): one DFDNet forward at 64 features on a 512 x 512
    face, card against the host CPU, and its ms. The dictionary: seeded
    N(0, 1) atoms (FACE_DFDNET_ATOMS), one of which in each part is the
    part's own VGG feature scaled and shifted (the AdaIN undoes it), so
    the atom choice leads by a margin."""
    import torch
    import torch.nn.functional as F

    label = "face_dfdnet"
    net = _seeded_net(dict(type="DFDNet", num_feat=64), 16)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(np.stack(_smooth_frames(rng, 1, 512)).astype(
        np.float32) / 127.5 - 1.0)
    locs = [np.asarray([b]) for b in FACE_DFDNET_PARTS]
    with torch.no_grad():
        feats = net.vgg_extractor(x)
    dic = {}
    for layer, f_size, side in zip(net.vgg_layers, net.feature_sizes,
                                   FACE_DFDNET_ATOMS["sides"]):
        dic[str(f_size)] = {}
        for part, box in zip(net.parts, FACE_DFDNET_PARTS):
            x0, y0, x1, y1 = [v // (512 // f_size) for v in box]
            own = F.interpolate(feats[layer][:, :, y0:y1, x0:x1],
                                size=(side, side), mode="bilinear",
                                align_corners=False)[0]
            atoms = torch.from_numpy(rng.standard_normal(
                (FACE_DFDNET_ATOMS["n"],) + tuple(own.shape)).astype(
                    np.float32))
            scale = torch.from_numpy(rng.uniform(
                0.5, 2.0, (own.shape[0], 1, 1)).astype(np.float32))
            atoms[int(rng.integers(FACE_DFDNET_ATOMS["n"]))] = (own * scale
                                                                + scale)
            dic[str(f_size)][part] = atoms
    fns = _face_launches_zero()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = net(x, locs, dic)
        cpu_s = time.perf_counter() - t0
        net.cuda()
        xc = x.cuda()
        dc = {k: {p: v.cuda() for p, v in d.items()} for k, d in dic.items()}
        got = net(xc, locs, dc)
        ms = time_ms(lambda: net(xc, locs, dc), reps=5)
    err = _face_check(label, ref, got)
    log(f"[face:{label}] {card}: DFDNet at 64 features on one 512 x 512 "
        f"face, {FACE_DFDNET_ATOMS['n']} atoms a part of sides "
        f"{FACE_DFDNET_ATOMS['sides']}, part boxes {FACE_DFDNET_PARTS}: "
        f"card against the host CPU max |diff| {err:.3e} (the CPU forward "
        f"{cpu_s:.1f} s); {ms:.1f} ms a forward (batch 1, eager)")
    counts = _face_counts(fns, label)
    del net
    torch.cuda.empty_cache()
    return {label: counts}


def pt_inception_state_dict(seed: int = 0) -> dict:
    """Seeded random weights under the raw pt_inception names, with its
    ``fc`` and one ``AuxLogits`` entry (which a load passes over):
    He-normal convs, BatchNorm scales 1 + N(0, 0.1), shifts and means N(0,
    0.1), variances in [0.5, 1.5), so that the features vary with the
    input (with 0.1 N(0, 1) convs every image gives the same block-3
    features)."""
    import torch

    from super_resolution_tpu_torch.models.inception_arch import \
        FIDInceptionV3

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in FIDInceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        z = torch.randn(v.shape, generator=g)
        if k.endswith("conv.weight"):
            sd[k] = z * (2.0 / v[0].numel()) ** 0.5
        elif k.endswith("running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        else:
            sd[k] = (1.0 if k.endswith("bn.weight") else 0.0) + 0.1 * z
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    sd["AuxLogits.fc.weight"] = torch.zeros(1008, 768)
    return sd


def face_fid(card: str, root: str) -> dict:
    """Phase 14 (d): the FID InceptionV3's block-3 features on the card
    against the host CPU; tools/eval_folder.py --fid-weights (its
    calculate_fid, features on the card) on two written seeded sets."""
    import contextlib
    import io

    import cv2
    import torch

    from super_resolution_tpu_torch.models.inception_arch import (
        FIDInceptionV3, load_fid_inception)
    from super_resolution_tpu_torch.tools import eval_folder

    label = "face_fid"
    fns = _face_launches_zero()
    sd = pt_inception_state_dict(17)
    net = FIDInceptionV3()
    load_fid_inception(net, sd)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(np.stack(_smooth_frames(rng, 8, 256)).astype(
        np.float32)[..., ::-1].copy() / 255.0)
    with torch.no_grad():
        ref = net.eval()(x)[0]
        xc = x.cuda()
        got = net.cuda()(xc)[0]
        ms = time_ms(lambda: net(xc), reps=5)
    err = _face_check(label, ref, got)
    log(f"[face:{label}] {card}: FIDInceptionV3 on a seeded pt_inception "
        f"state dict, 8 images of 256 x 256 resized to 299: block-3 "
        f"features card against the host CPU max |diff| {err:.3e}; "
        f"{ms:.2f} ms a batch")
    # calculate_fid through eval_folder: the FID of two seeded sets of
    # FACE_FID["n"] written images (96 x 96: no NIQE, ROADMAP.md queue 3)
    n = FACE_FID["n"]
    sr, hr = os.path.join(root, "fid_sr"), os.path.join(root, "fid_hr")
    for d in (sr, hr):
        os.makedirs(d, exist_ok=True)
    for i, img in enumerate(_smooth_frames(rng, n, FACE_FID["side"])):
        cv2.imwrite(os.path.join(hr, f"{i:04d}.png"), img)
        noisy = np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
        cv2.imwrite(os.path.join(sr, f"{i:04d}.png"), noisy.astype(np.uint8))
    weights = os.path.join(root, "pt_inception.pth")
    torch.save(sd, weights)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        eval_folder.main(["--sr", sr, "--hr", hr, "--crop-border", "4",
                          "--fid-weights", weights, "--device", "cuda"])
    wall = time.perf_counter() - t0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])["summary"]
    log(f"  tools/eval_folder.py --fid-weights (calculate_fid) on {n} "
        f"written {FACE_FID['side']} x {FACE_FID['side']} pairs, seeded "
        f"images against their noisy copies: {summary} in {wall:.1f} s (the "
        f"2048 x 2048 matrix root on the host)")
    counts = _face_counts(fns, label)
    fid = summary.get("fid", np.nan)
    if not (np.isfinite(fid) and fid > 0 and summary["n_images"] == n):
        raise AssertionError(f"{label}: summary {summary}")
    return {label: counts}


def face_phase(card: str, root: str) -> dict:
    """Phase 14: (a) StyleGAN2, (b) HiFaceGAN, (c) DFDNet, (d) FID.
    Returns the launch counts of each path (all 0: no kernel lies on the
    face stack)."""
    import torch

    from super_resolution_tpu_torch.models.vgg_arch import \
        seeded_vgg19_state_dict

    by_path = {}
    t0 = time.perf_counter()
    by_path.update(face_stylegan2(card, root))
    log(f"[face] (a) StyleGAN2 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vgg = os.path.join(root, "face_vgg19.pth")
    torch.save(seeded_vgg19_state_dict(0), vgg)
    by_path.update(face_hifacegan(card, root, vgg))
    log(f"[face] (b) HiFaceGAN done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(face_dfdnet(card))
    log(f"[face] (c) DFDNet done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(face_fid(card, root))
    log(f"[face] (d) FID done in {time.perf_counter() - t0:.1f} s")
    return by_path


def face_main() -> None:
    """Phase 14 alone (``python3 -c "import chip_smoke;
    chip_smoke.face_main()"``), TF32 off as in :func:`main`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    log(card)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        face_phase(card, root)
    log(f"[face] phase 14 done in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------- phase 15
# parallelism (super_resolution_tpu_torch/parallel/): (a) train.py with
# ``mesh: {data: -1}`` in an NCCL world of one against the same run without
# a mesh; (b) two ranks of a gloo group on the one card, a (model: 2) mesh:
# classic HAT x4 at full width and 2 of its 6 RHAGs, head- and
# hidden-parallel; (c) pipeline_forward over (pipe: 2) and
# spatial_shard_forward over (data: 2) on the same two ranks
PAR_NET = dict(CLASSIC, depths=[6, 6], num_heads=[HEADS] * 2,
               drop_path_rate=0.0)
# the fork's HAT x2 at full width, 2 of its 6 RHAGs: under TP rows 7, 8
# and 9 run whole on each rank, rows 6 (the OCAB tail) on its hidden slice
PAR_FORK = dict(FORK, depths=[6, 6], num_heads=[HEADS] * 2)
PAR_FORK_CALLS = {"ln_split": 12, "gated_dconv_ffn_block": 12,
                  "fused_ocab_attention": 2, "mlp_block": 2}
PAR_STEPS = 2
PAR_TOL = 1e-6        # (a): losses and final state, relative
PAR_PSNR = 35.0       # (b): bf16 TP output against the float32 one-process
PAR_CALLS = {"fused_msa_block": 6, "fused_msa_block_shifted": 6,
             "mlp_block_sum3": 6, "mlp_block_sum3_shifted": 6,
             "fused_ocab_block": 2, "mlp_block": 2}
# rank 0 of (c) runs its RHAG at every tick of GPipe: 2 microbatches, 2
# ranks, 2 + 2 - 1 ticks
PAR_PP_TICKS = 3
# the float32 kernels of rows 1 to 6 by their device names (trace events)
PAR_SYMBOLS = ("msa_block_kernel", "ocab_block_kernel", "mlp_tail_kernel")


def par_world_of_one(sets: dict, root: str, card: str) -> dict:
    """(a) Phase 6's float32 file (2 of its 6 RHAGs, batch 4) through
    train.py's pipeline for PAR_STEPS steps, without a mesh and then with
    ``mesh: {data: -1}`` in an NCCL world of one (the process group joined
    through the env:// variables torchrun would set); no validation. The
    losses and the final weights and EMA must agree within PAR_TOL
    (relative; the state by its norm). Returns the mesh run's counts."""
    import socket

    import torch
    import torch.distributed as dist
    import yaml

    from super_resolution_tpu_torch.runtime.train_pipeline import \
        train_pipeline
    from super_resolution_tpu_torch.utils.options import yaml_load

    spec = TRAIN_PATHS["train_f32"]
    opt = yaml_load(spec["yml"])
    opt["network_g"].update(depths=[6, 6], num_heads=[6, 6])
    force = [f"{key}={sets[name]}" for key, name in spec["roots"].items()]
    force += [f"train:total_iter={PAR_STEPS}", "val:val_freq=1000",
              f"logger:save_checkpoint_freq={PAR_STEPS}",
              "logger:print_freq=1",
              f"datasets:train:batch_size_per_gpu={spec['batch']}"]
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}
    runs = {}
    for run in ("plain", "mesh"):
        yml = os.path.join(root, f"par_{run}.yml")
        with open(yml, "w") as f:
            yaml.safe_dump(dict(opt, mesh={"data": -1}) if run == "mesh"
                           else opt, f)
        if run == "mesh":
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            os.environ.update(MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port), RANK="0",
                              WORLD_SIZE="1", LOCAL_RANK="0")
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            with TrainClock(fns) as clock:
                model, last = train_pipeline(
                    os.path.join(root, f"par_{run}"),
                    argv=["-opt", yml, "--device", "cuda", "--force_yml",
                          *force])
            if run == "mesh":
                backend = dist.get_backend()
                world = dist.get_world_size()
        finally:
            if run == "mesh":
                if dist.is_initialized():
                    dist.destroy_process_group()
                for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                          "WORLD_SIZE", "LOCAL_RANK"):
                    os.environ.pop(k, None)
        runs[run] = dict(losses=clock.losses, wall=time.perf_counter() - t0,
                         steps=clock.steps, counts={
                             n: fn.launches for n, fn in fns.items()},
                         net=model.net_g.state_dict(),
                         ema=model.state.ema.state_dict())
        if last != PAR_STEPS:
            raise AssertionError(f"[par:a] {run}: last iteration {last}")
    plain, mesh = runs["plain"], runs["mesh"]
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(mesh["losses"], plain["losses"]))

    def rel(a, b):
        num = sum(float((a[k].float() - v.float()).square().sum())
                  for k, v in b.items() if v.is_floating_point())
        den = sum(float(v.float().square().sum()) for v in b.values()
                  if v.is_floating_point())
        return math.sqrt(num / den)

    w_err, e_err = rel(mesh["net"], plain["net"]), rel(mesh["ema"],
                                                       plain["ema"])
    log(f"[par:a] {card}: {backend} world of {world}, mesh {{data: -1}}: "
        f"losses {mesh['losses']} against {plain['losses']} without a mesh "
        f"(max rel {loss_err:.3e}); weights rel {w_err:.3e}, EMA rel "
        f"{e_err:.3e}; s a step {[round(s, 3) for s in mesh['steps']]} "
        f"against {[round(s, 3) for s in plain['steps']]}; wall "
        f"{mesh['wall']:.1f} s against {plain['wall']:.1f} s")
    if (len(mesh["losses"]) != PAR_STEPS or backend != "nccl" or world != 1
            or max(loss_err, w_err, e_err) > PAR_TOL):
        raise AssertionError("[par:a] the world of one left the no-mesh run")
    if mesh["counts"] != plain["counts"]:
        raise AssertionError(f"[par:a] launches {mesh['counts']} against "
                             f"{plain['counts']}")
    return mesh["counts"]


def _par_opt() -> dict:
    return {"name": "par", "model_type": "HATModel", "scale": 4,
            "manual_seed": 0, "path": {}, "network_g": dict(PAR_NET),
            "tile": {"tile_size": 64, "tile_pad": 8, "chunk": 1},
            "train": {"optim_g": {"type": "Adam", "lr": 2e-4,
                                  "betas": [0.9, 0.99]},
                      "scheduler": {"type": "MultiStepLR",
                                    "milestones": [100], "gamma": 0.5},
                      "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
                      "ema_decay": 0}}


def _par_profiled(fn) -> tuple:
    """fn()'s result, its seconds to a synchronised card and the device
    launches of each of PAR_SYMBOLS under torch.profiler."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    names = {s: 0 for s in PAR_SYMBOLS}
    for ev in prof.events():
        for s in PAR_SYMBOLS:
            if s in ev.name:
                names[s] += 1
    return out, secs, names


def _par_warm(fn, reps: int = 3) -> float:
    """Median seconds of ``reps`` warm calls of fn, each to a synchronised
    card (both ranks call it in step)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _par_checks(rank: int) -> dict:
    """One rank's part of (b) and (c); returns its figures."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.parallel.pipeline import pipeline_forward
    from super_resolution_tpu_torch.parallel.spatial import \
        spatial_shard_forward
    from super_resolution_tpu_torch.parallel.tp import tp_attention
    from super_resolution_tpu_torch.runtime.sr_model import HATModel

    res = {}
    fns = {name: fn for name, fn in wrappers().items() if name in KERNELS}

    def counted(fn):
        for f in fns.values():
            f.launches = 0
        out = _par_profiled(fn)
        return out, {n: f.launches for n, f in fns.items()}

    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
    one = HATModel(_par_opt(), "cuda")
    tp = HATModel(_par_opt(), "cuda")
    tp.setup_training(mesh)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lq = torch.rand((1, 64, 64, 3), generator=gen, device="cuda")

    def infer(model, bf16=False):
        model.opt["val"] = {"inference_dtype": "bf16"} if bf16 else {}
        model._eval_net = None
        model.feed_data({"lq": lq})
        model._run_inference()
        return model.output.float()

    (ref, s_one, sym_one), c_one = counted(lambda: infer(one))
    (out, s_tp, sym_tp), c_tp = counted(lambda: infer(tp))
    res.update(err=float((out - ref).abs().max())
               / max(1.0, float(ref.abs().max())), s_one=s_one, s_tp=s_tp,
               sym_one=sym_one, sym_tp=sym_tp, counts_one=c_one,
               counts_tp=c_tp, warm_one=_par_warm(lambda: infer(one)),
               warm_tp=_par_warm(lambda: infer(tp)))

    # the fork's HAT under TP: its HABs and its OCAB's attention have no
    # TP route and launch their kernels on the whole replicated weights,
    # its OCAB tail runs hidden-parallel
    fork = build_network(dict(PAR_FORK))
    init_weights(fork, torch.Generator().manual_seed(3))
    fork = fork.to("cuda").eval()
    with torch.inference_mode():
        (f_ref, _, _), c_fork_one = counted(lambda: fork(lq))
        with tp_attention(mesh):
            (f_tp, _, _), c_fork_tp = counted(lambda: fork(lq))
    res.update(fork_err=float((f_tp - f_ref).abs().max())
               / max(1.0, float(f_ref.abs().max())),
               counts_fork_one=c_fork_one, counts_fork_tp=c_fork_tp)
    out_bf16 = infer(tp, bf16=True)
    mse = float((out_bf16.clamp(0, 1) - ref.clamp(0, 1)).square().mean())
    res["psnr_bf16"] = 10 * math.log10(1.0 / max(mse, 1e-20))

    # one TP train step against the one-process step: the gradients
    gt = torch.rand((2, 256, 256, 3), generator=gen, device="cuda")
    batch = {"lq": torch.nn.functional.avg_pool2d(
        gt.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1).contiguous(),
        "gt": gt}
    one.setup_training()
    grads = {}
    for label, model in (("one", one), ("tp", tp)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.optimize_parameters(batch, 1)
        torch.cuda.synchronize()
        res[f"step_{label}"] = time.perf_counter() - t0
        res[f"loss_{label}"] = float(model.log_dict["l_pix"])
        grads[label] = {n: p.grad for n, p in
                        model.net_g.named_parameters()}
    res["grad_err"] = max(
        float((grads["tp"][n] - g).abs().max())
        / max(float(g.abs().max()), 1e-12) for n, g in grads["one"].items())

    # (c) GPipe over (pipe: 2), 2 microbatches; rows counted on rank 0
    pipe = init_device_mesh("cuda", (2,), mesh_dim_names=("pipe",))
    x2 = torch.rand((2, 64, 64, 3), generator=gen, device="cuda")
    with torch.inference_mode():
        net = one.net_g.eval()
        ref2 = net(x2)
        (pp_out, s_pp, _), c_pp = counted(
            lambda: pipeline_forward(net, x2, pipe, microbatches=2))
        res.update(warm_pp=_par_warm(
            lambda: pipeline_forward(net, x2, pipe, microbatches=2)),
            warm_pp_one=_par_warm(lambda: net(x2)))
    res.update(pp_err=float((pp_out - ref2).abs().max())
               / max(1.0, float(ref2.abs().max())), s_pp=s_pp,
               counts_pp=c_pp)

    # row-sharded inference of an exact-receptive-field CNN (radius 7)
    data = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
    ks = [torch.randn(shape, generator=gen, device="cuda") * 0.1 for shape in
          ((32, 3, 5, 5), (32, 32, 5, 5), (32, 32, 5, 5), (48, 32, 3, 3))]

    def cnn(x):
        y = x.permute(0, 3, 1, 2)
        for k in ks[:-1]:
            y = torch.nn.functional.leaky_relu(
                torch.nn.functional.conv2d(y, k, padding=k.shape[-1] // 2))
        y = torch.nn.functional.pixel_shuffle(
            torch.nn.functional.conv2d(y, ks[-1], padding=1), 4)
        return y.permute(0, 2, 3, 1)

    img = torch.rand((1, 512, 512, 3), generator=gen, device="cuda")
    with torch.inference_mode():
        whole = cnn(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded = spatial_shard_forward(cnn, img, 4, data, halo=8)
        torch.cuda.synchronize()
        res["s_spatial"] = time.perf_counter() - t0
    res["spatial_err"] = (float((sharded - whole).abs().max())
                          / max(1.0, float(whole.abs().max())))
    return res


def _par_rank(rank: int, store: str, out_dir: str) -> None:
    """A rank of (b) and (c): joins the gloo group on cuda:0 (NCCL refuses
    two ranks on one card) and writes its figures or its error."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        res = _par_checks(rank)
    except Exception:  # handed to the parent, which raises
        res = {"error": traceback.format_exc()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def par_two_ranks(root: str, card: str) -> dict:
    """(b) and (c) on two spawned ranks; checks their figures and returns
    rank 0's launch counts of the tensor-parallel forward and of the
    pipelined one."""
    import torch.multiprocessing as mp

    out_dir = os.path.join(root, "par_ranks")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    mp.start_processes(_par_rank, args=(os.path.join(out_dir, "store"),
                                        out_dir),
                       nprocs=2, join=True, start_method="spawn")
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        if "error" in ranks[r]:
            raise AssertionError(f"[par] rank {r} failed:\n"
                                 f"{ranks[r]['error']}")
    log(f"[par:b] two ranks joined, checked and left in "
        f"{time.perf_counter() - t0:.1f} s")
    rows = set(PAR_CALLS)
    for r, res in enumerate(ranks):
        tp_rows = {k: v for k, v in res["counts_tp"].items() if v}
        one_rows = {k: v for k, v in res["counts_one"].items() if v}
        log(f"[par:b] {card}: rank {r}: HATClassic x4 (C 180, 6 heads, "
            f"window 16, hidden 360, 2 RHAGs), one 64 x 64 tile, (model: 2): "
            f"float32 max err {res['err']:.3e} of scale against one process; "
            f"bf16 PSNR {res['psnr_bf16']:.2f} dB against the float32 "
            f"one-process output; {res['s_tp']:.3f} s against "
            f"{res['s_one']:.3f} s (first calls, profiled), warm "
            f"{res['warm_tp']:.4f} s against {res['warm_one']:.4f} s "
            f"(median of 3); launches {tp_rows} against "
            f"{one_rows}; trace kernels {res['sym_tp']} against "
            f"{res['sym_one']}; train step loss {res['loss_tp']:.6f} "
            f"against {res['loss_one']:.6f}, grads max err "
            f"{res['grad_err']:.3e} of each tensor's scale, "
            f"{res['step_tp']:.3f} s against {res['step_one']:.3f} s")
        fork_tp = {k: v for k, v in res["counts_fork_tp"].items() if v}
        fork_one = {k: v for k, v in res["counts_fork_one"].items() if v}
        log(f"[par:b] {card}: rank {r}: the fork's HAT x2 (C 180, 2 RHAGs) "
            f"under tp_attention, one 64 x 64 input: max err "
            f"{res['fork_err']:.3e} of scale against one process; launches "
            f"{fork_tp} against {fork_one}")
        log(f"[par:c] {card}: rank {r}: pipeline_forward (pipe: 2, 2 "
            f"microbatches of one 64 x 64 image) max err {res['pp_err']:.3e} "
            f"of scale, {res['s_pp']:.3f} s, warm {res['warm_pp']:.4f} s "
            f"against {res['warm_pp_one']:.4f} s in one process; "
            f"spatial_shard_forward of a "
            f"512 x 512 image (a CNN of receptive radius 7, halo 8) max err "
            f"{res['spatial_err']:.3e} of scale, {res['s_spatial']:.3f} s")
        if (res["err"] > TOL_F32 or res["psnr_bf16"] < PAR_PSNR
                or tp_rows != PAR_CALLS or one_rows != PAR_CALLS
                or set(tp_rows) != rows or res["sym_tp"] != res["sym_one"]
                or not all(res["sym_tp"].values())
                or res["grad_err"] > TOL_F32
                or abs(res["loss_tp"] - res["loss_one"])
                > TOL_F32 * abs(res["loss_one"])
                or res["fork_err"] > TOL_F32
                or fork_tp != PAR_FORK_CALLS or fork_one != PAR_FORK_CALLS
                or res["pp_err"] > TOL_F32 or res["spatial_err"] > 1e-5
                or {k: v for k, v in res["counts_pp"].items() if v} != {
                    k: v // 2 * PAR_PP_TICKS for k, v in PAR_CALLS.items()}):
            raise AssertionError(f"[par] rank {r}: a check failed: {res}")
    return {"parallel_tp": ranks[0]["counts_tp"],
            "parallel_tp_fork": ranks[0]["counts_fork_tp"],
            "parallel_pp": ranks[0]["counts_pp"]}


def par_main() -> None:
    """Phase 15 alone (``python3 -c "import chip_smoke;
    chip_smoke.par_main()"``), after the build and phase 6's data."""
    import torch

    from super_resolution_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda_build.build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        sets = write_eval_sets(root)
        sets.update(write_train_pairs(root, sets))
        by_path = par_phase(sets, root, card)
    log(f"[par] phase 15 done in {time.perf_counter() - t0:.1f} s; "
        f"launches {by_path}")


def par_phase(sets: dict, root: str, card: str) -> dict:
    """Phase 15: (a), then (b) and (c). Returns the launch counts of each
    path."""
    t0 = time.perf_counter()
    by_path = {"parallel_dp1": par_world_of_one(sets, root, card)}
    log(f"[par:a] done in {time.perf_counter() - t0:.1f} s")
    by_path.update(par_two_ranks(root, card))
    return by_path


def _short_names(mangled) -> dict:
    """Mangled kernel name -> ``name<template arguments>`` (c++filt, where
    the toolkit's host compiler brought it)."""
    tool = shutil.which("c++filt")
    if tool is None or not mangled:
        return {m: m for m in mangled}
    out = subprocess.run([tool], input="\n".join(mangled), text=True,
                         capture_output=True, timeout=60,
                         check=True).stdout.splitlines()
    return {m: re.sub(r"\(anonymous namespace\)::|^void ", "",
                      d).split("(")[0]
            for m, d in zip(mangled, out)}


def build_report(lib, ptxas: str) -> None:
    """Phase 2's report: each kernel's registers, stack and spills from
    ptxas's report (``ptxas``: empty where the library was built before)
    and its HMMA instructions from the SASS. Raises if a tensor-core kernel
    (``mma_*``) holds none."""
    from super_resolution_tpu_torch.ops import cuda_attention as ca
    from super_resolution_tpu_torch.ops import cuda_build
    from super_resolution_tpu_torch.ops import cuda_ffn as cf
    from super_resolution_tpu_torch.ops import cuda_hab as ch
    from super_resolution_tpu_torch.ops import cuda_hab_block as chb
    from super_resolution_tpu_torch.ops import cuda_psa as cp
    from super_resolution_tpu_torch.ops import cuda_scc as cs
    from super_resolution_tpu_torch.ops import cuda_window_attention as cw

    usage, fn = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            usage[fn] = []
        elif fn is not None and ("bytes stack" in line
                                 or "registers" in line):
            usage[fn].append(line.split(" : ")[-1].strip())
    tool = (shutil.which("cuobjdump")
            or shutil.which("cuobjdump",
                            path=os.path.dirname(cuda_build._nvcc())))
    hmma = {}
    if tool is None:
        log("  cuobjdump not found: no SASS report")
    else:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                hmma.setdefault(fn, 0)
            elif fn in hmma and "HMMA" in line:
                hmma[fn] += 1
    names = _short_names(sorted(set(usage) | set(hmma)))
    for fn in sorted(names, key=names.get):
        parts = usage.get(fn, []) + ([f"{hmma[fn]} HMMA"] if fn in hmma
                                     else [])
        log(f"  {names[fn]}: {'; '.join(parts)}")
    scc_smem = " / ".join(
        str(cs.mma_scc_block_smem(w, w, min(w, 8), min(w, 8), SCC_SHAPE[3]))
        for w in SCC_WINDOWS)
    log(f"  tensor-core attention: {cw.mma_attention_smem(16)} / "
        f"{cw.mma_attention_smem(32)} bytes of shared memory a block at "
        f"head dim 16 / 32; fused_psa_block's "
        f"{cp.mma_psa_block_smem(C, HEADS)} at SRFormer's width (C {C}, "
        f"{HEADS} heads); fused_msa_attention's "
        f"{cw.mma_msa_attention_smem(35, False)} / "
        f"{cw.mma_msa_attention_smem(35, True)} at ATD's head dim 35 "
        f"without / with a mask; fused_ocab_block's projections "
        f"{ca.mma_ocab_block_smem(C, C)} at C {C}; fused_msa_block's "
        f"projections {ca.mma_msa_block_smem(C, C)}, its attention "
        f"{cw.mma_msa_attention_smem(C // HEADS, False)} / "
        f"{cw.mma_msa_attention_smem(C // HEADS, True)} at head dim "
        f"{C // HEADS}; the MLP tail's {cf.mma_mlp_tail_smem(60)} / "
        f"{cf.mma_mlp_tail_smem(C)} / {cf.mma_mlp_tail_smem(240)} at C 60 / "
        f"{C} / 240, any hidden width; the gated FFN's "
        f"{cf.mma_gated_ffn_smem(C, C)} / {cf.mma_gated_ffn_smem(144, 144)}"
        f" / {cf.mma_gated_ffn_smem(C, 36)} at C {C} / 144 / C {C} to 36, "
        f"any M; fused_hab_block's {chb.mma_hab_block_smem(C, HEADS)} at "
        f"C {C} in {HEADS} heads; hab_front's "
        f"{ch.mma_hab_front_smem(C, FRONT_MID)} / "
        f"{ch.mma_hab_front_smem(144, 6)} at C / MID {C} / {FRONT_MID} and "
        f"144 / 6; fused_scc_block's {scc_smem} at HiT-SRF's windows "
        f"{' / '.join(map(str, SCC_WINDOWS))}")
    bare = [names[fn] for fn, n in hmma.items() if "mma_" in names[fn]
            and n == 0]
    if bare or (hmma and not any("mma_" in names[fn] for fn in hmma)):
        raise AssertionError(f"no HMMA in the tensor-core kernels: {bare}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from super_resolution_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    props = torch.cuda.get_device_properties(0)
    log(f"[probe] {props.multi_processor_count} SMs, L2 "
        f"{props.L2_cache_size / 2 ** 20:.0f} MiB, memory "
        f"{props.total_memory / 2 ** 30:.1f} GiB")
    log(card)

    t0 = time.perf_counter()
    lib, out = cuda_build.build(verbose=True)
    cuda_build.load_library()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    build_report(lib, out)

    t0 = time.perf_counter()
    log("[kernels] tolerances: float32 "
        f"{TOL_F32} x max(1, max|plain|), bf16 {TOL_BF16} x max(1, max|plain|)"
        f"; bounds against {PEAK}")
    timing = check_kernels()
    timing["ln_split"].update(check_ln_split())
    timing.update(check_attention_kernels())
    timing.update(check_image_attention_kernels())
    timing.update(check_scc_kernel())
    check_msa_block_kernels()
    check_mlp_tail_kernels()
    check_gated_ffn_kernels()
    check_front_kernels()
    check_whole_image_kernels()
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")

    by_path, first_outputs = {}, {}
    for label, spec in PATHS.items():
        t0 = time.perf_counter()
        log(f"[main:{label}] Predictor -> runner in tile mode -> "
            f"{spec['net']['type']} x{net_scale(spec['net'])} at the "
            f"published width, bf16")
        by_path[label] = main_path(label, first_outputs)
        log(f"[main:{label}] done in {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as root:
        sets = write_eval_sets(root)
        f32_outputs = {}
        for label, spec in EVAL_PATHS.items():
            t0 = time.perf_counter()
            log(f"[eval:{label}] test pipeline -> {spec['yml']} "
                f"({'bf16' if spec['bf16'] else 'float32'}), the file's "
                f"data roots, weights and results root overridden")
            by_path[label] = eval_path(label, sets, root, card, f32_outputs)
            log(f"[eval:{label}] done in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        log("[train] the four kernels of a train step through their "
            "autograd entries (kernel forward, plain backward)")
        check_train_functions()
        sets.update(write_train_pairs(root, sets))
        log(f"[train] done in {time.perf_counter() - t0:.1f} s; "
            f"{TRAIN_PAIRS} synthetic pairs written")
        for label, spec in TRAIN_PATHS.items():
            by_path[label] = run_train_path(label, spec, sets, root, card)

        t7 = time.perf_counter()
        log("[esc_train] the four autograd entries ESC training and the "
            "fork's HAT x2 add (kernel forward, plain backward)")
        check_esc_train_functions()
        log(f"[esc_train] entries done in {time.perf_counter() - t7:.1f} s")
        for label, spec in ESC_TRAIN_PATHS.items():
            by_path[label] = run_train_path(label, spec, sets, root, card)
        log(f"[esc_train] phase 7 done in {time.perf_counter() - t7:.1f} s")

        t8 = time.perf_counter()
        log("[real] real-world GAN training: the synthesizer on the card "
            "against the CPU, then the four shipped real-world files")
        check_synth_card_vs_cpu()
        from super_resolution_tpu_torch.models.vgg_arch import \
            seeded_vgg19_state_dict
        vgg = os.path.join(root, "vgg19.pth")
        torch.save(seeded_vgg19_state_dict(0), vgg)
        gt_root = write_real_gt(root)
        log(f"[real] {REAL_IMAGES} GT images of 400 to 480 a side; VGG19: "
            f"seeded random weights under torchvision's names ({vgg})")
        for label, spec in REAL_TRAIN_PATHS.items():
            t0 = time.perf_counter()
            log(f"[real:{label}] train pipeline -> {spec['yml']}, the "
                f"file's network and batch")
            by_path[label] = real_train_path(label, spec, gt_root, vgg,
                                             root, card)
            log(f"[real:{label}] done in {time.perf_counter() - t0:.1f} s")
        log(f"[real] phase 8 done in {time.perf_counter() - t8:.1f} s")

        t9 = time.perf_counter()
        log("[hatx] HATX x2 through the train pipeline (no kernel: plain "
            "PyTorch, as in JAX), then a HybridHATNAF forward")
        for label, spec in HATX_TRAIN_PATHS.items():
            by_path[label] = run_train_path(label, spec, sets, root, card)
        by_path["hybrid_hat_naf"] = check_hybrid_hat_naf(card)
        log(f"[hatx] phase 9 done in {time.perf_counter() - t9:.1f} s")

        t10 = time.perf_counter()
        log("[arb] the autograd entries the arb encoders train through "
            "(kernel forward, plain backward)")
        check_arb_train_functions()
        log(f"[arb] entries done in {time.perf_counter() - t10:.1f} s")
        for name in ARB_ENCODERS:
            by_path[f"arb_lte_{name}"] = arb_encoder_path(name, card)
        by_path["arb_eval"] = arb_eval_path(sets, root, card)
        data = write_arb_gt(root)
        for name in ARB_TRAIN:
            by_path[f"arb_{name[6:-4]}"] = arb_train_path(name, data, root,
                                                          card)
        log(f"[arb] phase 10 done in {time.perf_counter() - t10:.1f} s")

        t11 = time.perf_counter()
        log("[route] the autograd entries of rows 3, 4, 13, 15, 16, 18 and "
            "the bare gated FFN (kernel forward, plain backward)")
        check_route_train_functions()
        log(f"[route] entries done in {time.perf_counter() - t11:.1f} s")
        for label, spec in ROUTE_TRAIN_PATHS.items():
            t0 = time.perf_counter()
            by_path[label] = route_train_path(label, spec, sets, root, card)
            log(f"[route:{label}] done in {time.perf_counter() - t0:.1f} s")
        meta = write_gan_meta(sets, root)
        for label, spec in GAN_TRAIN_PATHS.items():
            t0 = time.perf_counter()
            by_path[label] = gan_train_path(label, spec, sets, meta, vgg,
                                            root, card)
            log(f"[gan:{label}] done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        by_path["esr_perceptual"] = esr_perceptual_path(sets, vgg, root,
                                                        card)
        log(f"[esr:esr_perceptual] done in {time.perf_counter() - t0:.1f} s")
        log(f"[route] phase 11 done in {time.perf_counter() - t11:.1f} s")

        t12 = time.perf_counter()
        log("[eval_surface] bucketed tiled validation, the x8 "
            "self-ensemble, the LMDB and RawPack backends, the trace "
            "windows, the batched metrics and eval_folder")
        by_path.update(eval_surface(sets, root, card))
        log(f"[eval_surface] phase 12 done in "
            f"{time.perf_counter() - t12:.1f} s")

        t13 = time.perf_counter()
        log("[video] video SR: the plain DCN and flow warp, the seven "
            "networks at their published widths, train.py through the "
            "video runners and the video GAN runners, test.py through the "
            "video test datasets (no kernel lies on this path)")
        by_path.update(video_phase(card, root))
        log(f"[video] phase 13 done in {time.perf_counter() - t13:.1f} s")

        t14 = time.perf_counter()
        log("[face] the face stack: StyleGAN2 (FIR and bilinear) and its "
            "runner through train.py, HiFaceGAN and its runner, DFDNet, "
            "the FID InceptionV3, calculate_fid and eval_folder's FID (no "
            "kernel lies on this path: it launches none of the 18 rows)")
        by_path.update(face_phase(card, root))
        log(f"[face] phase 14 done in {time.perf_counter() - t14:.1f} s")

        t15 = time.perf_counter()
        log("[par] parallelism: train.py with a mesh in an NCCL world of "
            "one; then two gloo ranks on the card: head- and "
            "hidden-parallel HATClassic (rows 1 to 6 on each rank's "
            "slice), GPipe and row-sharded inference")
        by_path.update(par_phase(sets, root, card))
        log(f"[par] phase 15 done in {time.perf_counter() - t15:.1f} s")

    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        per_path = {label: c[name] for label, c in by_path.items()}
        if not sum(per_path.values()):
            raise AssertionError(f"{name}: no main path launched it")
        kernels.append(dict(name=name, route="cuda", source=_CSRC + source,
                            replaces=_POPS + replaces,
                            launches=sum(per_path.values()),
                            launches_by_path=per_path, **timing[name]))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

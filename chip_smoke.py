#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stc_unet_tpu_torch``) on one card.

Drives the port's paths, its test path and its training path (with
the augmentation on the host and on the card) at full width, with random weights from seed 0: STC-UNet
(``my_config/STC-UNet.py``) and MaxViT-UNet
(``my_config/MaxViT-UNet.py``) inference through ``init_segmentor`` and
``model(return_loss=False, img=[...], img_metas=[...])``, STC-UNet in
slide mode (crop 256, stride 170: the 9 tiles of each 512² image run as
one batch) and in whole mode, MaxViT-UNet in whole mode (the author's
test_cfg); and the train step of each through ``make_train_step`` (Adam,
poly lr, bf16 compute, B=8 at 512², as ``bench.py`` trains). On the way it

1. records the environment (torch, CUDA, the card's name and power limit,
   torch's TF32 defaults, which the entry point runs with) and turns TF32
   off for every comparison;
2. builds the CUDA kernels from ``stc_unet_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card: K1
   ``strip_pools``, K2 ``gate_add`` and K2b ``gate_dots`` at the Up-stage
   shapes of the slide tiles and of whole 512² images, at odd shapes and
   at the edges of K1's and K2b's tiling, some with inputs off 16-byte
   alignment, with bit-identical reruns for K1 and K2b, after checking
   that each vector build of K1 and K2b holds 128-bit global loads;
   K3f ``window_attention`` and
   K3b ``window_attention_backward`` at MaxViT's B=8 stage shapes, at rate
   0.1 with the same seed (the same dropout mask), and at odd shapes and
   row layouts at rates 0 and 0.1, with bit-identical reruns of K3b, after
   checking that each of their 16 builds holds tensor-core MMAs of its
   type (bf16 or TF32); all in f32 and bf16; then every kernel of
   the three paths and P at the 65535 that a grid's y or z holds and one
   past it (N images, W windows, N·heads), against its plain version with
   bit-identical reruns (``launch_limits``);
4. serves STC-UNet slide and whole requests (B=2 at 512², bf16 images, as
   the benchmark feeds them) and checks that each forward launched K1 and
   K2 4 times; holds the card's logits on a 256² image against the port
   on the CPU (f32, TF32 off); and holds the card's logits at torch's
   TF32 defaults, which a caller of ``init_segmentor`` runs with, to the
   CPU's at 512², whole and slide, f32 (``tf32_check``: logit error
   within 1e-2 of the largest, class margin within 0.1 of its spread,
   argmax >= 0.999); then drives the test path (``test_path``): writes 64
   pseudo-KiTS 512² pairs with the port's PNG writer (checking its round
   trip and the C unfilter against the plain one), builds the config's
   test dataset and loader, runs ``single_gpu_test(pre_eval=True)`` and
   ``evaluate`` with the classes split by a shifted ``conv_seg`` bias,
   holds the first 4 images to the port on the CPU (labels, areas, mDice
   under a margin rule, with TF32 off and at torch's defaults), checks K1
   and K2 4 times a forward, and times the split end to end beside the
   model alone, ``inference_segmentor`` on a PNG path at bs 1, and PNG
   decode, the pipeline, ``collate`` and ``pre_eval`` per image;
5. times slide (B=14, 126 tiles), whole (B=8) and the bs-1 whole latency
   with CUDA events, with TF32 off, at torch's defaults and on, and breaks
   one slide forward of each down by kernel with torch.profiler; times each
   kernel at the Up-stage shapes of the B=14 slide batch (K2b: of the B=8
   train batch, bf16) beside its plain version, a one-call PyTorch
   yardstick and its bound (bytes over 3.35 TB/s), and checks it against
   its plain version there too, K1 and K2 also at the B=8 train shapes in
   bf16, where they are timed too; K1 and K2b rows give their achieved
   GB/s. Every kernel and yardstick is timed
   twice: ``ms`` with an event pair around the call (the host's time to
   queue it included, as in every earlier run) and ``device_ms`` with the
   host's work hidden behind a sleep kernel
   (``stc_unet_tpu_torch/tools/timing.py``);
6. takes two train steps at full width on the card and on the port on the
   CPU from the same weights (64², B=2, f32, TF32 off, no dropout) and
   compares the losses, the first step's gradients (each tensor against
   what a one-ulp nudge of the image and weights does to it on the CPU)
   and the BN running stats (phase ``train_check``);
7. trains at full width (phase ``train``): checks that every step launched
   K1, K2 and K2b 4 times each, that the loss is finite and that every
   parameter moved; times 10 steps after 2 warm-up steps with CUDA events
   (img/s) and records the peak memory, at torch's TF32 defaults, off and
   on, and breaks one step at the defaults down by kernel group;
8. serves MaxViT-UNet whole requests (B=2 at 512², bf16) and checks 28
   K3f launches per forward, and holds its logits to the CPU as in 4
   (``maxvit_slice``); times whole B=8 and the bs-1 p50 at torch's
   defaults, with a profile (``maxvit_timing``); times K3f and K3b at the
   B=8 stage shapes at rates 0 and 0.1 beside their plain versions, the
   ``scaled_dot_product_attention`` yardstick and their bounds
   (``window_attention_timing``); takes two train steps on the card and
   on the CPU as in 6, at 256² with one block per stage
   (``maxvit_train_check``); and trains as in 7 at torch's defaults with
   the config's dropout, each step launching K3f and K3b 28 times
   (``maxvit_train``);
9. holds the flash-attention kernels Lf, Ldkv and Ldq against their plain
   versions at the STC transformer's shapes (2 heads of 256 at x4 and x5
   of slide B=14, whole B=8 and bs 1), at odd shapes and at the edges of
   Lf's tiling, with bit-identical reruns, the same bits with TF32
   matmuls allowed and not, and the autograd Function; counts the TF32
   MMA instructions of each build of the three in the built library
   (``flash_attention_kernels``);
   serves STC-UNet with ``backbone.flash_attention=True`` and the einsum
   model's weights as in 4, 8 Lf launches per forward, its logits held to
   the flash model on the CPU and to the einsum model on the card
   (``flash_slice``); times it as
   in 5 at torch's defaults beside the einsum rows of the same run
   (``flash_timing``); times Lf, Ldkv and Ldq at one forward's or one
   step's eight calls beside their plain versions, the
   ``scaled_dot_product_attention`` yardstick and their bounds, in f32
   FMAs and in 3xTF32 on the tensor cores, and Lf at bs 1
   (``flash_attention_timing``);
   and checks and trains it as in 6 and 7 (``flash_train_check``,
   ``flash_train``: 8 Lf, 8 Ldkv and 8 Ldq launches per step);
10. runs the CoordAtt strip-pool probe
    (``stc_unet_tpu_torch/tools/probe_coordatt.py``): kernel P against its
    plain version in f32 and bf16 at the probe's stages, odd shapes, the
    edges of its tiling (C of 13 to 1024, H of 1 to 1025, W of 1 to 4097)
    and inputs off 16-byte alignment, both ways of adding its bands,
    with bit-identical reruns and 128-bit loads in each vector build, and
    one kernel a call in ``torch.profiler`` (checked on small inputs right
    after ``launch_limits``); then timed beside K1 and two ``torch.sum``
    (``coordatt_probe``);
11. trains through the port's entry point (``train_path``, after
    ``test_path``): ``stc_unet_tpu_torch.tools.train.main`` on 32 train
    and 8 test pseudo-KiTS 512² PNG pairs with the config's own pipeline,
    batch 4, 2 loader threads, f32 at torch's TF32 defaults, Adam and
    poly lr, 2 epochs with mDice and a checkpoint after each; holds the
    first batch to its CPU rebuild (bit for bit), the first step's losses
    on its 128² crop to the CPU (TF32 off), ``latest.pth``'s logits and
    mDice to the trained model's and the EvalHook's, checks K1, K2 and
    K2b's launches, and times the epochs beside the step alone; then
    (``test_cli``) runs the test CLI on its split and checkpoint; then
    (``data_parallel``) runs two ranks that share the card over gloo:
    a full-width bf16 train step at 4 images a rank against one process
    on the global 8, sharded slide and whole inference against
    unsharded, ``multi_gpu_test`` against ``single_gpu_test``, and the
    train CLI under ``python -m torch.distributed.run`` with two gloo
    ranks and with one NCCL rank, each group of processes under a
    deadline;
12. runs the train augmentation on the card (``device_pipeline``): the
    flagship's host prefix (decode, Resize to 600², uint8 padding) on 24
    learnable 512² pairs, the device program (crop, flip, photometric
    distortion, normalize) held to the CPU from one generator seed, the
    ``DeviceBatchLoader`` with and without prefetch bit-equal on the card;
    times the program beside the host prefix and the whole host pipeline
    an image;
13. runs the JAX trained-accuracy protocol (``trained_path``,
    ``stc_unet_tpu_torch.tools.parity_trained``): 15 epochs at B=8, bf16,
    with the host pipeline and then with the augmentation on the card,
    each run's checkpoint to mDice 0.9 through the test CLI, a resume
    of its last 3 epochs and a profiler trace; then the five input
    configurations of ``stc_unet_tpu_torch.tools.profile_input`` at 2
    epochs each (``profile_input``), K1, K2 and K2b 4 launches a step;
14. drives U-Net (``my_config/U-Net.py``) and the paper's monolithic
    baselines, ``EncoderDecoderFull`` with DC-UNet, UNet++, TransUNet and
    SwinUNet, at full width, none of which runs a kernel of the port
    (after ``maxvit_train``): whole requests (B=2 at 512², bf16) with no
    kernel launched and the f32 logits held to the CPU at 256² (SwinUNet
    at 512², its ``img_size``; ``monolithic_slice``), two train steps
    card vs CPU as in 6 at 64² (SwinUNet built at 64;
    ``monolithic_train_check``), and at torch's TF32 defaults whole B=8,
    the bs-1 p50 and the bf16 train step at B=8 (or the largest batch
    that fits, the out-of-memory error recorded) with peak memory
    (``monolithic_timing``, ``monolithic_train``);
15. trains rematerialised: after each train check of 6, 8 and 14, two
    steps card vs CPU in the same bands, and against the card's plain
    steps, in each mode (``remat_train_check``): STC-UNet with
    ``make_train_step(remat=True)`` (K1 and K2 8 launches a step, K2b 4),
    MaxViT-UNet's ``with_cp`` ``'block'``, ``'dots'`` and ``'attn'`` at
    256² with a block a stage (K3f twice a step, K3b once), DC-UNet's
    ``True`` and ``'hires'``; and after each timed step of 7, 8 and 14,
    the same step plain and in each mode (``remat_train``: img/s and peak
    memory; full depth, so K3f 56 and K3b 28 a MaxViT step);
16. drives PSPNet and DeepLabv3+ (``my_config/PSPNet.py``,
    ``my_config/DeepLabv3+.py``: ResNet-50 at output stride 8) as in 14,
    none of which runs a kernel of the port (``resnet_slice``,
    ``resnet_train_check``, ``resnet_timing``, ``resnet_train``);
17. drives the reference fork's live heads as in 14 (``FORK``:
    ``my_config/DC-UNet.py`` with its decode_head replaced by ResUNet,
    LinkNet, MultiResUnet, CARUnet with ``ca=True`` and CARUnet with
    ``ca``, ``denseaspp`` and ``densecadrb``), each forward and step
    checked to launch K1 7 times (CARUnet-ca), 14 times (the dense one)
    or not at all, no other kernel (``fork_slice``,
    ``fork_train_check``, ``fork_timing``, ``fork_train``); then holds
    K1 to its plain version at CARUnet's seven B=8 shapes in f32 and
    bf16 with bit-identical reruns and times it there beside two
    ``torch.sum`` and its bound (``fork_kernel_timing``);
18. drives the stock zoo's Swin-T UPerNet and PSPNet-R50-D8 with their
    auxiliary FCNHeads (``ZOO``: their published widths and classes,
    pretrained weights stripped, whole mode) as in 14, none of which
    runs a kernel of the port (``zoo_slice``, ``zoo_train_check``,
    ``zoo_timing``, ``zoo_train``: the step with each config's own
    optimizer and schedule, its log vars' auxiliary losses counted);
    then the stock PSPNet's trained protocol
    (``stc_unet_tpu_torch.tools.parity_pspnet``: 12 epochs at 256², B=8,
    bf16) to mDice 0.9 beside the JAX package's (``pspnet_trained``); the
    zoo phases run the PSPNet at one ResNetV1c-50 block a stage
    (``ZOO_ONE_BLOCK``: the trained protocol runs it whole);
19. drives, in the same ``zoo_*`` phases, the stock configs with a neck
    (``ZOO``, 150 classes): the semantic FPN-R50 (FPN at 256, FPNHead at
    128), FastFCN-R50 JPU-PSP (the JPU at 512, PSPHead on its fused map,
    an auxiliary FCNHead) and UPerNet ViT-B/16-MLN (a MultiLevelNeck at
    768, UPerHead at 512, an auxiliary FCNHead), none of which runs a
    kernel of the port; the ViT UPerNet at 4 of its 12 layers
    (``ZOO_DEPTH``: the Segmenter and DPT run ViT-B/16 at full depth),
    the FPN and FastFCN at one block a stage (``ZOO_ONE_BLOCK``);
20. drives, in the same ``zoo_*`` phases, the ViT's heads (``ZOO``, 150
    classes): SETR-PUP (ViT-L/16, a SETRUPHead of four 3x3 convs and 2x
    upsamples at 256, three auxiliary SETRUPHeads), SETR-MLA (ViT-L/16
    without its cls token, MLANeck at 256, SETRMLAHead at 4 x 128, four
    auxiliary FCNHeads), the Segmenter ViT-B/16 (its last layer through
    ``final_norm``, a mask transformer of 2 layers at 768) and DPT ViT-B/16
    (its 14² position grid resized to 32², the cls token read out by a
    projection, reassembled and fused at 256), none of which runs a kernel
    of the port.

    python3 chip_smoke.py
    python3 chip_smoke.py --grad-readings 3   # GRAD_FLOORS' readings

Each phase prints one JSON line; then come the card's name and power limit
(as nvidia-smi gives them), the kernels' JSON line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the exit code is not 0 and no result line is printed.
Without CUDA, or outside a checkout of the repo, it exits 1 at once.
"""
from __future__ import annotations

import argparse
import copy
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
TF32_FLOPS = 495e12          # H100 SXM TF32 tensor cores, dense
# exponentials: 16 per SM per clock (the special-function units), 132 SMs
# at the 1.98 GHz clock of the f32 rate (132 SMs x 128 lanes x 2 flops)
EXPS_PER_S = 132 * 16 * F32_FLOPS / (132 * 128 * 2)
STAGES = [(32, 32, 1024), (64, 64, 512), (128, 128, 256), (256, 256, 128)]
WHOLE_STAGES = [(2 * h, 2 * w, c) for h, w, c in STAGES]   # 512² images
TRAIN_BATCH = 8              # bench.py's train step: B=8 at 512², bf16
ODD = [(3, 37, 53, 24), (2, 19, 23, 13), (1, 130, 71, 40)]
# edges of K1's and K2b's tiling (64 rows a band, channel tiles of 64 bf16
# or 32 f32 in 16-byte vectors, else one element a lane; chunks of 16 or 32
# pixels in groups of 8): C of 13, 24, 40 and 1024; H of 1, 64, 65, 513 and
# 1025 (past 8 bands); W of 1 and 2049. STRIP_UNALIGNED also run with every
# input one element past a 16-byte boundary (the scalar path).
STRIP_EDGES = [(2, 5, 7, 13), (3, 9, 11, 24), (1, 33, 6, 40),
               (2, 64, 3, 1024), (3, 1, 5, 64), (2, 64, 9, 64),
               (1, 65, 7, 64), (1, 513, 3, 64), (1, 1025, 2, 32),
               (2, 5, 1, 64), (1, 5, 2049, 64), (1, 70, 2049, 32)]
STRIP_UNALIGNED = [(2, 64, 3, 1024), (1, 65, 7, 64), (1, 5, 2049, 64)]
# edges of P's tiling (bands of up to 64 rows, added in a cluster up to 8
# bands and by the last band block past 8; channel tiles of 64 bf16 or 32
# f32 in 16-byte vectors, else 8 channels of one element a lane; chunks of
# 16 or 32 pixels, runs of 32 chunks): C of 13, 24, 40 and 1024; H of 1,
# 63, 64, 65, 513 and 1025; W of 1, 1753 (past P's old limit of 1752),
# 2049 and 4097. P_UNALIGNED also run one element past a 16-byte boundary.
P_EDGES = [(2, 5, 7, 13), (3, 9, 11, 24), (1, 33, 6, 40), (2, 64, 3, 1024),
           (3, 1, 5, 64), (1, 63, 7, 64), (2, 64, 9, 64), (1, 65, 7, 64),
           (1, 513, 3, 64), (1, 1025, 2, 64), (1, 1025, 3, 13),
           (2, 5, 1, 64), (1, 5, 1753, 64), (1, 5, 2049, 64),
           (1, 70, 2049, 32), (1, 9, 4097, 64), (1, 130, 4097, 32)]
P_UNALIGNED = [(2, 64, 3, 1024), (1, 65, 7, 64), (1, 5, 2049, 64),
               (1, 1025, 2, 64)]
SLIDE = dict(mode='slide', crop_size=(256, 256), stride=(170, 170))
CF_SOURCE = 'stc_unet_tpu_torch/csrc/coordatt_fused.cu'
WA_SOURCE = 'stc_unet_tpu_torch/csrc/window_attention.cu'
FA_SOURCE = 'stc_unet_tpu_torch/csrc/flash_attention.cu'
DP_SOURCE = 'stc_unet_tpu_torch/csrc/dual_pools.cu'
# L: the JAX model's flash call, and the library kernel (jax 0.9.0) it reaches
_FLASH = ('stc_unet_tpu/models/backbones/unet_backbone.py:146 -> '
          'jax/experimental/pallas/ops/tpu/flash_attention.py')
REPLACES = {'strip_pools': 'stc_unet_tpu/ops/coordatt_fused.py:94',
            'gate_add': 'stc_unet_tpu/ops/coordatt_fused.py:150',
            'gate_dots': 'stc_unet_tpu/ops/coordatt_fused.py:186',
            'window_attention': 'stc_unet_tpu/ops/window_attention.py:244',
            'window_attention_backward':
                'stc_unet_tpu/ops/window_attention.py:264',
            'flash_attention_forward': f'{_FLASH}:758',
            'flash_attention_bwd_dkv': f'{_FLASH}:1121',
            'flash_attention_bwd_dq': f'{_FLASH}:1456',
            'dual_pools': 'tools/probe_coordatt.py:100'}
KERNELS = tuple(REPLACES)
CF_KERNELS = KERNELS[:3]     # K1, K2, K2b in ops/coordatt_fused.py
WA_KERNELS = KERNELS[3:5]    # K3f, K3b in ops/window_attention.py
FA_KERNELS = KERNELS[5:8]    # Lf, Ldkv, Ldq in ops/flash_attention.py
TC_KERNELS = KERNELS[5:8]    # Lf, Ldkv, Ldq: 3xTF32 on the TF32 tensor cores
SOURCES = dict(**dict.fromkeys(CF_KERNELS, CF_SOURCE),
               **dict.fromkeys(WA_KERNELS, WA_SOURCE),
               **dict.fromkeys(FA_KERNELS, FA_SOURCE), dual_pools=DP_SOURCE)
STC_CONFIG = 'my_config/STC-UNet.py'
MAXVIT_CONFIG = 'my_config/MaxViT-UNet.py'
# U-Net and the EncoderDecoderFull baselines, none of which runs a kernel,
# each with the part its train check reports on its own (a name and a key
# fragment)
MONOLITHIC = {'my_config/U-Net.py': ('decoder', 'decode_head.up'),
              'my_config/DC-UNet.py': ('deconv', '.deconv'),
              'my_config/UNet++.py': ('nested grid', 'decode_head.x_'),
              'my_config/TransUnet.py': ('vit', '.vit.'),
              'my_config/SwinUnet.py': ('attention', '.attn.')}
# launches per forward (and per train step, which adds the backward)
STC_FORWARD = dict(strip_pools=4, gate_add=4)
STC_STEP = dict(strip_pools=4, gate_add=4, gate_dots=4)
MAXVIT_FORWARD = dict(window_attention=28)
MAXVIT_STEP = dict(window_attention=28, window_attention_backward=28)
MAXVIT_REMAT = ('block', 'dots', 'attn')   # MaxViT-UNet's with_cp tiers
DC_REMAT = (True, 'hires')                  # DC-UNet's
FLASH_FORWARD = dict(STC_FORWARD, flash_attention_forward=8)
FLASH_STEP = dict(STC_STEP, flash_attention_forward=8,
                  flash_attention_bwd_dkv=8, flash_attention_bwd_dq=8)
# The STC transformer's attention: 2 heads of d = 256, 4 calls at x4 and 4
# at x5 per forward; (N, L) per scale for slide B=14 (126 tiles of 256²),
# whole B=8 at 512² (and the B=8 train step) and whole bs 1
FA_HEADS, FA_D, FA_CALLS = 2, 256, 4
FA_SLIDE = [(126, 1024), (126, 256)]
FA_WHOLE = [(8, 4096), (8, 1024)]
FA_BS1 = [(1, 4096), (1, 1024)]
# odd shapes (N, heads, Lq, Lk, d): L of 16, 100 and 1000, d of 8, 64, 100
# and 256, Lq != Lk, no length a multiple of a tile
FA_ODD = [(2, 2, 16, 16, 8), (2, 2, 100, 100, 64), (1, 2, 1000, 1000, 256),
          (1, 3, 77, 1000, 8), (2, 1, 1000, 37, 256), (1, 2, 129, 200, 100)]
# edges of Lf's tiling (64 query rows a block, keys in tiles of 32, d
# padded to 32, 64, 128 or 256): L of 1, 63, 65 and 4097, d of 1, 33, 255
FA_EDGES = [(1, 2, 1, 1, 33), (2, 2, 1, 4097, 1), (1, 2, 63, 65, 255),
            (2, 1, 65, 63, 1), (1, 2, 4097, 4097, 255), (1, 1, 4097, 1, 33)]
# the launch limit a grid's y or z holds, which K1/K2b (N), K3f/K3b (W)
# and L (N·heads) were held to until they moved that axis to grid.x or
# into chunks; checked at it and one past it
GRID_YZ = 65535
# the TF32 check of the logits at torch's defaults, 512², whole and slide:
# limits set before its first run on the card
TF32_LIMITS = dict(logit_err_over_max=1e-2, margin_err_over_spread=0.1,
                   argmax_agreement=0.999)
# the test path: a split of pseudo-KiTS pairs written as PNG, evaluated on
# the card; the first images also on the CPU
TEST_PATH = dict(images=64, size=512, seed=0, cpu_images=4)
# the train path: the train CLI on pseudo-KiTS splits written as PNG, with
# the config's pipeline, batch 4, 2 loader threads, Adam and poly lr, for 2
# epochs, validating and checkpointing after each; its first step is held
# to the CPU on the first batch's top-left 128² (full width on the CPU)
TRAIN_PATH = dict(train=32, test=8, size=512, seed=1, epochs=2, crop=128)
# data parallelism on one card: two gloo ranks sharing cuda:0, 4 images a
# rank (the config's samples_per_gpu), slide B=14 and whole B=8 sharded,
# test_path's 64 slices through multi_gpu_test; each group of processes
# killed after ``deadline`` seconds; ``timed`` steps after the first
DATA_PARALLEL = dict(world=2, batch=4, size=512, slide=14, whole=8, test=64,
                     seed=5, timed=2, deadline=300)
# the test CLI's .ckpt resume: a tiny STC-UNet checkpoint of the JAX package
# with Adam's state (tests/fixtures/make_resume_ckpt.py)
RESUME_CKPT = 'tests/fixtures/stc_unet_tiny_adam.ckpt'
# the trained-accuracy protocol (tools/parity_trained.py's): 15 epochs at
# B=8, bf16; a second run resumes for the last 3; train steps 4 and 5
# traced by torch.profiler
TRAINED_PATH = dict(epochs=15, batch=8, resume_span=3, profile=(4, 2))
# the augmentation on the card (datasets/device_pipeline.py): 24 of
# trained_path's learnable 512² pairs through the flagship's host prefix
# (Resize to 600², DeviceFormatBundle) in 3 batches of 8; the program on
# the card against the CPU from one generator seed; the photometric step
# within the CPU tests' 1e-4 on the 0-255 scale, the rest exact
DEVICE_PIPELINE = dict(images=24, batch=8, seed=1234, photo_tol=1e-4)
# tools.profile_input's five input configurations at the JAX protocol's
# B=8, bf16, on 32 learnable pairs: 2 epochs each (the JAX record's 6, cut
# to the script's time)
PROFILE_INPUT = dict(epochs=2, batch=8, train=32)
# MaxViT's window attention at B=8, 512²: (windows W, tokens N, channels C,
# calls per forward) per stage; 32 heads, 8x8 windows and grids; the /4,
# /8 and /16 stages run in the encoder and the decoder
WA_HEADS = 32
WA_STAGES = [(2048, 64, 64, 8), (512, 64, 128, 8), (128, 64, 256, 8),
             (32, 64, 512, 4)]
# odd shapes (W, N, C, heads, layout) at the edges of K3's tiling (a warp
# per 16 rows, keys in 8 tiles of 8, d padded to 8 or 16): N of 1, 16, 33,
# 49 (7x7 windows), 63 and 64; every d (2, 4, 8, 16); W of 1 and odd ones
# not a multiple of K3b's chunk (100, 131). Layouts (``wa_inputs``): 'qkv'
# the thirds of one qkv row (row stride 3C; 3 heads of d = 2 put the k and
# v thirds 12 bytes apart in bf16), 'own' three contiguous tensors (stride
# C), 'odd' thirds of rows of 3C + 1 (2-byte aligned rows in bf16, copied
# element by element)
WA_ODD = [(100, 16, 16, 2, 'qkv'), (67, 49, 16, 4, 'qkv'),
          (5, 64, 512, 32, 'qkv'), (1, 1, 8, 4, 'qkv'),
          (131, 63, 32, 4, 'qkv'), (3, 64, 6, 3, 'qkv'),
          (7, 49, 64, 4, 'own'), (2, 64, 128, 8, 'own'),
          (9, 33, 24, 6, 'odd'), (4, 64, 64, 4, 'odd')]
WA_RATES = (0.0, 0.1)        # rate 0.1: the train step's attention dropout
# bench.py's train step
OPTIMIZER = dict(type='Adam', lr=1e-5, betas=(0.9, 0.999))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-6, by_epoch=False)
MAX_ITERS = 1000
# The least yardstick of one gradient tensor in train_check, as a share of
# its norm: f32 sums taken in another order differ by that much even where
# a one-ulp nudge of the inputs moves the tensor less.
GRAD_FLOOR = 1e-5
NUDGE_SEEDS = tuple(range(7, 15))
# A floor above GRAD_FLOOR where cuDNN's f32 algorithms (TF32 off) move a
# model's gradient tensors further from the CPU's than one-ulp nudges do:
# UNet++'s nested-grid tensors, up to 842 times their nudges' change. The
# largest error of any of its tensors in ``--grad-readings 3`` on the H100
# (encoder.s4_bn0.bias at seed 0; PERF.md §6).
GRAD_FLOORS = {'my_config/UNet++.py': 0.0175}
# the ResNet-50 baselines (output stride 8): config -> train check focus
RESNET = {'my_config/PSPNet.py': ('psp', 'decode_head.psp_modules'),
          'my_config/DeepLabv3+.py': ('aspp', 'decode_head.aspp_modules')}
REMAT_MODES = {'my_config/DC-UNet.py': DC_REMAT}
# The reference fork's live heads (ROADMAP item 19) at the JAX defaults,
# 2 classes (KiTS): each built from FORK_BASE with its decode_head
# replaced, the base config's CE + Dice kept (``fork_cfg``). name ->
# (train check focus, decode_head, launches a forward and a step):
# CARUnet's CoordAtt gates run K1 once a block, 7 blocks (14 dense).
FORK_BASE = 'my_config/DC-UNet.py'
FORK = {
    'ResUNet': (('deconv', 'decode_head.up'),
                dict(type='ResUNet', filters=(64, 128, 256, 512),
                     num_classes=2), {}),
    'LinkNet': (('decoder', 'decode_head.decoder'),
                dict(type='LinkNet', n_classes=2, num_classes=2), {}),
    'MultiResUnet': (('respath', '.respath'),
                     dict(type='MultiResUnet', filters=32, nclasses=2,
                          num_classes=2), {}),
    'CARUnet-ca': (('coordatt', '.meca'),
                   dict(type='CARUnet', ca=True, num_classes=2),
                   dict(strip_pools=7)),
    'CARUnet-ca-dense': (('coordatt', '.meca'),
                         dict(type='CARUnet', ca=True, denseaspp=True,
                              densecadrb=True, num_classes=2),
                         dict(strip_pools=14)),
}
# K1 at CARUnet's seven CoordAtt gates, (N, H, W, C) at B=8, 512²: the
# encoder's 16/32/64/64 blocks, then the decoder's 32/16/16
CARUNET_K1 = [(8, 512, 512, 16), (8, 256, 256, 32), (8, 128, 128, 64),
              (8, 64, 64, 64), (8, 128, 128, 32), (8, 256, 256, 16),
              (8, 512, 512, 16)]
# MultiResUnet's Respath lengths, from the top level down
MULTIRES_RESPATH = (4, 3, 2, 1)
# The stock zoo (ROADMAP item 20) at its published widths and classes:
# config -> (train check focus, the schedule file of its optimizer and lr
# policy, None for the config's own). The stock PSPNet's configs train with
# the 40k/80k schedules' SGD (momentum 0.9, wd 5e-4, poly 0.9); the
# semantic FPN and FastFCN with their own 160k and 80k ones (the same SGD),
# the ViT UPerNet with its AdamW (lr 6e-5, no decay on the position
# embedding, the cls token and the norms) and warmup-poly.
ZOO_SWIN = ('configs/swin/upernet_swin_tiny_patch4_window7_512x512_160k_'
            'ade20k_pretrain_224x224_1K.py')
ZOO_PSPNET = 'configs/_base_/models/pspnet_r50-d8.py'
ZOO_FPN = 'configs/sem_fpn/fpn_r50_512x512_160k_ade20k.py'
ZOO_FASTFCN = 'configs/fastfcn/fastfcn_r50-d32_jpu_psp_512x512_80k_ade20k.py'
ZOO_VIT = 'configs/vit/upernet_vit-b16_mln_512x512_160k_ade20k.py'
# The ViT's heads (item 20): SETR-PUP and SETR-MLA on ViT-L/16 (SGD, the
# heads at 10x the lr), the Segmenter's mask transformer on ViT-B/16 (SGD)
# and DPT on ViT-B/16 (AdamW, warmup-poly), each its config's own schedule
ZOO_SETR_PUP = 'configs/setr/setr_pup_512x512_160k_b16_ade20k.py'
ZOO_SETR_MLA = 'configs/setr/setr_mla_512x512_160k_b8_ade20k.py'
ZOO_SEGMENTER = ('configs/segmenter/segmenter_vit-b_mask_8x1_512x512_160k_'
                 'ade20k.py')
ZOO_DPT = 'configs/dpt/dpt_vit-b16_512x512_160k_ade20k.py'
ZOO = {ZOO_SWIN: (('swin', 'backbone.stages'), None),
       ZOO_PSPNET: (('psp', 'decode_head.psp_modules'),
                    'configs/_base_/schedules/schedule_80k.py'),
       ZOO_FPN: (('fpn', 'neck.'), None),
       ZOO_FASTFCN: (('jpu', 'neck.'), None),
       ZOO_VIT: (('vit', 'backbone.layers'), None),
       ZOO_SETR_PUP: (('setr_up', 'up_convs'), None),
       ZOO_SETR_MLA: (('setr_mla', 'decode_head.up_convs'), None),
       ZOO_SEGMENTER: (('mask_transformer', 'decode_head.'), None),
       ZOO_DPT: (('dpt', 'decode_head.'), None)}
PSPNET_TRAINED = dict(size=256, epochs=12, batch=8, min_mdice=0.9)


def fork_cfg(Config, name):
    """FORK's config ``name``: ``FORK_BASE`` with its decode_head
    replaced by the fork head, the base's loss kept."""
    cfg = Config.fromfile(os.path.join(REPO, FORK_BASE))
    cfg.model.decode_head = dict(
        FORK[name][1], loss_decode=cfg.model.decode_head.loss_decode)
    return cfg


def multires_bn_calls(key):
    """How often MultiResUnet's BN of the ``num_batches_tracked`` key
    ``key`` runs in a training forward, each run counted by torch: a
    Multiresblock's ``batch_norm1`` twice; Respath i's ``batch_norm1``
    once and, for a length L over 1, L more times, and its two common
    blocks' BNs L times; every other BN once."""
    m = re.search(r'\brespath(\d)\.(\w+)', key)
    if m is not None:
        length = MULTIRES_RESPATH[int(m.group(1)) - 1]
        if m.group(2) == 'batch_norm1':
            return 1 + length if length > 1 else 1
        if m.group(2).endswith('_common'):
            return length
    elif re.search(r'\bmultiresblock\d\.batch_norm1\.', key):
        return 2
    return 1


# The BN call counts of the configs whose BNs do not all run once a forward
BN_CALLS = {'MultiResUnet': multires_bn_calls}


# The logits' atol of a config whose logits are not held at 1e-5, card vs
# CPU: the Segmenter's ``mask_norm`` normalises the cosines of its
# patches and classes over the 150 classes, and a seeded 768-wide model's
# cosines spread about 0.04 there, so the f32 rounding of the cosines
# comes out some 25 times larger (3.05e-5 on logits of unit spread at
# 256², a first card call); JAX's own oracle holds the head at 5e-4
LOGIT_ATOL = {ZOO_SEGMENTER: 1e-4}
# The parameters a config's train step cannot move: SETR-MLA's ViT drops
# its cls token (``with_cls_token=False``, as in mmseg and JAX, which keep
# the parameter), so the token's gradient is 0, and the config's SGD has
# no weight decay
STILL = {ZOO_SETR_MLA: ('backbone.cls_token',)}
# Depth cuts of zoo configs whose backbone runs at full depth in another
# config of the script: the Segmenter and DPT run ViT-B/16 at 12 layers,
# ``pspnet_trained`` the stock PSPNet-R50-D8 (ResNetV1c-50, (3, 4, 6, 3)
# blocks) whole, and my_config/PSPNet.py its ResNet-50, dilated alike.
# The ViT UPerNet takes 4 layers through its backbone's fields
# (config -> fields, ``zoo_run_cfg``); the stock PSPNet, the semantic FPN
# and FastFCN keep the first block of each ResNet stage, cut from the
# built model (``zoo_init``), since a ResNet takes its blocks from
# ``depth`` alone.
ZOO_DEPTH = {ZOO_VIT: dict(num_layers=4, out_indices=(0, 1, 2, 3))}
ZOO_ONE_BLOCK = (ZOO_PSPNET, ZOO_FPN, ZOO_FASTFCN)


def zoo_cfg(Config, config):
    """``ZOO``'s config ``config`` as the zoo phases build it: its
    pretrained weights stripped (the segmentor's ``pretrained`` path, the
    backbone's ``Pretrained`` init_cfg), whole inference."""
    cfg = Config.fromfile(os.path.join(REPO, config))
    cfg.model.pretrained = None
    cfg.model.backbone.init_cfg = None
    cfg.model.test_cfg = dict(mode='whole')
    return cfg


def zoo_run_cfg(Config, config):
    """``zoo_cfg`` as the zoo phases run it: at the depth of
    ``ZOO_DEPTH`` where the config has one, and marked ``one_block`` for
    ``zoo_init`` if it is in ``ZOO_ONE_BLOCK``."""
    cfg = zoo_cfg(Config, config)
    cfg.model.backbone.update(ZOO_DEPTH.get(config, {}))
    cfg.one_block = config in ZOO_ONE_BLOCK
    return cfg


def zoo_init(init_segmentor):
    """``init_segmentor`` as the zoo phases call it: the model of a
    config marked ``one_block`` keeps only the first block of each ResNet
    stage (each ``ResLayer`` is an ``nn.Sequential``)."""
    def init(cfg, *args, **kwargs):
        model = init_segmentor(cfg, *args, **kwargs)
        if cfg.get('one_block'):
            for name in model.backbone.res_layers:
                del getattr(model.backbone, name)[1:]
        return model
    return init


def zoo_optim(Config, config):
    """``(optimizer, lr_config, max_iters)`` of ``ZOO``'s config: its
    own, or its schedule file's."""
    schedule = ZOO[config][1]
    cfg = Config.fromfile(os.path.join(REPO, schedule or config))
    optimizer = {k: v for k, v in cfg.optimizer.items() if k != '_delete_'}
    lr_config = {k: v for k, v in cfg.lr_config.items() if k != '_delete_'}
    return optimizer, lr_config, cfg.runner.max_iters


# the kernels a forward launches: a rematerialised step runs them again
FORWARD_KERNELS = ('strip_pools', 'gate_add', 'window_attention',
                   'flash_attention_forward')


def kernel_functions():
    """Every kernel's wrapper by name (each counts its launches)."""
    from stc_unet_tpu_torch.ops import coordatt_fused as cf
    from stc_unet_tpu_torch.ops import dual_pools as dp
    from stc_unet_tpu_torch.ops import window_attention as wa
    fa = importlib.import_module('stc_unet_tpu_torch.ops.flash_attention')
    modules = dict(**dict.fromkeys(CF_KERNELS, cf),
                   **dict.fromkeys(WA_KERNELS, wa),
                   **dict.fromkeys(FA_KERNELS, fa), dual_pools=dp)
    return {name: getattr(modules[name], name) for name in KERNELS}


def emit(phase, **fields):
    """One JSON line of ``phase``, with ``t``, the script's seconds so
    far."""
    print(json.dumps(dict(phase=phase, **fields,
                          t=round(time.perf_counter() - START, 1))),
          flush=True)


def reset_counts(kern):
    for fn in kern.values():
        fn.launches = 0


def read_counts(kern):
    return {name: fn.launches for name, fn in kern.items()}


def per_call(expected):
    """Every kernel's launches per call: ``expected``'s, else 0."""
    return {name: expected.get(name, 0) for name in KERNELS}


def set_tf32(torch, cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def metas(n, size):
    return [dict(ori_shape=(size, size, 3), img_shape=(size, size, 3),
                 pad_shape=(size, size, 3), flip=False) for _ in range(n)]


def event_ms(torch, fn, warmup=2, iters=10):
    """Median time of one call, from a CUDA event pair per call. The card
    is idle when the start event is queued, so this counts the host's time
    to queue the call too (``device_ms`` does not;
    ``stc_unet_tpu_torch/tools/timing.py``)."""
    from stc_unet_tpu_torch.tools import timing
    return timing.event_ms(fn, warmup, iters)


def device_ms(fn, warmup=2, iters=10):
    """Median device time of one call's kernels, the host's work hidden
    behind a sleep kernel queued before the start event."""
    from stc_unet_tpu_torch.tools import timing
    return timing.device_ms(fn, warmup, iters)


def timed(torch, kernel, library, plain=None, plain_iters=10):
    """A timing row: ``ms`` (event pair, host time included, as since PR
    1) and ``device_ms`` of the kernel's call, the same of the library
    call, and ``plain_ms`` of the plain version if given."""
    r = dict(ms=event_ms(torch, kernel), device_ms=device_ms(kernel),
             library_ms=event_ms(torch, library),
             library_device_ms=device_ms(library))
    if plain is not None:
        r['plain_ms'] = event_ms(torch, plain, iters=plain_iters)
    return r


def check_strip_pools(torch, cf, x):
    """K1 on x against its plain version (rtol 1e-5, atol 1e-4) and its
    own rerun (bit-identical); the max abs error."""
    sh, sw = cf.strip_pools(x)
    sh2, sw2 = cf.strip_pools(x)
    eh, ew = cf.strip_pools_reference(x)
    torch.testing.assert_close(sh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sw, ew, rtol=1e-5, atol=1e-4)
    if not (torch.equal(sh, sh2) and torch.equal(sw, sw2)):
        raise AssertionError(f'strip_pools not deterministic {x.shape}')
    return max((sh - eh).abs().max().item(), (sw - ew).abs().max().item())


def check_kernels(torch, cf, x, a_h, a_w):
    """K1 and K2 on x against their plain versions; max abs errors."""
    e1 = check_strip_pools(torch, cf, x)
    out = cf.gate_add(x, a_h, a_w)
    ref = cf.gate_add_reference(x, a_h, a_w)
    if x.dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        ulps = (out.view(torch.int16).int() -
                ref.view(torch.int16).int()).abs().max().item()
        if ulps > 1:
            raise AssertionError(f'gate_add bf16 off by {ulps} ulp')
    e2 = (out.float() - ref.float()).abs().max().item()
    return e1, e2


def check_gate_dots(torch, cf, do, a_h, a_w):
    """K2b on do against its plain version (f32 sums in another order:
    rtol 1e-5, atol 1e-4) and against its own rerun (bit-identical), and
    gate_add's autograd backward against it; the max abs error."""
    dh, dw = cf.gate_dots(do, a_h, a_w)
    dh2, dw2 = cf.gate_dots(do, a_h, a_w)
    eh, ew = cf.gate_dots_reference(do, a_h, a_w)
    torch.testing.assert_close(dh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dw, ew, rtol=1e-5, atol=1e-4)
    if not (torch.equal(dh, dh2) and torch.equal(dw, dw2)):
        raise AssertionError(f'gate_dots not deterministic {do.shape}')
    # gate_add's autograd, fed do back through a permute as the model does:
    # dx is do itself, and d a_h, d a_w are K2b's sums cast once to their
    # dtype (in bf16 that cast may land one ulp, 2^-8, apart)
    leaves = [t.clone().requires_grad_(True) for t in (do, a_h, a_w)]
    before = cf.gate_dots.launches
    cf.gate_add(*leaves).permute(0, 3, 1, 2).backward(
        do.permute(0, 3, 1, 2).contiguous())
    if cf.gate_dots.launches != before + 1 or \
            not torch.equal(leaves[0].grad, do):
        raise AssertionError(f'gate_add backward {do.shape}: no K2b launch '
                             'or dx is not do')
    tol = (dict(rtol=1e-5, atol=1e-4) if do.dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-4))
    torch.testing.assert_close(leaves[1].grad, eh.to(do.dtype), **tol)
    torch.testing.assert_close(leaves[2].grad, ew.to(do.dtype), **tol)
    return max((dh - eh).abs().max().item(), (dw - ew).abs().max().item())


def gates(torch, shape, dtype, seed):
    """x, do (N,H,W,C) and a_h (N,H,C), a_w (N,W,C) of dtype from seed."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    n, h, w, c = shape
    x = torch.randn(shape, generator=g, device='cuda').to(dtype)
    a_h = torch.rand((n, h, c), generator=g, device='cuda').to(dtype)
    a_w = torch.rand((n, w, c), generator=g, device='cuda').to(dtype)
    do = torch.randn(shape, generator=g, device='cuda').to(dtype)
    return x, do, a_h, a_w


def unaligned(torch, t):
    """A copy of t one element (2 or 4 bytes) past a 16-byte boundary: a
    contiguous slice of a larger tensor."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def strip_loads(library):
    """The global loads of each K1/K2b build of the built library, from
    ``cuobjdump -sass``: {'strip_band<bf16, 8, pools>': {'LDG.E.128...':
    n, ...}, ...}. Each vector build (4 floats or 8 bfloat16 a lane) must
    hold 128-bit global loads (or bulk or tensor-map copies)."""
    from stc_unet_tpu_torch.tools.probe_strip_pools import vector_loads
    loads = vector_loads(sass_of(library))
    vector = {k: v for k, v in loads.items() if ', 1, ' not in k}
    if len(loads) != 8 or len(vector) != 4 or not all(
            any(op.startswith(('LDG.E.128', 'UBLKCP', 'UTMALDG'))
                for op in ops) for ops in vector.values()):
        raise AssertionError(f'K1/K2b: not 8 builds, each vector build with '
                             f'128-bit or bulk loads: {loads}')
    return loads


def phase_kernels(torch, cf, library):
    """K1, K2 and K2b against their plain versions on the card, at the
    Up-stage shapes of slide tiles and of whole 512² images (N=2: the
    whole and the train geometry), odd shapes and the edges of K1's and
    K2b's tiling, some with unaligned inputs; first, each vector build of
    K1 and K2b in the built library must hold 128-bit loads."""
    loads = strip_loads(library)
    err = dict.fromkeys(KERNELS, 0.0)
    checked = []
    shapes = [(2,) + s for s in STAGES + WHOLE_STAGES] + ODD + STRIP_EDGES
    cases = [(s, False) for s in shapes] + [(s, True)
                                            for s in STRIP_UNALIGNED]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, off) in enumerate(cases):
            x, do, a_h, a_w = gates(torch, shape, dtype, i)
            if off:
                x, do, a_h, a_w = (unaligned(torch, t)
                                   for t in (x, do, a_h, a_w))
            e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
            e3 = check_gate_dots(torch, cf, do, a_h, a_w)
            for name, e in zip(KERNELS, (e1, e2, e3)):
                err[name] = max(err[name], e)
            checked.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                                unaligned=off, strip_pools_err=e1,
                                gate_add_err=e2, gate_dots_err=e3))
            del x, do, a_h, a_w
    emit('kernels', ok=True, checked=checked, strip_sass_loads=loads,
         tolerance=dict(
             strip_pools='rtol 1e-5 atol 1e-4, bit-identical reruns',
             gate_add='f32 rtol/atol 1e-6; bf16 <= 1 ulp',
             gate_dots='rtol 1e-5 atol 1e-4, bit-identical reruns; '
                       'gate_add autograd: dx == do, d a_h and d a_w '
                       'f32 rtol 1e-5 atol 1e-4, bf16 rtol 2^-7'))
    return err


def wa_inputs(torch, w, n, c, heads, dtype, seed, layout='qkv'):
    """q, k, v (W, N, C), bias_e (N, heads·N) f32, a seed and do (W, N, C).
    ``layout``: 'qkv' the thirds of one qkv tensor, as the model gives
    them (row stride 3C); 'own' three contiguous tensors (stride C); 'odd'
    the thirds of rows of 3C + 1 elements."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    if layout == 'own':
        q, k, v = (torch.randn((w, n, c), generator=g, device='cuda')
                   .to(dtype) for _ in range(3))
    else:
        row = 3 * c + (layout == 'odd')
        qkv = torch.randn((w, n, row), generator=g, device='cuda').to(dtype)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:3 * c]
    bias_e = 0.1 * torch.randn((n, heads * n), generator=g, device='cuda')
    sd = torch.randint(2 ** 62, (1,), generator=g, device='cuda')
    do = torch.randn((w, n, c), generator=g, device='cuda').to(dtype)
    return q, k, v, bias_e, sd, do


def wa_tolerance(torch, name, ref, dtype):
    """The limits of one K3 output against its plain version. f32: sums in
    another order, rtol 1e-4 and atol 1e-5 of the largest value. bf16 (dq,
    dk, dv and out, rounded to bf16): the plain version may round an
    attention weight or a ds entry to the other bf16 neighbour, and the
    result once more, so rtol 2^-7 and atol 2^-7 of the largest value.
    dbias is f32 in both."""
    top = ref.float().abs().max().item()
    if dtype == torch.float32 or name == 'dbias':
        return dict(rtol=1e-4, atol=1e-5 * top)
    return dict(rtol=2 ** -7, atol=2 ** -7 * top)


def check_window_attention(torch, wa, inputs, heads, rate):
    """K3f and K3b (direct and through autograd) against their plain
    versions at ``rate`` with the same seed; K3b's rerun bit-identical.
    Returns the two max abs errors."""
    q, k, v, bias_e, sd, do = inputs
    scale = heads ** -0.5
    out = wa.window_attention(q, k, v, bias_e, sd, heads, scale, rate)
    ref = wa.window_attention_reference(q, k, v, bias_e, sd, heads, scale,
                                        rate)
    torch.testing.assert_close(out.float(), ref.float(),
                               **wa_tolerance(torch, 'out', ref, q.dtype))
    e_fwd = (out.float() - ref.float()).abs().max().item()
    do = do.contiguous()
    grads = wa.window_attention_backward(q, k, v, bias_e, sd, do, heads,
                                         scale, rate)
    again = wa.window_attention_backward(q, k, v, bias_e, sd, do, heads,
                                         scale, rate)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f'window_attention_backward not deterministic '
                             f'{tuple(q.shape)}')
    refs = wa.window_attention_backward_reference(q, k, v, bias_e, sd, do,
                                                  heads, scale, rate)
    e_bwd = 0.0
    for name, got, want in zip(('dq', 'dk', 'dv', 'dbias'), grads, refs):
        torch.testing.assert_close(got.float(), want.float(),
                                   **wa_tolerance(torch, name, want,
                                                  q.dtype),
                                   msg=lambda m: f'{name}: {m}')
        e_bwd = max(e_bwd, (got.float() - want.float()).abs().max().item())
    # the autograd Function: its backward is one K3b launch, the same one
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias_e)]
    before = wa.window_attention_backward.launches
    wa.window_attention(*leaves, sd, heads, scale, rate).backward(do)
    if wa.window_attention_backward.launches != before + 1 or not all(
            torch.equal(leaf.grad, g) for leaf, g in zip(leaves, grads)):
        raise AssertionError(f'window_attention autograd {tuple(q.shape)}: '
                             'not one K3b launch with its gradients')
    return e_fwd, e_bwd


def wa_mmas(library):
    """The tensor-core MMA instructions of each K3 kernel of the built
    library, from ``cuobjdump -sass``: {'wa_fwd<bf16, 2>': {'bf16': n,
    'tf32': m}, ...}."""
    from stc_unet_tpu_torch.tools.probe_window_attention import kernel_name
    counts, fn = {}, None
    for line in sass_of(library).splitlines():
        if 'Function :' in line:
            fn = kernel_name(line)
            if fn:
                counts[fn] = dict(bf16=0, tf32=0)
        elif fn and 'MMA' in line:
            for kind in ('bf16', 'tf32'):
                counts[fn][kind] += kind.upper() in line
    return counts


def wa_usage(wa, log):
    """Each K3 build's registers and spill bytes (``nvcc -Xptxas=-v``'s
    log) and its dynamic shared memory a block, as the library gives it."""
    from stc_unet_tpu_torch.tools.probe_window_attention import ptxas_usage
    usage = ptxas_usage(log)
    for name, u in usage.items():
        kernel, dtype, d = re.match(r'wa_(\w+)<(\w+), (\d+)>', name).groups()
        u['smem_bytes'] = wa._kernels().stc_window_attention_smem(
            kernel == 'bwd', int(dtype == 'bf16'), int(d))
    return usage


def phase_window_attention_kernels(torch, wa, lib):
    """K3f and K3b against their plain versions on the card: at the B=8
    stage shapes of MaxViT-UNet (32 heads, 8x8 windows) in f32 and bf16 at
    rate 0; at a small W at rate 0.1 with the same seed, at the rate-0
    limits (a weight dropped differently would move its output by about
    |v|/64, far beyond them: agreement means the same mask); at odd shapes
    and layouts (``WA_ODD``) at rates 0 and 0.1. First, each of the 16
    builds (K3f and K3b, 2 types, 4 head widths) must hold tensor-core
    MMAs of its type: bf16 in the bf16 builds, TF32 in the f32 ones."""
    mmas = wa_mmas(str(lib['path']))
    want = {f'{k}<{t}, {d}>' for k in ('wa_fwd', 'wa_bwd')
            for t in ('f32', 'bf16') for d in (2, 4, 8, 16)}
    if set(mmas) != want or not all(
            v['bf16' if 'bf16' in k else 'tf32'] for k, v in mmas.items()):
        raise AssertionError(f'K3f and K3b: not 16 builds, each with MMAs '
                             f'of its type: {mmas}')
    err = dict.fromkeys(WA_KERNELS, 0.0)
    checked = []
    cases = [(w, n, c, WA_HEADS, 0.0, 'qkv') for w, n, c, _ in WA_STAGES]
    cases += [(16, 64, 64, WA_HEADS, 0.1, 'qkv'),
              (5, 64, 512, WA_HEADS, 0.1, 'qkv')]
    cases += [(w, n, c, h, r, layout) for w, n, c, h, layout in WA_ODD
              for r in WA_RATES]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (w, n, c, h, rate, layout) in enumerate(cases):
            inputs = wa_inputs(torch, w, n, c, h, dtype, 10 + i, layout)
            e_fwd, e_bwd = check_window_attention(torch, wa, inputs, h, rate)
            if rate > 0:
                q, k, v, bias_e, sd, _ = inputs
                nodrop = wa.window_attention_reference(q, k, v, bias_e, sd,
                                                       h, h ** -0.5)
                out = wa.window_attention(q, k, v, bias_e, sd, h, h ** -0.5,
                                          rate)
                moved = (out.float() - nodrop.float()).abs().max().item()
            err['window_attention'] = max(err['window_attention'], e_fwd)
            err['window_attention_backward'] = max(
                err['window_attention_backward'], e_bwd)
            checked.append(dict(
                shape=[w, n, c], heads=h, dtype=str(dtype)[6:], rate=rate,
                layout=layout, row_stride=inputs[0].stride(1),
                window_attention_err=e_fwd,
                window_attention_backward_err=e_bwd,
                **(dict(dropout_moves_out_by=moved) if rate > 0 else {})))
            del inputs
        torch.cuda.empty_cache()
    emit('window_attention_kernels', ok=True, checked=checked,
         sass_mmas=mmas, ptxas=wa_usage(wa, lib['log']),
         tolerance=dict(
             float32='rtol 1e-4, atol 1e-5 of the largest value',
             bfloat16='dq, dk, dv, out: rtol 2^-7, atol 2^-7 of the '
                      'largest value; dbias as f32',
             rate='0.1 against the plain version with the same seed, at '
                  'the rate-0 limits',
             determinism='two K3b runs bit-identical; the autograd '
                         'backward is one K3b launch with the same '
                         'gradients'))
    return err


def sdpa_heads(torch, t, heads):
    """(W, N, C) -> a contiguous (W, heads, N, d) leaf that needs grad."""
    w, n, c = t.shape
    return t.reshape(w, n, heads, c // heads).transpose(1, 2).contiguous(
    ).requires_grad_(True)


def phase_window_attention_timing(torch, wa, err):
    """K3f and K3b at the B=8 stage shapes of MaxViT-UNet in bf16, at rates
    0 and 0.1 (the train step's), each beside its plain version and a
    PyTorch yardstick (``F.scaled_dot_product_attention`` with the bias as
    its mask and the same dropout rate, and its autograd backward), with
    its bound; each held against its plain version on those inputs, its
    error folded into err. Returns the rate-0 rows (the kernels line's)."""
    import torch.nn.functional as F
    rows = {rate: {name: [] for name in WA_KERNELS} for rate in WA_RATES}
    h = WA_HEADS
    scale = h ** -0.5
    for i, (w, n, c, calls) in enumerate(WA_STAGES):
        inputs = wa_inputs(torch, w, n, c, h, torch.bfloat16, 200 + i)
        q, k, v, bias_e, sd, do = inputs
        do = do.contiguous()
        qh, kh, vh = (sdpa_heads(torch, t, h) for t in (q, k, v))
        mask = bias_e.reshape(n, h, n).transpose(0, 1)[None].to(
            torch.bfloat16).contiguous().requires_grad_(True)
        doh = do.reshape(w, n, h, c // h).transpose(1, 2).contiguous()
        elems = w * n * c * 2                 # bytes of one (W, N, C) bf16
        exps = w * h * n * n
        dots = 2 * w * n * n * c              # flops of one N x N x d product
        for rate in WA_RATES:
            e_fwd, e_bwd = check_window_attention(torch, wa, inputs, h, rate)
            err['window_attention'] = max(err['window_attention'], e_fwd)
            err['window_attention_backward'] = max(
                err['window_attention_backward'], e_bwd)
            sdpa_out = F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, dropout_p=rate, scale=scale)
            fwd = timed(
                torch,
                lambda: wa.window_attention(q, k, v, bias_e, sd, h, scale,
                                            rate),
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, dropout_p=rate,
                    scale=scale),
                lambda: wa.window_attention_reference(
                    q, k, v, bias_e, sd, h, scale, rate), plain_iters=3)
            fwd.update(bytes=4 * elems + bias_e.numel() * 4, exps=exps,
                       flops=2 * dots, max_abs_err=e_fwd)
            bwd = timed(
                torch,
                lambda: wa.window_attention_backward(q, k, v, bias_e, sd, do,
                                                     h, scale, rate),
                lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh, mask),
                                            doh, retain_graph=True),
                lambda: wa.window_attention_backward_reference(
                    q, k, v, bias_e, sd, do, h, scale, rate), plain_iters=3)
            bwd.update(bytes=7 * elems + 2 * bias_e.numel() * 4, exps=exps,
                       flops=5 * dots, max_abs_err=e_bwd)
            for name, r in zip(WA_KERNELS, (fwd, bwd)):
                r.update(shape=[w, n, c], heads=h, calls=calls, rate=rate)
                rows[rate][name].append(bound(r, BF16_FLOPS))
            del sdpa_out
        del inputs, q, k, v, do, qh, kh, vh, mask, doh
        torch.cuda.empty_cache()
    keys = ('ms', 'device_ms', 'plain_ms', 'library_ms', 'library_device_ms',
            'bound_ms')
    emit('window_attention_timing', dtype='bfloat16', batch=TRAIN_BATCH,
         library=dict(
             window_attention='F.scaled_dot_product_attention(q, k, v, '
                              'attn_mask=bias (1, H, N, N) bf16, '
                              'dropout_p=rate, scale)',
             window_attention_backward='torch.autograd.grad of it to q, '
                                       'k, v and the mask'),
         timer='ms: CUDA event pair, host time included (as in earlier runs); '
               'device_ms: the host hidden behind a sleep kernel',
         bound='largest of bytes / 3.35 TB/s, exponentials / 4.2e12 per '
               's, dot-product flops / 989 TFLOP/s (bf16); no Philox work '
               'counted at rate 0.1',
         rates={str(rate): dict(stages=per, **{
             f'{name}_total_{key}': sum(r['calls'] * r[key]
                                        for r in per[name])
             for name in WA_KERNELS for key in keys})
             for rate, per in rows.items()})
    return rows[0.0]


def fa_inputs(torch, n, h, lq, lk, d, seed):
    """q, k, v, do (N, heads, L, d) f32. Where Lq == Lk they are laid out
    as the model gives them: views of (N, L, heads·d) rows."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    if lq != lk:
        return (torch.randn((n, h, lq, d), generator=g, device='cuda'),
                torch.randn((n, h, lk, d), generator=g, device='cuda'),
                torch.randn((n, h, lk, d), generator=g, device='cuda'),
                torch.randn((n, h, lq, d), generator=g, device='cuda'))
    return tuple(torch.randn((n, lq, h * d), generator=g, device='cuda')
                 .reshape(n, lq, h, d).transpose(1, 2) for _ in range(4))


def fa_close(torch, got, want, what):
    """f32 sums in another order and an online softmax: rtol 1e-4, atol
    1e-5 of the largest value. The max abs error."""
    top = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * top,
                               msg=lambda m: f'{what}: {m}')
    return (got - want).abs().max().item()


def check_flash(torch, fa, q, k, v, do, scale):
    """Lf, Ldkv and Ldq on q, k, v, do against their plain versions, each
    rerun bit-identical, and each the same with
    ``torch.backends.cuda.matmul.allow_tf32`` on and off (their 3xTF32
    split does not read it); the autograd Function one launch of each with
    the same outputs. Returns the three max abs errors (Lf: o and lse)."""
    shape = tuple(q.shape[:3]) + (k.shape[2], q.shape[3])
    o, lse = fa.flash_attention_forward(q, k, v, scale)
    o2, lse2 = fa.flash_attention_forward(q, k, v, scale)
    di = (o * do).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
    for name, a, b in (('o', o, o2), ('lse', lse, lse2), ('dk', dk, dk2),
                       ('dv', dv, dv2), ('dq', dq, dq2)):
        if not torch.equal(a, b):
            raise AssertionError(f'flash attention {name} not deterministic '
                                 f'{shape}')
    allowed = torch.backends.cuda.matmul.allow_tf32
    for flag in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = flag
        o2, lse2 = fa.flash_attention_forward(q, k, v, scale)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
        for name, a, b in (('o', o, o2), ('lse', lse, lse2), ('dk', dk, dk2),
                           ('dv', dv, dv2), ('dq', dq, dq2)):
            if not torch.equal(a, b):
                raise AssertionError(f'flash attention {name} {shape} '
                                     f'changes with allow_tf32={flag}')
    torch.backends.cuda.matmul.allow_tf32 = allowed
    ro, rlse = fa.flash_attention_reference(q, k, v, scale)
    e_fwd = max(fa_close(torch, o, ro, f'o {shape}'),
                fa_close(torch, lse, rlse, f'lse {shape}'))
    rdi = (ro * do).sum(-1)
    rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, rlse, do, rdi,
                                                    scale)
    e_dv = fa_close(torch, dv, rdv, f'dv {shape}')
    if k.shape[2] == 1:
        # one key: p = 1 and ds = 0, so dq and dk vanish and both sides give
        # rounding noise; held to zero at 1e-5 of the largest dv
        e_dkv, e_dq = max(e_dv, dk.abs().max().item()), dq.abs().max().item()
        if max(e_dkv, e_dq) > 1e-5 * rdv.abs().max().item():
            raise AssertionError(f'dq, dk {shape}: {e_dq}, {e_dkv} for 0')
    else:
        e_dkv = max(fa_close(torch, dk, rdk, f'dk {shape}'), e_dv)
        e_dq = fa_close(torch, dq, fa.flash_attention_bwd_dq_reference(
            q, k, v, rlse, do, rdi, scale), f'dq {shape}')
    del ro, rlse, rdi, rdk, rdv
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    before = [getattr(fa, name).launches for name in FA_KERNELS]
    out = fa.flash_attention(*leaves, sm_scale=scale)
    out.backward(do)
    if [getattr(fa, name).launches - b for name, b in
            zip(FA_KERNELS, before)] != [1, 1, 1] or \
            not torch.equal(out, o) or not all(
                torch.equal(leaf.grad, g)
                for leaf, g in zip(leaves, (dq, dk, dv))):
        raise AssertionError(f'flash_attention autograd {shape}: not one '
                             'launch of each kernel with their outputs')
    return e_fwd, e_dkv, e_dq


def sass_of(library):
    """``cuobjdump -sass`` of a built library."""
    from torch.utils.cpp_extension import CUDA_HOME
    return subprocess.run(
        [os.path.join(CUDA_HOME, 'bin', 'cuobjdump'), '-sass', library],
        capture_output=True, text=True, check=True, timeout=300).stdout


def tf32_mmas(library):
    """The TF32 tensor-core instructions (HMMA or HGMMA ... TF32) of each
    flash kernel of a built library, from ``cuobjdump -sass``: {kernel's
    demangled template name: count}."""
    counts, fn = {}, None
    for line in sass_of(library).splitlines():
        if 'Function :' in line:
            mangled = line.split('Function :')[1].strip()
            # _ZN<anon namespace>..<len><name>ILi<DP>E(Lb<VEC>E)...:
            # keep name<DP> or name<DP, VEC>
            name = mangled.split('flash_')[-1].split('EE')[0]
            fn = 'flash_' + name.replace('ILi', '<').replace('ELb', ', ') + '>'
            counts[fn] = 0
        elif fn and 'MMA' in line and 'TF32' in line:
            counts[fn] += 1
    return counts


def phase_flash_attention_kernels(torch, fa, library):
    """Lf, Ldkv and Ldq against their plain versions on the card, f32: at
    the STC transformer's shapes (x4 and x5 of slide B=14, whole B=8 and
    bs 1), at odd shapes and at the edges of Lf's tiling. First, every
    instantiation of each of the three (4 head widths, 16- and 4-byte
    copies) must hold TF32 tensor-core instructions in the built
    library."""
    mmas = tf32_mmas(library)
    names = ('flash_fwd_tc', 'flash_bwd_dkv_tc', 'flash_bwd_dq_tc')
    if sorted(k.split('<')[0] for k in mmas) != sorted(names * 8) or \
            not all(mmas.values()):
        raise AssertionError(f'Lf, Ldkv and Ldq: not 8 builds each, all '
                             f'with TF32 MMAs: {mmas}')
    err = dict.fromkeys(FA_KERNELS, 0.0)
    checked = []
    cases = [(n, FA_HEADS, l, l, FA_D) for n, l in
             FA_SLIDE + FA_WHOLE + FA_BS1] + FA_ODD + FA_EDGES
    for i, (n, h, lq, lk, d) in enumerate(cases):
        q, k, v, do = fa_inputs(torch, n, h, lq, lk, d, 300 + i)
        errs = check_flash(torch, fa, q, k, v, do, d ** -0.5)
        for name, e in zip(FA_KERNELS, errs):
            err[name] = max(err[name], e)
        checked.append(dict(shape=[n, h, lq, lk, d],
                            **{f'{name}_err': e
                               for name, e in zip(FA_KERNELS, errs)}))
        del q, k, v, do
        torch.cuda.empty_cache()
    emit('flash_attention_kernels', ok=True, checked=checked,
         shape='(N, heads, Lq, Lk, d), float32', sass_tf32_mmas=mmas,
         tolerance='rtol 1e-4, atol 1e-5 of the largest value (o, lse, dq, '
                   'dk, dv; with one key dq and dk vanish and are held to '
                   'zero at 1e-5 of the largest dv); every rerun '
                   'bit-identical, also with TF32 matmuls allowed; the '
                   'autograd Function one launch of each kernel with their '
                   'outputs')
    return err


def flash_rows(torch, fa, n, length, calls, seed, backward, err):
    """Lf (and with ``backward`` Ldkv and Ldq) at one scale of the STC
    transformer: each beside its plain version, the library yardstick
    (``F.scaled_dot_product_attention`` on the same f32 tensors, and its
    autograd backward, which gives dq, dk and dv at once) and its bound;
    each held against its plain version there, the errors folded into
    err. Also the backend SDPA picks for these inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    h, d = FA_HEADS, FA_D
    scale = d ** -0.5
    q, k, v, do = fa_inputs(torch, n, h, length, length, d, seed)
    for name, e in zip(FA_KERNELS, check_flash(torch, fa, q, k, v, do,
                                               scale)):
        err[name] = max(err[name], e)
    tensor = n * h * length * d * 4          # bytes of one (N, H, L, d) f32
    row = n * h * length * 4                 # of lse or di
    product = 2 * n * h * length * length * d
    exps = n * h * length * length
    fwd = timed(torch, lambda: fa.flash_attention_forward(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                lambda: fa.flash_attention_reference(q, k, v, scale),
                plain_iters=3)
    fwd.update(bytes=4 * tensor + row, flops=2 * product, exps=exps)
    sdpa = SDPBackend(torch._fused_sdp_choice(q, k, v, scale=scale)).name
    rows = {'flash_attention_forward': fwd}
    if backward:
        o, lse = fa.flash_attention_forward(q, k, v, scale)
        di = (o * do).sum(-1)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        sdpa_bwd = dict(
            library_ms=event_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True)),
            library_device_ms=device_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True)))
        rows['flash_attention_bwd_dkv'] = dict(
            ms=event_ms(torch, lambda: fa.flash_attention_bwd_dkv(
                q, k, v, lse, do, di, scale)),
            device_ms=device_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, lse, do, di, scale)),
            plain_ms=event_ms(
                torch, lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, lse, do, di, scale), iters=3),
            bytes=6 * tensor + 2 * row, flops=4 * product, exps=exps,
            **sdpa_bwd)
        rows['flash_attention_bwd_dq'] = dict(
            ms=event_ms(torch, lambda: fa.flash_attention_bwd_dq(
                q, k, v, lse, do, di, scale)),
            device_ms=device_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, lse, do, di, scale)),
            plain_ms=event_ms(
                torch, lambda: fa.flash_attention_bwd_dq_reference(
                    q, k, v, lse, do, di, scale), iters=3),
            bytes=5 * tensor + 2 * row, flops=3 * product, exps=exps,
            **sdpa_bwd)
        del o, lse, di, leaves, out
    for name, r in rows.items():
        r.update(shape=[n, h, length, d], calls=calls)
        bound(r)
        bound(r, TF32_FLOPS / 3, key='bound_tc')
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows, sdpa


def phase_flash_attention_timing(torch, fa, err):
    """Lf at one forward's eight calls (4 at x4, 4 at x5) of slide B=14,
    of whole B=8 and of whole bs 1; Ldkv and Ldq at one B=8 train step's
    eight calls; f32 at the model's shapes and strides. Returns the whole
    B=8 rows per kernel (the kernels line's), the slide and bs-1 rows in
    the phase line."""
    per = {name: [] for name in FA_KERNELS}
    slide, bs1, sdpa = [], [], {}
    for i, (n, length) in enumerate(FA_SLIDE):
        rows, sdpa[f'slide L={length}'] = flash_rows(
            torch, fa, n, length, FA_CALLS, 400 + i, False, err)
        slide.append(rows['flash_attention_forward'])
    for i, (n, length) in enumerate(FA_BS1):
        rows, sdpa[f'bs1 L={length}'] = flash_rows(
            torch, fa, n, length, FA_CALLS, 420 + i, False, err)
        bs1.append(rows['flash_attention_forward'])
    for i, (n, length) in enumerate(FA_WHOLE):
        rows, sdpa[f'whole L={length}'] = flash_rows(
            torch, fa, n, length, FA_CALLS, 410 + i, True, err)
        for name, r in rows.items():
            per[name].append(r)

    def total(rows, key):
        return sum(r['calls'] * r[key] for r in rows)

    keys = ('ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_tc_ms',
            'library_ms', 'library_device_ms')
    emit('flash_attention_timing', dtype='float32', heads=FA_HEADS, d=FA_D,
         sdpa_backend=sdpa,
         library=dict(
             flash_attention_forward='F.scaled_dot_product_attention(q, k, '
                                     'v, scale=sm_scale), f32',
             backward='torch.autograd.grad of it to q, k and v: dq, dk and '
                      'dv in one call, beside Ldkv and beside Ldq'),
         bound='largest of bytes / 3.35 TB/s, exponentials / 4.2e12 per s, '
               'dot-product flops / 67 TFLOP/s (f32 outside the tensor '
               'cores; Lf 2 products, Ldkv 4, Ldq 3)',
         bound_tc='the same with 3 x the dot-product flops / 495 TFLOP/s '
                  '(3xTF32: three TF32 products per f32 product on the '
                  'TF32 tensor cores, as all three compute them)',
         slide_b14_forward=dict(rows=slide, **{
             f'total_{k}': total(slide, k) for k in keys}),
         bs1_forward=dict(rows=bs1, **{
             f'total_{k}': total(bs1, k) for k in keys}),
         whole_b8=dict(rows=per, **{
             f'{name}_total_{k}': total(per[name], k)
             for name in FA_KERNELS for k in keys}))
    return per


def phase_launch_limits(torch, cf, wa, fa):
    """Each kernel family at the 65535 that a grid's y or z holds
    (``GRID_YZ``) and one past it, where each now runs on grid.x or in
    chunks: K1, K2, K2b and P at N images of (2, 3, 33), f32; K3f and K3b
    at W windows of 4 tokens, one head of 2, rate 0.1; Lf, Ldkv and Ldq at
    N·heads (Lq 3, Lk 5, d 8). Each is held to its plain version at the
    limits of ``kernels``, ``window_attention_kernels``,
    ``flash_attention_kernels`` and ``coordatt_probe``, and every kernel's
    rerun is bit-identical."""
    from stc_unet_tpu_torch.tools.probe_coordatt import check_dual_pools
    checked = []
    for i, count in enumerate((GRID_YZ, GRID_YZ + 1)):
        x, do, a_h, a_w = gates(torch, (count, 2, 3, 33), torch.float32,
                                600 + i)
        e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
        e3 = check_gate_dots(torch, cf, do, a_h, a_w)
        same = dict(gate_add=torch.equal(cf.gate_add(x, a_h, a_w),
                                         cf.gate_add(x, a_h, a_w)))
        e9 = check_dual_pools(x)
        del x, do, a_h, a_w
        inputs = wa_inputs(torch, count, 4, 2, 1, torch.float32, 610 + i)
        e4, e5 = check_window_attention(torch, wa, inputs, 1, 0.1)
        q, k, v, bias_e, sd, _ = inputs
        same['window_attention'] = torch.equal(
            wa.window_attention(q, k, v, bias_e, sd, 1, 1.0, 0.1),
            wa.window_attention(q, k, v, bias_e, sd, 1, 1.0, 0.1))
        del inputs, q, k, v, bias_e, sd
        n, h = (count, 1) if count % 2 else (count // 2, 2)
        e6, e7, e8 = check_flash(torch, fa, *fa_inputs(
            torch, n, h, 3, 5, 8, 620 + i), 8 ** -0.5)
        if not all(same.values()):
            raise AssertionError(f'launch_limits {count}: reruns differ '
                                 f'{same}')
        checked.append(dict(
            count=count, coordatt_shape=[count, 2, 3, 33],
            window_shape=[count, 4, 2], flash_shape=[n, h, 3, 5, 8],
            **{f'{name}_err': e for name, e in zip(
                KERNELS, (e1, e2, e3, e4, e5, e6, e7, e8, e9))}))
        torch.cuda.empty_cache()
    emit('launch_limits', ok=True, checked=checked,
         axes='K1/K2b: N images (a 1-D grid of N * bands * channel tiles '
              'blocks: tiles of 32 f32 or 64 bf16 channels in vectors, 8 '
              'on the scalar path that C = 33 takes), K2 (N * H); P: N '
              'images (a 1-D grid of N * channel tiles * bands blocks); '
              'K3f/K3b: W windows (grid.y = ceil(W / windows a block) <= '
              '4096, K3b in at most 64 chunks); Lf/Ldkv/Ldq: N·heads (a 1-D '
              'grid of N·heads·row tiles)',
         tolerance='as kernels, window_attention_kernels, '
                   'flash_attention_kernels and coordatt_probe; every '
                   'kernel\'s rerun bit-identical')


def logit_measures(got, want):
    """got against want, (1, H, W, C) f32 logits: the largest error over
    the largest |logit|, the class margin's largest error over its spread
    (std), the argmax agreement and the class-1 share. The margin is
    class 1's logit less class 0's for 2 classes; for more, each pixel's
    top logit of ``want`` less its second, both classes taken from
    ``want`` in ``got`` too."""
    if want.shape[-1] == 2:
        margin = want[..., 1] - want[..., 0]
        got_margin = got[..., 1] - got[..., 0]
    else:
        first, second = want.topk(2, -1).indices.split(1, -1)
        margin = (want.gather(-1, first) - want.gather(-1, second))[..., 0]
        got_margin = (got.gather(-1, first) -
                      got.gather(-1, second))[..., 0]
    margin_err = (got_margin - margin).abs().max().item()
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    return dict(
        max_abs_err=err, logits_abs_max=top, logit_err_over_max=err / top,
        margin_std=margin.std().item(), margin_max_abs_err=margin_err,
        margin_err_over_spread=margin_err / margin.std().item(),
        argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean()
        .item(),
        class1_share=(want.argmax(-1) == 1).float().mean().item())


def phase_tf32_check(torch, model, cpu_model_fn, tf32):
    """STC-UNet (einsum) at 512², whole and slide (crop 256, stride 170),
    one f32 image: the card at the TF32 setting ``tf32`` (label, cudnn,
    matmul), the flags a caller of ``init_segmentor`` runs with, against
    the port on the CPU in f32. Its limits (``TF32_LIMITS``) were set
    before its first run: the largest logit error within 1e-2 of the
    largest |logit|, the class margin's within 0.1 of its spread (std),
    the argmax agreeing on 0.999 of the pixels."""
    label, cudnn, matmul = tf32
    img = torch.rand((1, 512, 512, 3),
                     generator=torch.Generator().manual_seed(8))
    cpu = cpu_model_fn()
    modes, faults = {}, []
    for mode in ('whole', 'slide'):
        model.test_cfg = cpu.test_cfg = (dict(SLIDE) if mode == 'slide'
                                         else dict(mode='whole'))
        fn = 'slide_inference' if mode == 'slide' else 'whole_inference'
        set_tf32(torch, cudnn, matmul)
        got = getattr(model, fn)(img.cuda(), None, False).float().cpu()
        set_tf32(torch, False, False)
        want = getattr(cpu, fn)(img, None, False)
        modes[mode] = m = logit_measures(got, want)
        for key, limit in TF32_LIMITS.items():
            bad = (m[key] < limit if key == 'argmax_agreement'
                   else m[key] > limit)
            if bad:
                faults.append(f'{mode} {key} {m[key]} past {limit}')
    del cpu
    emit('tf32_check', ok=not faults, faults=faults, tf32=label,
         cudnn_allow_tf32=cudnn, matmul_allow_tf32=matmul, size=512,
         image='float32', config=STC_CONFIG, modes=modes,
         limits=TF32_LIMITS)
    if faults:
        raise AssertionError(f'tf32_check: {faults}')


def write_split(root, n, size, seed, split='test', check=True):
    """``n`` pseudo-KiTS pairs of ``size``² in ``root``/``split``/{images,labels}
    with the port's PNG writer (``tools/parity_eval.py:36-51``'s data: RGB
    noise, a 0/1 disc label). Image rows cycle through the filters 0-4,
    label rows too, written by 8 threads. With ``check``, checks
    ``png.decode(png.encode(x, f)) == x`` for each filter, on the first
    image and label, and that the C unfilter gives the plain version's
    bytes on every file written (``unfilter_agrees``: the first file here,
    which builds the C unfilter, the rest in 8 forked worker processes,
    since the plain version is a Python loop over the anti-diagonals).
    Returns the record."""
    import numpy as np
    from stc_unet_tpu_torch.utils import png
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
    from multiprocessing import get_context
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    cycle = np.arange(size) % 5
    jobs = []
    for d in ('images', 'labels'):
        os.makedirs(os.path.join(root, split, d))
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        cy, cx, r = rng.randint(size // 4, 3 * size // 4, 2).tolist() + \
            [rng.randint(size // 8, size // 3)]
        ann = (((yy - cy) ** 2 + (xx - cx) ** 2) < r * r).astype(np.uint8)
        if i == 0 and check:
            for f in range(5):
                for x in (img, ann):
                    if not np.array_equal(png.decode(png.encode(x, f))[0], x):
                        raise AssertionError(f'PNG round trip, filter {f}, '
                                             f'{x.shape}')
        jobs += [(os.path.join(root, split, d, f'case_{i:05d}.png'), x)
                 for d, x in (('images', img), ('labels', ann))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        for _ in pool.map(lambda job: png.write(*job, cycle), jobs):
            pass
    write_s = time.perf_counter() - t0
    paths = [path for path, _ in jobs]
    if not check:
        return dict(files=len(paths), size=size, write_s=write_s)
    t0 = time.perf_counter()
    agree = [unfilter_agrees(paths[0])]
    # forked, as the loaders' workers are: they run numpy and the C
    # unfilter this process has loaded, never torch
    with ProcessPoolExecutor(8, mp_context=get_context('fork')) as pool:
        agree += pool.map(unfilter_agrees, paths[1:])
    differ = [path for path, same in zip(paths, agree) if not same]
    if differ:
        raise AssertionError(f'{differ[:3]}: the C unfilter differs from '
                             f'the plain one')
    return dict(files=len(paths), size=size, filters='rows cycle 0-4',
                round_trip='filters 0-4, RGB and gray: equal',
                unfilter_c_vs_plain=f'{len(paths)} files equal',
                write_s=write_s,
                unfilter_check_s=time.perf_counter() - t0)


def unfilter_agrees(path):
    """Whether the C unfilter gives the plain version's bytes on the PNG
    file ``path`` (``write_split``'s check)."""
    import numpy as np
    from stc_unet_tpu_torch.utils import png
    with open(path, 'rb') as f:
        raw, height, width, color, _ = png.inflate(f.read(), path)
    bpp = png.CHANNELS[color]
    args = (raw, height, width * bpp, bpp)
    return bool(np.array_equal(png.unfilter(*args),
                               png.unfilter_reference(*args)))


def split_loader(cfg, root, stems=None):
    """``build_dataset(cfg.data.test)`` on ``root`` in test mode (only the
    files named by ``stems``, through a split file, if given), and its
    loader: 4 a batch, 2 worker threads, in order."""
    from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
    test = cfg.data.test
    test.data_root, test.test_mode = root, True
    if stems is not None:
        split = os.path.join(root, f'split_{len(stems)}.txt')
        with open(split, 'w') as f:
            f.write(''.join(f'{s}\n' for s in stems))
        test.split = split
    dataset = build_dataset(test)
    return build_dataloader(dataset, samples_per_gpu=4, workers_per_gpu=2,
                            dist=False, shuffle=False)


def compare_eval(card_maps, card_pre, cpu_pre, cpu_logits, band):
    """The card's label maps and pre_eval areas against the CPU's on the
    same images. A pixel is excluded where the CPU's class margin (logit
    1 - logit 0) lies within ``band`` of the margin's spread (std): there
    either label is right. Faults: a disagreeing label off the excluded
    pixels; an image's areas apart by more than its excluded pixels; mDice
    (unrounded, from the areas) apart by more than the excluded pixels
    over the labelled ones."""
    import numpy as np
    from stc_unet_tpu_torch.core import pre_eval_to_metrics
    margin = (cpu_logits[..., 1] - cpu_logits[..., 0]).numpy()
    spread = float(margin.std())
    excluded = np.abs(margin) <= band * spread
    cpu_maps = cpu_logits.argmax(-1).numpy()
    disagree = np.stack(card_maps) != cpu_maps
    faults = []
    if (disagree & ~excluded).any():
        faults.append(f'{int((disagree & ~excluded).sum())} labels differ '
                      f'off the excluded pixels')
    area_diff = [int(np.abs(np.stack(a).astype(np.int64) -
                            np.stack(b)).max())
                 for a, b in zip(card_pre, cpu_pre)]
    per_image = excluded.reshape(len(card_maps), -1).sum(1).tolist()
    for i, (d, k) in enumerate(zip(area_diff, per_image)):
        if d > k:
            faults.append(f'image {i}: areas apart by {d} > {k} excluded')
    dice = [float(np.nanmean(pre_eval_to_metrics(p, ['mDice'])['Dice']))
            for p in (card_pre, cpu_pre)]
    labelled = int(sum(np.asarray(a[3]).sum() for a in cpu_pre))
    limit = int(excluded.sum()) / labelled
    if abs(dice[0] - dice[1]) > limit:
        faults.append(f'mDice {dice[0]} vs {dice[1]}: apart by more than '
                      f'{limit}')
    return dict(band_over_spread=band, margin_std=spread,
                excluded_pixels=int(excluded.sum()),
                disagreeing_pixels=int(disagree.sum()),
                disagreeing_off_band=int((disagree & ~excluded).sum()),
                area_max_diff=area_diff, excluded_per_image=per_image,
                mdice_card=dice[0], mdice_cpu=dice[1],
                mdice_limit=limit), faults


def phase_test_path(torch, kern, model, cpu_model_fn, tf32):
    """The port's test path on a written split (``TEST_PATH``): 64
    pseudo-KiTS 512² pairs as PNG, ``build_dataset(cfg.data.test)`` and
    ``build_dataloader`` (4 a batch, 2 threads), ``single_gpu_test(
    pre_eval=True)`` and ``evaluate`` with the seed-0 STC-UNet, whose
    ``conv_seg`` bias is shifted first so that the classes split the first
    batch's pixels (restored after). Held to the port on the CPU over the
    first 4 images (``compare_eval``) with TF32 off, excluding pixels
    within 1e-3 of the margin's spread (``compare_logits``' margin limit),
    and at the TF32 setting ``tf32`` (label, cudnn, matmul), torch's
    defaults, excluding those within ``TF32_LIMITS``' 0.1 of it (at these
    flags the margins move by up to 1.4e-2 of their spread in
    ``tf32_check``'s record). Each class must take at least 10 % of the
    predicted pixels over the split. K1 and K2 must launch 4 times a
    forward. Timed at ``tf32``: ``single_gpu_test`` slices/s over the
    split beside the model alone (``whole_inference``) on the same
    batches, the host's share, ``inference_segmentor`` on a PNG path at
    bs 1 beside the model alone on that image, PNG decode, the pipeline,
    ``collate`` and ``pre_eval`` per image. Returns the launches."""
    import tempfile
    import numpy as np
    from stc_unet_tpu_torch.apis import inference_segmentor, single_gpu_test
    from stc_unet_tpu_torch.datasets import collate
    from stc_unet_tpu_torch.utils import Config, png
    start = time.perf_counter()
    label, cudnn, matmul = tf32
    n, size = TEST_PATH['images'], TEST_PATH['size']
    launches = dict.fromkeys(KERNELS, 0)
    want = per_call(STC_FORWARD)

    def counted(fn, forwards):
        reset_counts(kern)
        out = fn()
        counts = read_counts(kern)
        if counts != {k: forwards * v for k, v in want.items()}:
            raise AssertionError(f'test_path: {forwards} forwards launched '
                                 f'{counts}')
        for k in launches:
            launches[k] += counts[k]
        return out

    work = os.path.join(REPO, 'work_dirs')
    os.makedirs(work, exist_ok=True)
    bias = model.decode_head.conv_seg.bias
    saved = bias.detach().clone()
    model.test_cfg = dict(mode='whole')
    try:
        with tempfile.TemporaryDirectory(dir=work) as root:
            t0 = time.perf_counter()
            codec = write_split(root, n, size, TEST_PATH['seed'])
            codec['seconds'] = time.perf_counter() - t0
            cfg = Config.fromfile(os.path.join(REPO, STC_CONFIG))
            loader = split_loader(cfg, root)
            dataset = loader.dataset
            first = [os.path.splitext(dataset.img_infos[i]['filename'])[0]
                     for i in range(TEST_PATH['cpu_images'])]
            loader4 = split_loader(Config.fromfile(
                os.path.join(REPO, STC_CONFIG)), root, first)
            batch = next(iter(loader4))
            img4 = torch.from_numpy(batch['img'][0])
            metas4 = batch['img_metas'][0]
            # the classes split the first batch's pixels
            set_tf32(torch, False, False)
            logits = model.whole_inference(img4.cuda(), metas4, True)
            shift = float((logits[..., 1] - logits[..., 0]).median())
            with torch.no_grad():
                bias[1] -= shift
            # the CPU's run; its logits are kept from the same forward
            t0 = time.perf_counter()
            cpu = cpu_model_fn()
            cpu.test_cfg = dict(mode='whole')
            kept, logits_of = [], cpu._logits
            cpu._logits = lambda x: kept.append(logits_of(x)) or kept[-1]
            cpu_pre = single_gpu_test(cpu, loader4, pre_eval=True)
            cpu_logits = torch.cat(kept)
            del cpu
            cpu_s = time.perf_counter() - t0
            checks, faults = {}, []
            for name, flags, band in (
                    ('off', (False, False), 1e-3),
                    (label, (cudnn, matmul),
                     TF32_LIMITS['margin_err_over_spread'])):
                set_tf32(torch, *flags)
                pre = counted(lambda: single_gpu_test(model, loader4,
                                                      pre_eval=True), 1)
                maps = counted(lambda: single_gpu_test(model, loader4), 1)
                checks[name], f = compare_eval(maps, pre, cpu_pre,
                                               cpu_logits, band)
                faults += [f'TF32 {name}: {x}' for x in f]
            # the split at the TF32 setting the caller gets, timed
            set_tf32(torch, cudnn, matmul)
            batches = len(loader)
            t0 = time.perf_counter()
            results = counted(lambda: single_gpu_test(model, loader,
                                                      pre_eval=True), batches)
            e2e_s = time.perf_counter() - t0
            metric = dataset.evaluate(results, metric=['mIoU', 'mDice',
                                                       'mFscore'],
                                      logger='silent')
            pred = np.sum([np.asarray(r[2]) for r in results], axis=0)
            shares = (pred / pred.sum()).tolist()
            if min(shares) < 0.1:
                faults.append(f'class shares of the predictions {shares}: '
                              f'one under 10 %')
            imgs = [torch.from_numpy(b['img'][0]).cuda() for b in loader]
            model_ms = statistics.median(
                event_ms(torch, lambda: model.whole_inference(x, None, False),
                         iters=3) for x in imgs)
            model_s = model_ms * batches / 1e3
            # bs 1: inference_segmentor on a path, and the model alone on
            # the same image
            path = os.path.join(root, 'test', 'images', 'case_00000.png')
            lat, alone = [], []
            one = imgs[0][:1]
            for i in range(22):
                t0 = time.perf_counter()
                counted(lambda: inference_segmentor(model, path), 1)
                t1 = time.perf_counter()
                model.whole_inference(one, None, False)
                torch.cuda.synchronize()
                if i >= 2:
                    lat.append((t1 - t0) * 1e3)
                    alone.append((time.perf_counter() - t1) * 1e3)
            # the host's steps per image
            files = [os.path.join(root, 'test', 'images', i['filename'])
                     for i in dataset.img_infos]
            decode_ms = _median_ms(png.read_color, files)
            blobs = []
            for path in files:
                with open(path, 'rb') as f:
                    blobs.append(f.read())
            inflate_ms = _median_ms(png.inflate, blobs)
            rows = [png.inflate(b) for b in blobs]    # RGB: 3 bytes a pixel
            unfilter_ms = _median_ms(
                lambda r: png.unfilter(r[0], r[1], 3 * r[2], 3), rows)
            pipeline_ms = _median_ms(dataset.__getitem__, range(n))
            samples = [dataset[i] for i in range(4)]
            collate_ms = _median_ms(lambda _: collate(samples),
                                    range(10)) / 4
            maps = [cpu_logits[i].argmax(-1).numpy() for i in range(4)]
            pre_eval_ms = _median_ms(lambda i: dataset.pre_eval(maps[i], i),
                                     range(4))
    finally:
        with torch.no_grad():
            bias.copy_(saved)
        set_tf32(torch, False, False)
    emit('test_path', ok=not faults, faults=faults, config=STC_CONFIG,
         split=dict(images=n, **codec), bias_shift=-shift,
         tf32=label, cudnn_allow_tf32=cudnn, matmul_allow_tf32=matmul,
         card_vs_cpu=dict(images=TEST_PATH['cpu_images'], cpu_s=cpu_s,
                          **checks),
         metrics={k: float(v) for k, v in metric.items()},
         pred_class_shares=shares,
         e2e_s=e2e_s, e2e_slices_per_s=n / e2e_s,
         model_only_ms_b4=model_ms, model_only_slices_per_s=4e3 / model_ms,
         host_share=(e2e_s - model_s) / e2e_s,
         inference_segmentor_p50_ms=statistics.median(lat),
         model_only_p50_ms_bs1=statistics.median(alone),
         decode_ms=decode_ms, inflate_ms=inflate_ms, unfilter_ms=unfilter_ms,
         pipeline_ms=pipeline_ms,
         collate_ms_per_image=collate_ms, pre_eval_ms=pre_eval_ms,
         launches={k: v for k, v in launches.items() if v},
         phase_s=time.perf_counter() - start,
         timer='single_gpu_test: host clock over the split (one call, after '
               'the comparison runs); model alone: CUDA events, median of 3 '
               'a batch, median over the batches; p50 on the host clock, 20 '
               'calls after 2; host steps: median over the files or calls')
    if faults:
        raise AssertionError(f'test_path: {faults}')
    return launches


def phase_train_path(torch, kern, tf32, root):
    """The port's training path through its entry point: writes a
    pseudo-KiTS split (``TRAIN_PATH``: 32 train and 8 test 512² PNG
    pairs) under ``root`` (kept for ``test_cli``, with the run's work dir
    ``root``/work) and runs ``stc_unet_tpu_torch.tools.train.main`` on full-width
    ``my_config/STC-UNet.py`` with the config's own pipeline, batch 4, 2
    loader threads, f32 at the TF32 setting ``tf32`` (torch's defaults),
    Adam and poly lr, 2 epochs, validating (mDice) and checkpointing
    after each. A hook of this script records each step's batch, log
    values and data_time, the weights before the first step, the epochs'
    times (the card synced at each end) and the EvalHook's mDice.
    Faults: the first batch is not bit-equal to a CPU rebuild of it from
    the same seed; the first step's losses on that batch's top-left
    ``crop``² (TF32 off, dropout off, from the recorded weights) on the
    card and on the port on the CPU differ past ``train_check``'s bands;
    a loss is not finite; ``latest.pth`` in a fresh model gives other
    logits than the trained model (beyond 1e-5 of the largest); a
    separate ``single_gpu_test`` of ``latest.pth`` gives another mDice
    than the EvalHook's last; K1, K2 and K2b do not launch 4 times a step
    and K1 and K2 4 times a validation forward. Then the step alone is
    timed on the same batches (CUDA events). Returns the launches."""
    import numpy as np
    from stc_unet_tpu_torch.apis import init_segmentor, single_gpu_test
    from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
    from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
    from stc_unet_tpu_torch.engine import HOOKS, Hook, make_train_step
    from stc_unet_tpu_torch.tools import train as train_cli
    from stc_unet_tpu_torch.utils import Config
    start = time.perf_counter()
    label, cudnn, matmul = tf32
    n_train, n_test = TRAIN_PATH['train'], TRAIN_PATH['test']
    epochs, crop = TRAIN_PATH['epochs'], TRAIN_PATH['crop']

    class TrainPathRecord(Hook):
        def __init__(self):
            self.batches, self.logs, self.data_time = [], [], []
            self.epoch_s, self.mdice, self.initial = [], [], None

        def before_train_epoch(self, runner):
            if 'mDice' in runner.log_buffer.output:
                self.mdice.append(runner.log_buffer.output['mDice'])
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()

        def before_train_iter(self, runner):
            if self.initial is None:
                self.initial = {k: v.detach().cpu().clone() for k, v in
                                runner.model.state_dict().items()}

        def after_train_iter(self, runner):
            b = runner.data_batch
            self.batches.append((b['img'], b['gt_semantic_seg']))
            self.logs.append(runner.outputs['log_vars'])
            self.data_time.append(
                runner.log_buffer.val_history['data_time'][-1])

        def after_train_epoch(self, runner):
            torch.cuda.synchronize()
            self.epoch_s.append(time.perf_counter() - self.t0)

        def after_run(self, runner):
            self.mdice.append(runner.log_buffer.output.get('mDice'))

    record = TrainPathRecord()
    HOOKS.register_module(module=lambda: record, name='TrainPathRecord',
                          force=True)
    cfg_path = os.path.join(REPO, STC_CONFIG)
    faults = []
    restore = _quiet_logger()     # the run's INFO lines go to its log
    try:
        t0 = time.perf_counter()
        write_split(root, n_train, TRAIN_PATH['size'], TRAIN_PATH['seed'],
                    split='train')
        write_split(root, n_test, TRAIN_PATH['size'],
                    TRAIN_PATH['seed'] + 1)
        write_s = time.perf_counter() - t0
        wd = os.path.join(root, 'work')
        argv = [cfg_path, '--work-dir', wd, '--seed', '0',
                '--cfg-options', f'data.train.data_root={root}',
                f'data.val.data_root={root}',
                f'runner.max_epochs={epochs}',
                'checkpoint_config.interval=1',
                "custom_hooks=[{'type': 'TrainPathRecord', "
                "'priority': 'HIGHEST'}]"]
        set_tf32(torch, cudnn, matmul)
        reset_counts(kern)
        t0 = time.perf_counter()
        runner = train_cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts(kern)
        steps = len(record.batches)
        forwards = epochs * n_test
        want = per_call(dict(
            strip_pools=4 * (steps + forwards),
            gate_add=4 * (steps + forwards), gate_dots=4 * steps))
        if counts != want or steps != epochs * n_train // 4:
            faults.append(f'{steps} steps and {forwards} validation '
                          f'forwards launched {counts}, want {want}')
        losses = {k: torch.stack([lv[k] for lv in record.logs]).cpu()
                  for k in record.logs[0]}
        if not all(bool(torch.isfinite(v).all())
                   for v in losses.values()):
            faults.append(f'a loss is not finite: {losses}')
        cfg = Config.fromfile(os.path.join(wd, 'STC-UNet.py'))
        # the first batch, rebuilt on the CPU from the same seed
        loader = build_dataloader(build_dataset(cfg.data.train), 4, 0,
                                  seed=0)
        loader.set_epoch(0)
        cpu_batch = next(iter(loader))
        pipeline_ms = _median_ms(
            lambda i: loader.dataset.load(i, np.random.RandomState(i)),
            range(8))
        img0, gt0 = (t.cpu() for t in record.batches[0])
        batch_equal = bool(
            torch.equal(img0, torch.from_numpy(cpu_batch['img'])) and
            torch.equal(gt0, torch.from_numpy(
                cpu_batch['gt_semantic_seg'])))
        if not batch_equal:
            faults.append('the first batch differs from its CPU '
                          'rebuild')
        # the first step on the first batch's crop, card vs CPU
        set_tf32(torch, False, False)
        check_cfg = Config.fromfile(os.path.join(wd, 'STC-UNet.py'))
        check_cfg.model.decode_head.dropout_ratio = 0.0
        first = {}
        t0 = time.perf_counter()
        for where in ('cuda', 'cpu'):
            m = init_segmentor(check_cfg, device=where)
            m.load_state_dict(record.initial)
            step = make_train_step(m, build_optimizer(m, cfg.optimizer))
            lv = step(img0[:, :crop, :crop].to(where),
                      gt0[:, :crop, :crop].to(where))
            first[where] = {k: v.item() for k, v in lv.items()}
            del m, step
        cpu_step_s = time.perf_counter() - t0
        pixel = 100.0 / int((gt0[:, :crop, :crop] != 255).sum())
        for k, b in first['cpu'].items():
            a = first['cuda'][k]
            limit = 1e-5 * abs(b) + 1e-6 if 'loss' in k else 3 * pixel
            if not math.isfinite(a) or abs(a - b) > limit:
                faults.append(f'first step {k}: card {a} cpu {b}')
        set_tf32(torch, cudnn, matmul)
        # latest.pth in a fresh model; its mDice on its own
        latest = os.path.join(wd, 'latest.pth')
        fresh = init_segmentor(cfg, latest)
        val_cfg = cfg.data.val
        val_cfg.test_mode = True
        val_loader = build_dataloader(build_dataset(val_cfg), 1, 2,
                                      shuffle=False)
        img = torch.from_numpy(next(iter(val_loader))['img'][0]).cuda()
        runner.model.eval()
        with torch.no_grad():
            want_logits = runner.model.whole_inference(img, None, False)
            got_logits = fresh.whole_inference(img, None, False)
        logit_err = (got_logits - want_logits).abs().max().item()
        logit_max = want_logits.abs().max().item()
        if logit_err > 1e-5 * logit_max:
            faults.append(f'latest.pth logits off by {logit_err} '
                          f'(largest {logit_max})')
        separate = val_loader.dataset.evaluate(
            single_gpu_test(fresh, val_loader, pre_eval=True),
            metric=cfg.evaluation['metric'], logger='silent')['mDice']
        if len(record.mdice) != epochs or separate != record.mdice[-1]:
            faults.append(f'EvalHook mDice {record.mdice} vs '
                          f'single_gpu_test of latest.pth {separate}')
        ckpts = sorted(f for f in os.listdir(wd) if f.endswith('.pth'))
        del fresh
        # the step alone on the run's batches
        gen = torch.Generator(device='cuda').manual_seed(0)
        step = runner._train_step
        for img_b, gt_b in record.batches[:2]:
            step(img_b, gt_b, gen)
        t_start = torch.cuda.Event(enable_timing=True)
        t_end = torch.cuda.Event(enable_timing=True)
        t_start.record()
        for img_b, gt_b in record.batches:
            step(img_b, gt_b, gen)
        t_end.record()
        t_end.synchronize()
        step_s = t_start.elapsed_time(t_end) / 1e3
    finally:
        restore()
        set_tf32(torch, False, False)
    images = 4 * steps
    train_s = sum(record.epoch_s)
    emit('train_path', ok=not faults, faults=faults, config=STC_CONFIG,
         entry='python -m stc_unet_tpu_torch.tools.train (main(argv) in '
               'process)', argv=argv[1:],
         split=dict(train=n_train, test=n_test, size=TRAIN_PATH['size'],
                    write_s=write_s),
         batch=4, workers_per_gpu=2, epochs=epochs, steps=steps,
         dtype='float32', tf32=label, cudnn_allow_tf32=cudnn,
         matmul_allow_tf32=matmul, run_s=run_s,
         epoch_train_s=record.epoch_s,
         e2e_train_img_per_s=images / train_s,
         epoch_img_per_s=[4 * steps / epochs / s for s in record.epoch_s],
         step_alone_s=step_s, step_alone_img_per_s=images / step_s,
         step_alone_ms=1e3 * step_s / steps,
         host_share=(train_s - step_s) / train_s,
         pipeline_ms_per_image=pipeline_ms,
         data_time_mean_s=statistics.mean(record.data_time),
         data_time_after_first_mean_s=statistics.mean(
             t for i, t in enumerate(record.data_time)
             if i % (steps // epochs)),
         losses={k: v.tolist() for k, v in losses.items()},
         first_batch_bit_equal_cpu=batch_equal,
         first_step=dict(crop=crop, batch=4, tf32=False, dropout_ratio=0.0,
                         card=first['cuda'], cpu=first['cpu'],
                         seconds=cpu_step_s),
         latest_logits_max_abs_err=logit_err, latest_logits_max=logit_max,
         mdice_eval_hook=record.mdice, mdice_latest_single_gpu_test=separate,
         checkpoints=ckpts,
         launches={k: v for k, v in counts.items() if v},
         phase_s=time.perf_counter() - start,
         timer='epochs: host clock from before_train_epoch to '
               'after_train_epoch, the card synced at both (data loading '
               'included, validation and checkpointing not); step alone: '
               'one CUDA event pair over the run\'s batches after 2 '
               'warm-up steps; data_time: IterTimerHook; pipeline: '
               'median of 8 samples, one thread')
    if faults:
        raise AssertionError(f'train_path: {faults}')
    del runner, record
    torch.cuda.empty_cache()
    return counts


def run_group(cmds, deadline, logdir, env):
    """Run the commands at once, each in a session of its own with its
    output in ``logdir``/<i>.log, until all exit 0. The first that exits
    otherwise, or the ``deadline`` (seconds), kills every one of them
    (their process groups: a launcher's ranks too) and raises with the
    ends of their logs."""
    import signal
    procs, logs = [], []
    try:
        for i, cmd in enumerate(cmds):
            logs.append(open(os.path.join(logdir, f'{i}.log'), 'w'))
            procs.append(subprocess.Popen(
                cmd, stdin=subprocess.DEVNULL, stdout=logs[-1],
                stderr=subprocess.STDOUT, cwd=REPO, env=env,
                start_new_session=True))
        end = time.monotonic() + deadline
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return
            if any(c not in (None, 0) for c in codes) or \
                    time.monotonic() > end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in logs:
            f.close()
    tails = []
    for i in range(len(cmds)):
        with open(os.path.join(logdir, f'{i}.log')) as f:
            tails.append(f'--- {cmds[i][:6]}\n{f.read()[-3000:]}')
    raise AssertionError(f'exit codes {codes} (deadline {deadline} s)\n' +
                         '\n'.join(tails))


def dp_inputs(torch):
    """The data-parallel phase's inputs, made alike in every process: the
    global train batch (``world·batch`` 512² images, f32, labels with an
    ignored band) and the slide batch, whose first ``whole`` images are
    the whole-mode batch."""
    dp = DATA_PARALLEL
    g = torch.Generator().manual_seed(dp['seed'])
    size = dp['size']
    img = torch.rand((dp['world'] * dp['batch'], size, size, 3), generator=g)
    gt = (img.mean(-1) > 0.5).long()
    gt[:, :3] = 255
    slide = torch.rand((dp['slide'], size, size, 3), generator=g)
    return img, gt, slide


def dp_timed_steps(torch, step, img, gt):
    """Host-clock ms of ``DATA_PARALLEL['timed']`` steps, each synced."""
    times = []
    for _ in range(DATA_PARALLEL['timed']):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(img, gt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def dp_rank(workdir, rank, world):
    """One rank of ``phase_data_parallel`` (run as ``python -c 'import
    chip_smoke; chip_smoke.dp_rank(...)'``): joins the gloo group of the
    file store in ``workdir`` on ``cuda:0``, which the ranks share, and
    runs (a) one data-parallel bf16 train step of full-width STC-UNet on
    its ``batch`` rows from the saved weights, then times two more and a
    gloo all-reduce of a buffer of the gradients' size; (b) sharded slide
    and whole inference, f32, TF32 off; (c) ``multi_gpu_test`` on the
    split. K1, K2 and K2b are counted for each. Saves its results to
    ``workdir``/rank<r>.pt."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from stc_unet_tpu_torch.apis import multi_gpu_test
    from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
    from stc_unet_tpu_torch.models import build_segmentor
    from stc_unet_tpu_torch.utils import Config, default_data_mesh
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'file://{workdir}/store',
                            rank=rank, world_size=world)
    kern = kernel_functions()
    set_tf32(torch, False, False)
    dp = DATA_PARALLEL
    cfg = Config.fromfile(os.path.join(workdir, 'cfg.py'))
    state = torch.load(os.path.join(workdir, 'state.pt'))
    model = build_segmentor(cfg.model, test_cfg=cfg.get('test_cfg'))
    model.load_state_dict(state)
    model = model.to('cuda', memory_format=torch.channels_last)
    mesh = default_data_mesh()
    img, gt, slide = dp_inputs(torch)
    rows = slice(rank * dp['batch'], (rank + 1) * dp['batch'])
    img, gt = img[rows].cuda(), gt[rows].cuda()
    out = dict(rank=rank)
    # (a) the train step
    step, _ = train_step_for(torch, model, torch.bfloat16, mesh)
    reset_counts(kern)
    logs = step(img, gt)
    torch.cuda.synchronize()
    out['step_counts'] = read_counts(kern)
    out['logs'] = {k: v.item() for k, v in logs.items()}
    out['grads'] = {k: p.grad.float().cpu() for k, p in
                    model.named_parameters()}
    out['state1'] = {k: v.cpu().clone() for k, v in
                     model.state_dict().items()}
    out['step_ms'] = dp_timed_steps(torch, step, img, gt)
    out['state3'] = {k: v.cpu().clone() for k, v in
                     model.state_dict().items()}
    del step
    numel = sum(p.numel() for p in model.parameters())
    flat = torch.zeros(numel, device=img.device)
    out['allreduce_ms'] = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        out['allreduce_ms'].append((time.perf_counter() - t0) * 1e3)
    out['grad_elements'] = numel
    del flat
    torch.cuda.empty_cache()
    # (b) sharded inference from the saved weights
    model.load_state_dict(state)
    model.eval()
    model.set_mesh(mesh)
    model.test_cfg = dict(SLIDE)
    reset_counts(kern)
    out['slide'] = model.slide_inference(slide.cuda(), None,
                                         False).float().cpu()
    out['whole'] = model.encode_decode(
        slide[:dp['whole']].cuda()).float().cpu()
    torch.cuda.synchronize()
    out['infer_counts'] = read_counts(kern)
    model.set_mesh(None)
    # (c) multi_gpu_test over the ranks' shards of the split
    model.test_cfg = dict(mode='whole')
    test = cfg.data.test
    test.data_root, test.test_mode = os.path.join(workdir, 'split'), True
    dataset = build_dataset(test)
    loader = build_dataloader(dataset, 4, 2, shuffle=False)
    reset_counts(kern)
    out['pre_eval'] = multi_gpu_test(model, loader, pre_eval=True)
    torch.cuda.synchronize()
    out['test_counts'] = read_counts(kern)
    out['test_forwards'] = len(loader)
    out['shard'] = loader.sampler.unpadded().tolist()
    out['metrics'] = dataset.evaluate(out['pre_eval'], ['mIoU', 'mDice'],
                                      logger='silent')
    torch.save(out, os.path.join(workdir, f'rank{rank}.pt'))
    dist.barrier()
    dist.destroy_process_group()


def dp_cli(root, work, nproc, backend, stems=None):
    """The train CLI's argv under ``python -m torch.distributed.run`` with
    ``nproc`` ranks: full-width STC-UNet, the train path's split in
    ``root`` (its first ``stems`` train pairs if given, through a split
    file), one epoch at the config's 4 images a rank, validating through
    ``DistEvalHook``, ``dist_params.backend`` as given."""
    options = [f'data.train.data_root={root}', f'data.val.data_root={root}',
               'runner.max_epochs=1', 'checkpoint_config.interval=1',
               "log_config.hooks=[{'type': 'TextLoggerHook'}]",
               'log_config.interval=1', f'dist_params.backend={backend}']
    if stems is not None:
        split = work + '_split.txt'
        with open(split, 'w') as f:
            f.write(''.join(f'case_{i:05d}\n' for i in range(stems)))
        options.append(f'data.train.split={split}')
    return [sys.executable, '-m', 'torch.distributed.run', '--standalone',
            '--nproc_per_node', str(nproc), '-m',
            'stc_unet_tpu_torch.tools.train',
            os.path.join(REPO, STC_CONFIG), '--launcher', 'pytorch',
            '--work-dir', work, '--seed', '0', '--cfg-options'] + options


def dp_cli_check(work, ranks, steps_per_rank, launcher_log):
    """The faults of a train CLI run under the launcher, and the mDice
    of its validation: rank 0 alone wrote one epoch's checkpoint,
    ``latest.pth``, the config, one log and one JSON log; its log says it
    trained distributed, the last step's count and the evaluation's
    summary (whose Dice is the mDice); rank 0 alone logged INFO."""
    faults = []
    names = sorted(os.listdir(work))
    want = {'epoch_1.pth', 'latest.pth', os.path.basename(STC_CONFIG)}
    logs = [n for n in names if n.endswith('.log')]
    if not want <= set(names) or len(logs) != 1 or \
            len([n for n in names if n.endswith('.log.json')]) != 1 or \
            [n for n in names if n.endswith('.pth') and
             n not in ('epoch_1.pth', 'latest.pth')]:
        faults.append(f'{ranks} ranks wrote {names}')
        return faults, None
    with open(os.path.join(work, logs[0])) as f:
        text = f.read()
    # the last evaluation's summary table: a header row, then the values
    rows = [ln.split('|') for ln in text.split('Summary:')[-1].splitlines()
            if '|' in ln]
    mdice = [float(v) / 100 for k, v in zip(*rows[:2])
             if k.strip() == 'Dice'] if len(rows) >= 2 else []
    if 'Distributed training: True' not in text or not mdice or \
            f'Epoch [1][{steps_per_rank}/{steps_per_rank}]' not in text:
        faults.append(f'{ranks} ranks: the log lacks the run: '
                      f'{text[-1500:]}')
    with open(launcher_log) as f:
        if f.read().count('Distributed training: True') != 1:
            faults.append(f'{ranks} ranks: INFO lines from more than '
                          f'rank 0')
    return faults, float(mdice[-1]) if mdice else None


def phase_data_parallel(torch, root):
    """Data parallelism on one card (``DATA_PARALLEL``): two ranks that
    share ``cuda:0`` over gloo, started by ``run_group`` with a file
    store under ``root``, each with its rows of the global batch:

    (a) full-width STC-UNet (``my_config/STC-UNet.py``, dropout off), one
        bf16 train step at 4 images a rank (the config's
        ``samples_per_gpu``; a global 8) at 512², Adam and poly lr,
        against one process taking the global batch: losses rtol 1e-3
        and ``acc_seg`` within 0.1 points (bf16 activations; the
        one-process step sums its convolutions and BN moments over 8
        images, the ranks over 4 and an all-reduce), each BN layer's
        running mean within 0.1·2^-7 (momentum times one bf16 ulp) of
        its batch's sqrt(E[x²]) and its running variance within
        0.1·2^-6 of E[x²], every parameter within 2·lr and two f32 ulps
        of the reference and the moves of the coordinates whose first
        gradient is at least 1e-2 of the largest within lr/1000 (Adam's
        first step moves them by lr·sign(g)); both ranks' parameters and
        buffers bit-equal after three steps; K1, K2 and K2b 4 launches a
        rank. The gloo all-reduce of a gradient-sized f32 buffer is timed
        beside the step: gloo stages it through host memory, so these
        are a check, not a speed.
    (b) slide (B=14: 126 tiles, 63 a rank) and whole (B=8) inference
        sharded by ``set_mesh``, f32, TF32 off, against unsharded by
        ``compare_logits``; both ranks' logits bit-equal.
    (c) ``multi_gpu_test`` over the ranks' shards of ``test_path``'s 64
        pseudo-KiTS slices (4 a batch, f32, TF32 off): its pre_eval areas
        and mIoU and mDice equal to ``single_gpu_test``'s in one process.
    (d) the train CLI under ``python -m torch.distributed.run
        --nproc_per_node 2`` with ``dist_params.backend=gloo`` for one
        epoch of the train path's 32 pairs (4 steps a rank) validating
        through ``DistEvalHook``: rank 0 alone writes the checkpoint and
        the logs (``dp_cli_check``).
    (e) at the same time, one rank over NCCL (the config's
        ``backend='jax'``) through the launcher: the train CLI on 8 of
        the pairs with its ``multi_gpu_test`` validation; two ranks over
        NCCL on two cards when there are two, else it says so.

    Every group has a deadline and any rank's failure fails the phase.
    Returns the ranks' K1, K2 and K2b launches."""
    import numpy as np
    from stc_unet_tpu_torch.apis import init_segmentor, single_gpu_test
    from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
    from stc_unet_tpu_torch.utils import Config
    start = time.perf_counter()
    dp = DATA_PARALLEL
    world = dp['world']
    work = os.path.join(root, 'data_parallel')
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=REPO)
    cfg = Config.fromfile(os.path.join(REPO, STC_CONFIG))
    cfg.model.decode_head.dropout_ratio = 0.0
    cfg.dump(os.path.join(work, 'cfg.py'))
    set_tf32(torch, False, False)
    faults = []
    # the one-process references, from the weights the ranks load
    model = init_segmentor(cfg)
    state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(work, 'state.pt'))
    img, gt, slide = dp_inputs(torch)
    step, _ = train_step_for(torch, model, torch.bfloat16)
    ref_logs = {k: v.item() for k, v in
                step(img.cuda(), gt.cuda()).items()}
    ref_grads = {k: p.grad.float().cpu() for k, p in
                 model.named_parameters()}
    ref_state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
    one_ms = dp_timed_steps(torch, step, img.cuda(), gt.cuda())
    del step
    model.load_state_dict(state)
    model.eval()
    model.test_cfg = dict(SLIDE)
    ref_slide = model.slide_inference(slide.cuda(), None, False).float().cpu()
    ref_whole = model.encode_decode(slide[:dp['whole']].cuda()).float().cpu()
    model.test_cfg = dict(mode='whole')
    split = os.path.join(work, 'split')
    # test_path has checked the codec on the same data
    written = write_split(split, dp['test'], dp['size'], TEST_PATH['seed'],
                          check=False)
    test = cfg.data.test
    test.data_root, test.test_mode = split, True
    dataset = build_dataset(test)
    ref_pre = single_gpu_test(model, build_dataloader(
        dataset, 4, 2, dist=False, shuffle=False), pre_eval=True)
    ref_metrics = dataset.evaluate(ref_pre, ['mIoU', 'mDice'],
                                   logger='silent')
    del model
    torch.cuda.empty_cache()

    # (a)-(c): two ranks on cuda:0 over gloo
    t0 = time.perf_counter()
    run_group([[sys.executable, '-c',
                f'import chip_smoke; chip_smoke.dp_rank({work!r}, {r}, '
                f'{world})'] for r in range(world)], dp['deadline'], work,
              env)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f'rank{r}.pt'),
                        weights_only=False) for r in range(world)]
    r0 = ranks[0]
    want = dict(strip_pools=4, gate_add=4, gate_dots=4)
    launches = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        expect = [(r['step_counts'], want),
                  (r['infer_counts'], dict(strip_pools=8, gate_add=8)),
                  (r['test_counts'], dict(
                      strip_pools=4 * r['test_forwards'],
                      gate_add=4 * r['test_forwards']))]
        for counts, wanted in expect:
            if counts != per_call(wanted):
                faults.append(f'rank {r["rank"]}: launches {counts}, want '
                              f'{per_call(wanted)}')
            for k in launches:
                launches[k] += counts[k]
    # (a)
    pixel_pts = 0.1
    for k, ref in ref_logs.items():
        got = r0['logs'][k]
        limit = 1e-3 * abs(ref) + 1e-6 if 'loss' in k else pixel_pts
        if not math.isfinite(got) or abs(got - ref) > limit:
            faults.append(f'{k}: ranks {got}, one process {ref}')
    if ranks[1]['logs'] != r0['logs']:
        faults.append('the ranks logged different values')
    # the BN running stats after the step, each layer held to its batch's
    # scale E[x^2] (the moments the step took, from the reference's
    # running stats and the initial ones at momentum 0.1): the mean within
    # one bf16 ulp (2^-7) of sqrt(E[x^2]), the variance within two of
    # E[x^2], each times the momentum
    stats_err = 0.0
    for k in ref_state:
        if not k.endswith('running_mean'):
            continue
        var = k[:-len('mean')] + 'var'
        mean_b = (ref_state[k] - 0.9 * state[k]) / 0.1
        var_b = (ref_state[var] - 0.9 * state[var]) / 0.1
        square = var_b + mean_b ** 2
        for key, limit in ((k, 0.1 * 2 ** -7 * square.sqrt()),
                           (var, 0.1 * 2 ** -6 * square)):
            ratio = ((r0['state1'][key] - ref_state[key]).abs() /
                     limit).max().item()
            stats_err = max(stats_err, ratio)
            if ratio > 1:
                faults.append(f'{key} off by {ratio} of its limit')
    lr = OPTIMIZER['lr']
    scale = max(g.abs().max().item() for g in ref_grads.values())
    strong = moved = 0
    move_err = param_err = 0.0
    for k, g in ref_grads.items():
        # Adam's first step moves a coordinate by at most lr, and each
        # run rounds the result to f32 (within 2^-23 of the parameter)
        dev = (r0['state1'][k] - ref_state[k]).abs() - \
            2 ** -22 * ref_state[k].abs()
        param_err = max(param_err, dev.max().item())
        mask = g.abs() >= 1e-2 * scale
        strong += int(mask.sum())
        moved += g.numel()
        if bool(mask.any()):
            move = (r0['state1'][k] - state[k])[mask]
            ref_move = (ref_state[k] - state[k])[mask]
            move_err = max(move_err, (move - ref_move).abs().max().item())
    if param_err > 2 * lr:
        faults.append(f'a parameter is {param_err} (less two f32 ulps) '
                      f'from the one-process step, over 2 lr')
    if move_err > lr / 1000:
        faults.append(f'a strong-gradient move is {move_err} off, over '
                      f'lr/1000')
    grad_whole = math.sqrt(
        sum(((r0['grads'][k] - g) ** 2).sum().item()
            for k, g in ref_grads.items()) /
        sum((g ** 2).sum().item() for g in ref_grads.values()))
    for when in ('state1', 'state3'):
        unequal = [k for k, v in r0[when].items()
                   if not torch.equal(v, ranks[1][when][k])]
        if unequal:
            faults.append(f'ranks differ after the {when[-1]}-step run: '
                          f'{unequal[:4]}')
    # (b)
    checks = {}
    for mode, ref in (('slide', ref_slide), ('whole', ref_whole)):
        checks[mode] = compare_logits(torch, r0[mode], ref)
        checks[mode].update(batch=ref.shape[0], size=dp['size'])
        if not torch.equal(r0[mode], ranks[1][mode]):
            faults.append(f'{mode}: the ranks got different logits')
    # (c)
    for r in ranks:
        if len(r['pre_eval']) != len(ref_pre) or any(
                not all(np.array_equal(np.asarray(a), np.asarray(b))
                        for a, b in zip(x, y))
                for x, y in zip(r['pre_eval'], ref_pre)):
            faults.append(f'rank {r["rank"]}: multi_gpu_test areas differ '
                          f'from single_gpu_test')
        if {k: float(v) for k, v in r['metrics'].items()} != \
                {k: float(v) for k, v in ref_metrics.items()}:
            faults.append(f'rank {r["rank"]}: metrics {r["metrics"]}, one '
                          f'process {ref_metrics}')
    # (d) the train CLI, two ranks over gloo on one card; (e) NCCL: one
    # rank, and two on two cards. The runs go at once: each is mostly its
    # processes' start-up
    cli = {}
    runs = [(world, 'gloo', None, 'gloo_2_ranks'),
            (1, 'jax', 8, 'nccl_1_rank')]
    if torch.cuda.device_count() >= 2:
        runs.append((2, 'jax', 8, 'nccl_2_ranks'))
    else:
        cli['nccl_2_ranks'] = (f'not run: {torch.cuda.device_count()} card '
                               f'(NCCL between two cards needs two)')
    if not faults:
        t0 = time.perf_counter()
        run_group([dp_cli(root, os.path.join(work, name), n, backend, stems)
                   for n, backend, stems, name in runs], dp['deadline'],
                  work, env)
        cli['seconds'] = time.perf_counter() - t0
        for i, (n, backend, stems, name) in enumerate(runs):
            steps = (stems or TRAIN_PATH['train']) // (4 * n)
            found, mdice = dp_cli_check(os.path.join(work, name), n, steps,
                                        os.path.join(work, f'{i}.log'))
            cli[name] = dict(ranks=n, backend=backend, steps=steps,
                             mDice=mdice)
            faults += found
    ar = statistics.median(r0['allreduce_ms'])
    emit('data_parallel', ok=not faults, faults=faults[:8], ranks=world,
         device='cuda:0 shared', backend='gloo', config=STC_CONFIG,
         batch_per_rank=dp['batch'], dtype='bfloat16', dropout_ratio=0.0,
         losses=dict(ranks=r0['logs'], one_process=ref_logs),
         bn_stats_step1_err_over_limit=stats_err,
         params_max_abs_err=param_err, strong_moves_max_abs_err=move_err,
         strong_coordinates=strong, coordinates=moved,
         grad_whole_rel_err=grad_whole,
         step_ms_per_rank=[r['step_ms'] for r in ranks],
         one_process_step_ms_b8=one_ms,
         gloo_allreduce_ms=[r['allreduce_ms'] for r in ranks],
         gloo_allreduce_ms_median=ar,
         grad_elements=r0['grad_elements'],
         gloo_allreduce_gb_s=4 * r0['grad_elements'] / ar / 1e6,
         launches_per_rank={r['rank']: dict(step=r['step_counts'],
                                            inference=r['infer_counts'],
                                            test=r['test_counts'])
                            for r in ranks},
         sharded=checks, multi_gpu_test=dict(
             images=len(ref_pre), shards=[len(r['shard']) for r in ranks],
             metrics={k: float(v) for k, v in r0['metrics'].items()},
             split=written),
         cli=cli, ranks_seconds=ranks_s,
         seconds=time.perf_counter() - start,
         tolerance='losses rtol 1e-3, acc_seg 0.1 points; BN stats: '
                   'mean 0.1 x 2^-7 x sqrt(E[x^2]), var 0.1 x 2^-6 x '
                   'E[x^2] of the batch; parameters within 2 lr and two '
                   'f32 ulps, strong-gradient moves within lr/1000; ranks '
                   'bit-equal; sharded logits by compare_logits; areas '
                   'and metrics equal')
    if faults:
        raise AssertionError(f'data_parallel: {faults[:4]}')
    return launches


def _quiet_logger():
    """The port's logger with its console handlers at WARNING (a CLI's
    INFO lines go to its log file); returns a function that restores
    them and drops the handlers added since."""
    import logging
    from stc_unet_tpu_torch.utils.logger import get_root_logger
    logger = get_root_logger()
    handlers = list(logger.handlers)
    streams = [h for h in handlers if type(h) is logging.StreamHandler]
    for h in streams:
        h.setLevel(logging.WARNING)

    def restore():
        for h in streams:
            h.setLevel(logging.INFO)
        for h in logger.handlers[:]:
            if h not in handlers:
                logger.removeHandler(h)
                h.close()
    return restore


def resume_ckpt_check(torch):
    """The JAX package's tiny STC-UNet checkpoint with Adam's state
    (``RESUME_CKPT``, made by ``tests/fixtures/make_resume_ckpt.py``),
    resumed by ``EpochBasedRunner.resume`` on the card and on the CPU, then
    two steps of the runner on one 64² batch (B=2, f32, TF32 off, no
    dropout), as ``train_check`` holds a step: each step's losses, the
    first step's gradients within 3x the largest of eight one-ulp nudges on
    the CPU, its BN stats. Adam's state must be on the card before the
    first step, and ``step`` at the checkpoint's count."""
    import numpy as np
    from stc_unet_tpu_torch.apis import init_segmentor
    from stc_unet_tpu_torch.core import build_optimizer
    from stc_unet_tpu_torch.engine import (EpochBasedRunner,
                                           load_checkpoint_file)
    from stc_unet_tpu_torch.models import build_segmentor
    from stc_unet_tpu_torch.utils import Config
    path = os.path.join(REPO, RESUME_CKPT)
    ckpt = load_checkpoint_file(path)
    meta, widths = ckpt['meta'], ckpt['meta']['widths']
    cfg = Config.fromfile(os.path.join(REPO, STC_CONFIG))
    cfg.model.backbone.channel_list = widths['channel_list']
    cfg.model.decode_head.update(channels=widths['channels'],
                                 decoder_channel=widths['decoder_channel'],
                                 dropout_ratio=0.0)
    g = torch.Generator().manual_seed(4)
    img = torch.rand((2, 64, 64, 3), generator=g)
    gt = (img.mean(-1) > 0.5).long()
    gt[:, :3] = 255
    faults, logs, grads, stats, state0 = [], {}, {}, {}, None
    placed = {}
    for where in ('cuda', 'cpu'):
        model = build_segmentor(cfg.model).to(where)
        opt = build_optimizer(model, meta['optimizer'])
        runner = EpochBasedRunner(model, opt, max_epochs=2)
        runner.resume(path)
        first = next(model.parameters())
        st = opt.state[first]
        placed[where] = dict(exp_avg=str(st['exp_avg'].device),
                             exp_avg_sq=str(st['exp_avg_sq'].device),
                             step=float(st['step']),
                             epoch=runner.epoch, iter=runner.iter)
        if where == 'cuda' and (st['exp_avg'].device.type != 'cuda' or
                                st['exp_avg_sq'].device.type != 'cuda'):
            faults.append(f'Adam state on the card run: {placed[where]}')
        if float(st['step']) != ckpt['step'] or runner.iter != ckpt['step']:
            faults.append(f'{where}: step {placed[where]}, want '
                          f'{ckpt["step"]}')
        if where == 'cpu':
            state0 = {k: v.clone() for k, v in model.state_dict().items()}
        logs[where] = []
        batch = dict(img=img.numpy(), gt_semantic_seg=gt.numpy())
        for i in range(2):
            runner.run_iter(batch, train_mode=True)
            logs[where].append({k: float(v) for k, v in
                                runner.outputs['log_vars'].items()})
            if i == 0:
                grads[where] = {k: p.grad.float().cpu() for k, p in
                                model.named_parameters()}
                stats[where] = {k: v.cpu().clone() for k, v in
                                model.state_dict().items()
                                if k.endswith(('running_mean',
                                               'running_var'))}
    pixel = 100.0 / int((gt != 255).sum())
    for a, b in zip(logs['cuda'], logs['cpu']):
        for k in b:
            limit = 1e-5 * abs(b[k]) + 1e-6 if 'loss' in k else 3 * pixel
            if not math.isfinite(a[k]) or abs(a[k] - b[k]) > limit:
                faults.append(f'{k}: card {a[k]} cpu {b[k]}')
    rel, whole = grad_errors(grads['cuda'], grads['cpu'])
    spare = init_segmentor(cfg, device='cpu')
    norms = ref_norms(grads['cpu'])
    nudged = [grad_errors(nudged_grads(torch, spare, state0, gt, n),
                          grads['cpu'], norms)
              for n in nudges(torch, spare, state0, img)]
    yard_whole = max(w for _, w in nudged)
    yard = {k: max(GRAD_FLOOR, *(r[k] for r, _ in nudged)) for k in rel}
    if whole > 3 * yard_whole:
        faults.append(f'gradient off by {whole}, over 3 x {yard_whole}')
    faults += [f'gradient {k} off by {e}, over 3 x {yard[k]}'
               for k, e in rel.items() if e > 3 * yard[k]]
    stats_err = 0.0
    for k, ref in stats['cpu'].items():
        diff = (stats['cuda'][k] - ref).abs()
        stats_err = max(stats_err, diff.max().item())
        if bool((diff > 1e-5 + 1e-4 * ref.abs()).any()):
            faults.append(f'{k} off by {diff.max().item()}')
    return dict(checkpoint=RESUME_CKPT, widths=widths,
                optimizer=meta['optimizer'], resumed=placed, losses=logs,
                grad_whole=whole, one_ulp_whole_max=yard_whole,
                grad_worst=_worst(rel, 3),
                bn_stats_step1_max_abs_err=stats_err), faults


def phase_test_cli(torch, kern, tf32, root):
    """The test CLI, ``stc_unet_tpu_torch.tools.test.main(argv)`` in
    process, at full width on ``train_path``'s test split (8 pseudo-KiTS
    512² pairs under ``root``/test) and its ``latest.pth``, at the TF32
    setting ``tf32`` (torch's defaults):

    - ``--eval mIoU mDice --out --show-dir``: the metrics JSON must equal
      ``evaluate`` of a direct ``single_gpu_test(pre_eval=True)`` of
      ``init_segmentor`` on the same checkpoint and split, and the
      ``--out`` pickle those areas (the CLI's default ``--eval`` makes its
      results the label maps' ``pre_eval`` areas); each ``--show-dir`` PNG,
      read back with the port's codec, must equal ``show_result``'s blend
      of the direct run's label map over the pipeline's image, on the
      host; K1 and K2 4 launches an image;
    - ``--eval cityscapes`` (how the CLI formats; ``--format-only`` needs
      an empty ``--eval``): one PNG an image, equal to the label maps;
    - ``--aug-test`` on 2 images (a split file): 48 K1 and K2 launches an
      image (6 scales, each twice for the flip); then on 1 image the
      card's labels against the port's on the CPU, off the pixels whose
      CPU margin (of the averaged class probabilities) lies within
      ``TF32_LIMITS``' 0.1 of its spread (``compare_eval``);
    - ``resume_ckpt_check``: a JAX ``.ckpt`` with Adam's state resumed on
      the card and on the CPU.

    Times each CLI run on the host clock (slices/s). Returns the
    launches."""
    import pickle
    import numpy as np
    from stc_unet_tpu_torch.apis import init_segmentor, single_gpu_test
    from stc_unet_tpu_torch.apis.test import painted_image
    from stc_unet_tpu_torch.datasets import build_dataloader, build_dataset
    from stc_unet_tpu_torch.tools import test as test_cli
    from stc_unet_tpu_torch.utils import Config, image, png
    start = time.perf_counter()
    label, cudnn, matmul = tf32
    wd = os.path.join(root, 'work')
    cfg_path = os.path.join(wd, 'STC-UNet.py')
    ckpt = os.path.join(wd, 'latest.pth')
    images = os.path.join(root, 'test', 'images')
    out = os.path.join(root, 'cli')
    n = len(os.listdir(images))
    launches = dict.fromkeys(KERNELS, 0)
    faults, runs = [], {}

    def cli(tag, argv, images_run, per_image):
        reset_counts(kern)
        t0 = time.perf_counter()
        results = test_cli.main([images, cfg_path, ckpt, '--work-dir',
                                 os.path.join(out, tag)] + argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(kern)
        want = {k: images_run * per_image * v
                for k, v in per_call(STC_FORWARD).items()}
        if counts != want:
            faults.append(f'{tag}: {images_run} images launched {counts}, '
                          f'want {want}')
        for k in launches:
            launches[k] += counts[k]
        runs[tag] = dict(images=images_run, seconds=seconds,
                         slices_per_s=images_run / seconds)
        return results

    restore = _quiet_logger()
    set_tf32(torch, cudnn, matmul)
    try:
        results = cli('eval', ['--eval', 'mIoU', 'mDice', '--out',
                               os.path.join(out, 'out.pkl'), '--show-dir',
                               os.path.join(out, 'vis')], n, 1)
        [json_name] = os.listdir(os.path.join(out, 'eval'))
        with open(os.path.join(out, 'eval', json_name)) as f:
            cli_metric = json.load(f)['metric']
        with open(os.path.join(out, 'out.pkl'), 'rb') as f:
            pickled = pickle.load(f)
        # the same checkpoint and split, directly
        cfg = Config.fromfile(cfg_path)
        cfg.data.test.update(data_root=images, img_dir=images,
                             ann_dir=images.replace('images', 'labels'),
                             test_mode=True)
        model = init_segmentor(cfg, ckpt)
        dataset = build_dataset(cfg.data.test)
        loader = build_dataloader(dataset, 1, 2, shuffle=False)
        pre = single_gpu_test(model, loader, pre_eval=True)
        maps = single_gpu_test(model, loader)
        metric = dataset.evaluate(pre, metric=['mIoU', 'mDice'],
                                  logger='silent')
        if json.loads(json.dumps(metric, default=str)) != cli_metric:
            faults.append(f'CLI metrics {cli_metric}, direct {metric}')
        if len(pickled) != n or any(
                not np.array_equal(np.stack(a), np.stack(b))
                for a, b in zip(pickled, pre)) or len(results) != n:
            faults.append('the --out pickle differs from the direct '
                          'pre_eval areas')
        painted = 0
        for i, m in enumerate(maps):
            sample = dataset[i]
            meta = sample['img_metas'][0]
            want = model.show_result(painted_image(sample['img'][0], meta),
                                     [m], palette=dataset.PALETTE)
            got = image.imread(os.path.join(out, 'vis',
                                            meta['ori_filename']))
            painted += int(np.array_equal(got, want))
        if painted != n:
            faults.append(f'{n - painted} --show-dir images differ from '
                          f'show_result')
        cli('format', ['--eval', 'cityscapes', '--eval-options',
                       f'imgfile_prefix={os.path.join(out, "fmt")}'], n, 1)
        formatted = sorted(os.listdir(os.path.join(out, 'fmt')))
        if len(formatted) != n or any(
                not np.array_equal(png.read(os.path.join(out, 'fmt', f)), m)
                for f, m in zip(formatted, maps)):
            faults.append(f'formatted results {formatted} differ from the '
                          f'label maps')
        # --aug-test on 2 images
        two = [os.path.splitext(dataset.img_infos[i]['filename'])[0]
               for i in range(2)]
        split = os.path.join(root, 'split_aug.txt')
        with open(split, 'w') as f:
            f.write(''.join(f'{s}\n' for s in two))
        aug_pre = cli('aug', ['--aug-test', '--eval', 'mIoU', 'mDice',
                              '--cfg-options', f'data.test.split={split}'],
                      2, 12)
        # its first image on the card and on the CPU
        aug_cfg = Config.fromfile(cfg_path)
        aug_cfg.data.test.pipeline[1].update(
            img_ratios=list(test_cli.AUG_RATIOS), flip=True)
        with open(split, 'w') as f:
            f.write(f'{two[0]}\n')
        aug_cfg.data.test.update(data_root=images, img_dir=images,
                                 ann_dir=images.replace('images', 'labels'),
                                 split=split, test_mode=True)
        one = build_dataloader(build_dataset(aug_cfg.data.test), 1, 0,
                               shuffle=False)
        card = init_segmentor(aug_cfg, ckpt)
        card_maps = single_gpu_test(card, one)
        card_pre = single_gpu_test(card, one, pre_eval=True)
        t0 = time.perf_counter()
        cpu = init_segmentor(aug_cfg, ckpt, device='cpu')
        kept, predict = [], cpu._predict
        cpu._predict = lambda s: kept.append(s) or predict(s)
        cpu_pre = single_gpu_test(cpu, one, pre_eval=True)
        cpu_s = time.perf_counter() - t0
        aug_check, f = compare_eval(
            card_maps, card_pre, cpu_pre, kept[0],
            TF32_LIMITS['margin_err_over_spread'])
        faults += [f'aug-test card vs CPU: {x}' for x in f]
        if len(aug_pre) != 2:
            faults.append(f'--aug-test gave {len(aug_pre)} results')
        del model, card, cpu
        set_tf32(torch, False, False)
        resumed, f = resume_ckpt_check(torch)
        faults += [f'resume: {x}' for x in f]
    finally:
        restore()
        set_tf32(torch, False, False)
    emit('test_cli', ok=not faults, faults=faults[:8],
         entry='python -m stc_unet_tpu_torch.tools.test (main(argv) in '
               'process)', checkpoint='train_path latest.pth',
         split=dict(images=n, size=TRAIN_PATH['size']), tf32=label,
         metrics=cli_metric, runs=runs,
         show_dir_equal=painted, formatted=len(formatted),
         aug_test_one_image=dict(cpu_s=cpu_s, **aug_check),
         resume_ckpt=resumed,
         launches={k: v for k, v in launches.items() if v},
         phase_s=time.perf_counter() - start,
         timer='each CLI run: host clock over main(argv), the card synced '
               'after (the model build, the checkpoint load and the '
               'dataset included)')
    if faults:
        raise AssertionError(f'test_cli: {faults[:4]}')
    torch.cuda.empty_cache()
    return launches


class _Batches:
    """A host loader's stand-in: the same collated batches each pass."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def phase_device_pipeline(torch):
    """The train augmentation on the card
    (``stc_unet_tpu_torch/datasets/device_pipeline.py``): writes
    ``DEVICE_PIPELINE``'s 24 learnable 512² pairs (the fixture of
    ``trained_path``), splits the flagship's train pipeline
    (``split_train_pipeline``) and loads the samples through its host
    prefix (decode, Resize to 600², ``DeviceFormatBundle``) into batches
    of 8. Faults: the program (crop, flip, photometric, normalize) on the
    card from one generator seed does not give the CPU's labels, the
    CPU's image without the photometric step bit for bit, or its image
    with it within ``photo_tol``; its outputs are not on ``cuda``; a
    ``DeviceBatchLoader`` on the card gives other bits with ``prefetch``
    2 (a side stream in a feeder thread) than with 0, or batches off the
    card. Times the program on a B=8 batch already on the card (CUDA
    events, and device time), its upload, and on one thread the host
    prefix's and the whole host pipeline's ms an image (median of 8, as
    ``train_path`` times the pipeline)."""
    import numpy as np
    from stc_unet_tpu_torch.datasets import (DeviceBatchLoader,
                                             build_dataset, collate,
                                             make_device_train_pipeline,
                                             split_train_pipeline)
    from stc_unet_tpu_torch.tools.parity_trained import build_learnable_kits
    from stc_unet_tpu_torch.utils import Config
    start = time.perf_counter()
    n, b = DEVICE_PIPELINE['images'], DEVICE_PIPELINE['batch']
    faults = []
    work = os.path.join(REPO, 'work_dirs')
    with tempfile.TemporaryDirectory(dir=work) as root:
        build_learnable_kits(root, n, 0, 512)
        cfg = Config.fromfile(os.path.join(REPO, STC_CONFIG))
        cfg.data.train.data_root = root
        host_cfg, params = split_train_pipeline(cfg.data.train.pipeline)
        full = build_dataset(cfg.data.train)
        full_ms = _median_ms(
            lambda i: full.load(i, np.random.RandomState(i)), range(8))
        prefix_cfg = Config(cfg.to_dict()).data.train
        prefix_cfg.pipeline = host_cfg
        prefix = build_dataset(prefix_cfg)
        prefix_ms = _median_ms(
            lambda i: prefix.load(i, np.random.RandomState(i)), range(8))
        batches = [collate([prefix.load(i, None)
                            for i in range(k * b, (k + 1) * b)])
                   for k in range(n // b)]
    batch = batches[0]
    valid = batch['valid_hw']
    img_cpu = torch.from_numpy(batch['img'])
    gt_cpu = torch.from_numpy(batch['gt_semantic_seg'])
    img_dev, gt_dev = img_cpu.cuda(), gt_cpu.cuda()

    def run(fn, img, gt):
        gen = torch.Generator().manual_seed(DEVICE_PIPELINE['seed'])
        return fn(gen, img, gt, valid)

    fn = make_device_train_pipeline(**params)
    plain = make_device_train_pipeline(**dict(params, photo_metric=False))
    card, cpu = run(fn, img_dev, gt_dev), run(fn, img_cpu, gt_cpu)
    card_plain, cpu_plain = run(plain, img_dev, gt_dev), \
        run(plain, img_cpu, gt_cpu)
    torch.cuda.synchronize()
    drawn = fn.draw(torch.Generator().manual_seed(DEVICE_PIPELINE['seed']),
                    b, tuple(img_cpu.shape[1:3]), valid)
    on_card = all(t.device.type == 'cuda' for t in card + card_plain)
    if not on_card:
        faults.append('the program\'s outputs are not on cuda')
    labels_equal = torch.equal(card[1].cpu(), cpu[1])
    plain_equal = torch.equal(card_plain[0].cpu(), cpu_plain[0]) and \
        torch.equal(card_plain[1].cpu(), cpu_plain[1])
    photo_err = (card[0].cpu() - cpu[0]).abs().max().item()
    if not labels_equal:
        faults.append('labels differ from the CPU\'s')
    if not plain_equal:
        faults.append('crop, flip and normalize differ from the CPU\'s')
    if not photo_err <= DEVICE_PIPELINE['photo_tol']:
        faults.append(f'photometric step {photo_err} off the CPU\'s')
    # the loader on the card, synchronous and prefetched
    streams = {}
    for prefetch in (0, 2):
        loader = DeviceBatchLoader(_Batches(batches), params, seed=0,
                                   prefetch=prefetch)
        streams[prefetch] = [(x['img'], x['gt_semantic_seg'])
                             for x in loader]
    torch.cuda.synchronize()
    stream_equal = len(streams[0]) == len(streams[2]) == n // b and all(
        torch.equal(a, c) for x, y in zip(streams[0], streams[2])
        for a, c in zip(x, y))
    stream_devices = sorted({t.device.type for s in streams.values()
                             for x in s for t in x})
    if not stream_equal:
        faults.append('prefetch 2 gives another stream than prefetch 0')
    if stream_devices != ['cuda']:
        faults.append(f'loader batches on {stream_devices}')
    # timing: the program on a batch on the card, the upload
    apply = lambda: fn.apply(img_dev, gt_dev, drawn)  # noqa: E731
    program_ms, program_device_ms = event_ms(torch, apply), device_ms(apply)
    upload_ms = event_ms(torch, lambda: (
        img_cpu.pin_memory().cuda(non_blocking=True),
        gt_cpu.pin_memory().cuda(non_blocking=True)))
    crop = params['crop_size']
    f32_pass_bytes = b * crop[0] * crop[1] * 3 * 4
    emit('device_pipeline', ok=not faults, faults=faults, config=STC_CONFIG,
         host_pipeline=[c['type'] for c in host_cfg],
         host_size=host_cfg[-2]['size'], params=params, batch=b,
         batches=n // b, input_shape=list(img_cpu.shape),
         output_shape=list(card[0].shape), output_dtype=str(card[0].dtype),
         label_dtype=str(card[1].dtype), outputs_on_cuda=on_card,
         labels_equal_cpu=labels_equal,
         crop_flip_normalize_equal_cpu=plain_equal,
         photometric_max_abs_err=photo_err,
         photometric_tol=DEVICE_PIPELINE['photo_tol'],
         prefetch_stream_bit_equal=stream_equal,
         loader_batch_devices=stream_devices,
         flips=int(drawn['flip'].sum()),
         photometric_masks={k: int(v.sum()) for k, v in
                            drawn['photometric'].items()
                            if k.startswith('do_')},
         program_ms=program_ms, program_device_ms=program_device_ms,
         upload_ms=upload_ms, f32_pass_mb=f32_pass_bytes / 1e6,
         f32_pass_bound_ms=2e3 * f32_pass_bytes / HBM_BYTES_PER_S,
         host_prefix_ms_per_image=prefix_ms,
         host_pipeline_ms_per_image=full_ms,
         phase_s=time.perf_counter() - start,
         timer='program: CUDA event pair (ms) and the sleep-kernel device '
               'time (device_ms), median of 10 after 2, on a B=8 batch '
               'already on the card; upload: event pair over pinning and '
               'copying the uint8 batch; host: median of 8 samples, one '
               'thread')
    if faults:
        raise AssertionError(f'device_pipeline: {faults}')
    del card, cpu, card_plain, cpu_plain, streams, img_dev, gt_dev
    torch.cuda.empty_cache()


def phase_profile_input(torch, kern, tf32):
    """``python -m stc_unet_tpu_torch.tools.profile_input`` (``main(argv)``
    in process) at ``PROFILE_INPUT``'s cut: the five input configurations
    (host, host with the disk cache, device, device with the disk cache,
    device with the RAM cache) through the train CLI at B=8, bf16, 2
    epochs each, at the TF32 setting ``tf32`` (torch's defaults). Faults:
    a device configuration's loader not a ``DeviceBatchLoader`` or a host
    one's not a ``DataLoader``; K1, K2 and K2b not launched 4 times a
    step. Returns the launches."""
    from stc_unet_tpu_torch.tools import profile_input
    start = time.perf_counter()
    label, cudnn, matmul = tf32
    epochs, batch = PROFILE_INPUT['epochs'], PROFILE_INPUT['batch']
    restore = _quiet_logger()
    faults = []
    set_tf32(torch, cudnn, matmul)
    try:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(REPO, 'work_dirs')) as wd:
            reset_counts(kern)
            record = profile_input.main([
                '--work-dir', wd, '--epochs', str(epochs), '--batch',
                str(batch), '--train-imgs', str(PROFILE_INPUT['train'])])
            torch.cuda.synchronize()
            counts = read_counts(kern)
    finally:
        restore()
        set_tf32(torch, False, False)
    tags = [c[0] for c in profile_input.CONFIGS]
    steps = len(tags) * epochs * PROFILE_INPUT['train'] // batch
    want = per_call(dict(strip_pools=4 * steps, gate_add=4 * steps,
                         gate_dots=4 * steps))
    if counts != want:
        faults.append(f'{steps} steps launched {counts}, want {want}')
    for tag, device_pipeline, _ in profile_input.CONFIGS:
        loader = 'DeviceBatchLoader' if device_pipeline else 'DataLoader'
        if record[f'loader_{tag}'] != loader:
            faults.append(f'{tag}: loader {record[f"loader_{tag}"]}')
    emit('profile_input', ok=not faults, faults=faults,
         entry='python -m stc_unet_tpu_torch.tools.profile_input '
               '(main(argv) in process)', config=STC_CONFIG, tf32=label,
         record=record, launches={k: v for k, v in counts.items() if v},
         phase_s=time.perf_counter() - start,
         timer='IterTimerHook on the host clock, means over the later '
               'iterations of each run\'s JSON log (log interval 1: the '
               'losses are read back each step)')
    if faults:
        raise AssertionError(f'profile_input: {faults}')
    torch.cuda.empty_cache()
    return counts


def phase_trained_path(torch, kern, tf32):
    """The trained-accuracy protocol, ``python -m
    stc_unet_tpu_torch.tools.parity_trained`` (``main(argv)`` in process):
    the JAX tool's learnable pseudo-KiTS fixture (``TRAINED_PATH``: 32
    train and 8 test 512² pairs), full-width STC-UNet trained through the
    train CLI at the JAX protocol (Adam lr 3e-4, B=8, bf16, 15 epochs)
    twice, as the JAX tool does: with the host pipeline, then with the
    augmentation on the card (``data.device_pipeline=True``), each run's
    checkpoint evaluated by the test CLI, at the TF32 setting ``tf32``
    (torch's defaults). ``TorchProfilerHook`` traces train steps 4 and 5
    of the device run. That run saves ``epoch_12.pth`` with its optimizer,
    and a third run resumes from it to epoch 15. Faults: either run's
    mDice under 0.9; the device run's loader not a ``DeviceBatchLoader`` or its batches
    off the card, or the host run's loader not a ``DataLoader``; no trace
    file, or no K2b kernel (``strip_band<..., true>``) in it; the resumed
    run's first step's losses off the unbroken run's by more than rtol
    1e-5 (the same weights, batch and dropout draw), or its final
    parameters by more than the Adam band 2·steps·lr; K1, K2 and K2b not
    launched 4 times a step (the three runs' and the tool's two steps
    timed alone) and K1 and K2 4 times a test forward (the test split
    once for each run). Returns the launches."""
    from stc_unet_tpu_torch.tools import parity_trained
    start = time.perf_counter()
    label, cudnn, matmul = tf32
    epochs, span = TRAINED_PATH['epochs'], TRAINED_PATH['resume_span']
    restore = _quiet_logger()
    faults = []
    work = os.path.join(REPO, 'work_dirs')
    set_tf32(torch, cudnn, matmul)
    try:
        with tempfile.TemporaryDirectory(dir=work) as wd:
            reset_counts(kern)
            record = parity_trained.main([
                '--work-dir', wd, '--epochs', str(epochs), '--batch',
                str(TRAINED_PATH['batch']), '--resume-span', str(span),
                '--profile', *map(str, TRAINED_PATH['profile'])])
            counts = read_counts(kern)
            trace = record.get('profile_trace')
            names = set()
            if trace and os.path.isfile(trace):
                with open(trace) as f:
                    names = {e.get('name', '') for e in
                             json.load(f).get('traceEvents', [])}
            k2b = sorted(x for x in names
                         if re.search(r'strip_band<[^<>]*true>', x))
    finally:
        restore()
        set_tf32(torch, False, False)
    # the runs' steps and each step timed alone on its run's last batch
    runs = record['runs']
    steps = record['resume']['steps'] + sum(
        r['steps'] + r['step_alone_steps'] for r in runs.values())
    forwards = record['test_imgs'] * len(runs)
    want = per_call(dict(strip_pools=4 * (steps + forwards),
                         gate_add=4 * (steps + forwards),
                         gate_dots=4 * steps))
    if counts != want:
        faults.append(f'{steps} steps and {forwards} test forwards launched '
                      f'{counts}, want {want}')
    for mode, run in runs.items():
        if run['port']['mDice'] < 0.9:
            faults.append(f'{mode} run: mDice {run["port"]["mDice"]} < 0.9')
    if list(runs) != ['host', 'device'] or \
            runs['host']['loader'] != 'DataLoader' or \
            runs['device']['loader'] != 'DeviceBatchLoader' or \
            not runs['device']['batch_device'].startswith('cuda'):
        faults.append(f'the runs\' loaders and batches: {runs}')
    if not k2b:
        faults.append(f'no K2b kernel in the trace {trace}')
    resume = record['resume']
    if any(e > 1e-5 for e in resume['first_step_loss_rel_err'].values()):
        faults.append(f'resumed first step {resume}')
    if resume['params_max_abs_err'] > resume['params_band']:
        faults.append(f'resumed parameters {resume}')
    record.pop('losses')
    emit('trained_path', ok=not faults, faults=faults,
         entry='python -m stc_unet_tpu_torch.tools.parity_trained '
               '(main(argv) in process)', config=STC_CONFIG,
         tf32=label, evaluated=list(runs), mdice=record['port']['mDice'],
         miou=record['port']['mIoU'],
         jax_mdice=record.get('jax', {}).get('mDice'),
         **{f'{k}_{mode}': runs[mode][k] for mode in runs
            for k in ('port', 'img_per_s', 'mean_data_time_s',
                      'data_time_first_mean_s',
                      'data_time_after_first_mean_s', 'host_share',
                      'step_alone_ms', 'loader', 'batch_device')},
         test_slices_per_s=record['test_slices_per_s'],
         trace_k2b_kernels=k2b, trace_events=len(names),
         record=record, launches={k: v for k, v in counts.items() if v},
         phase_s=time.perf_counter() - start,
         timer='epochs: host clock, the card synced at each start and end '
               '(data loading in); step alone: one CUDA event pair over 10 '
               'steps on the run\'s last batch after 2; data_time: '
               'IterTimerHook, the mean over the later iterations of the '
               'JSON log; test: host clock over the CLI')
    if faults:
        raise AssertionError(f'trained_path: {faults}')
    torch.cuda.empty_cache()
    return counts


def _median_ms(fn, items):
    times = []
    for item in items:
        t0 = time.perf_counter()
        fn(item)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kernels_of_call(torch, fn):
    """The names of the kernels (and memsets or copies) that one call of
    fn runs on the card, from ``torch.profiler``, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and
            e.name != 'Command Buffer Full']


def p_one_kernel(torch):
    """One call of P runs exactly one kernel in ``torch.profiler``: each
    way of adding its bands (one band, a cluster, the last band block) and
    the scalar path, on small bf16 inputs; {shape and way: kernel names}.
    ``main`` runs it before the model paths: after their long profiles,
    one run of this script on the card had the profiler record no kernel
    of a 13 µs call."""
    from stc_unet_tpu_torch.ops import dual_pools as dp
    one_kernel = {}
    for shape, way in (((2, 32, 32, 1024), None), ((2, 256, 16, 128), None),
                       ((2, 256, 16, 128), 'last'), ((1, 1025, 2, 64), None),
                       ((3, 37, 53, 24), None)):
        x = gates(torch, shape, torch.bfloat16, 590)[0]
        names = kernels_of_call(torch, lambda: dp._dual_pools_kernel(x, way))
        combine = dp.dual_plan(shape, 2, True, way)['combine']
        one_kernel[f'{list(shape)} {combine}'] = names
        if len(names) != 1 or 'dual_band' not in names[0]:
            raise AssertionError(f'P {shape} {combine}: not one kernel a '
                                 f'call: {names}')
        del x
    return one_kernel


def phase_coordatt_probe(torch, kern, one_kernel):
    """Kernel P against its plain version (rtol 1e-5, atol 1e-4, as K1;
    reruns bit-identical), f32 and bf16: at the probe's four B=14 stages,
    odd shapes, the edges of its tiling (``P_EDGES``) and, one element off
    16-byte alignment, ``P_UNALIGNED``; where a shape has 2 to 8 bands,
    with the bands added both in a cluster (the plan's way) and by the
    last band block. First each vector build of P in the built library
    must hold 128-bit loads (``cuobjdump -sass``); ``one_kernel`` is
    ``p_one_kernel``'s record, which the line carries. Then the probe itself
    (``stc_unet_tpu_torch/tools/probe_coordatt.py``): P, K1 and two
    ``torch.sum`` timed at the four stages. Returns P's rows, its launches
    in the probe and its max abs error."""
    from stc_unet_tpu_torch.ops import dual_pools as dp
    from stc_unet_tpu_torch.tools import probe_coordatt as pc
    built = pc.builds()
    if not pc.vector_builds_load_128(built['sass_loads']):
        raise AssertionError(f'P: not 12 builds, each vector build with '
                             f'128-bit or bulk loads: {built["sass_loads"]}')
    err, checked = 0.0, []
    cases = [((14, hw, hw, c), False) for hw, c in pc.STAGES]
    cases += [(s, False) for s in ODD + P_EDGES]
    cases += [(s, True) for s in P_UNALIGNED]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (shape, off) in enumerate(cases):
            x = gates(torch, shape, dtype, 500 + i)[0]
            if off:
                x = unaligned(torch, x)
            plan = dp.dual_plan(shape, x.element_size(),
                                x.data_ptr() % 16 == 0)
            ways = [None] + (['last'] if plan['combine'] == 'cluster'
                             else [])
            e = max(pc.check_dual_pools(x, way) for way in ways)
            err = max(err, e)
            checked.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                                unaligned=off, combine=plan['combine'],
                                vec=plan['vec'], err=e))
            del x
    torch.cuda.empty_cache()
    reset_counts(kern)
    rec = pc.probe(check=False)
    launches = read_counts(kern)
    if not launches['dual_pools'] or any(
            v for k, v in launches.items()
            if k not in ('dual_pools', 'strip_pools')):
        raise AssertionError(f'probe launches {launches}')
    rows = [bound(dict(ms=st['dual_pools_ms'],
                       device_ms=st['dual_pools_device_ms'],
                       plain_ms=st['torch_sums_ms'],
                       library_ms=st['torch_sums_ms'],
                       library_device_ms=st['torch_sums_device_ms'],
                       bytes=st['bytes'], flops=st['flops'],
                       shape=[st['batch'], st['hw'], st['hw'], st['c']]))
            for st in rec['stages']]
    emit('coordatt_probe', ok=True, launches=launches, max_abs_err=err,
         checked=checked, one_kernel_a_call=one_kernel,
         tolerance='rtol 1e-5 atol 1e-4 against two f32 torch.sum; reruns '
                   'bit-identical', **rec)
    return rows, launches['dual_pools'], err


def phase_slice(torch, kern, model, cpu_model_fn, config, modes, expected,
                phase='slice', card_model=None, check_size=256,
                margin_floor=0.0):
    """Serve requests in each of ``modes`` (B=2 at 512², bf16 images);
    check each forward's launches against ``expected``; hold the card's
    logits on a ``check_size``² image against the port on the CPU (f32,
    TF32 off) and, when ``card_model`` is given, against that model's on
    the card (``compare_logits``, with ``margin_floor`` and the config's
    ``LOGIT_ATOL``). Returns the launches."""
    g = torch.Generator(device='cuda').manual_seed(1)
    imgs = torch.rand((2, 512, 512, 3), generator=g,
                      device='cuda').to(torch.bfloat16)
    launches = dict.fromkeys(KERNELS, 0)
    want = per_call(expected)
    served = {}
    for mode in modes:
        model.test_cfg = dict(SLIDE) if mode == 'slide' else dict(mode=mode)
        reset_counts(kern)
        t0 = time.perf_counter()
        preds = model(return_loss=False, img=[imgs], img_metas=[metas(2, 512)])
        seconds = time.perf_counter() - t0
        counts = read_counts(kern)
        if counts != want:
            raise AssertionError(f'{mode}: kernel launches {counts}, want '
                                 f'{want}')
        for k in launches:
            launches[k] += counts[k]
        classes = model.out_channels
        if len(preds) != 2 or any(p.shape != (512, 512) or
                                  not 0 <= p.min() <= p.max() < classes
                                  for p in preds):
            raise AssertionError(f'{mode}: bad predictions')
        probs = model.inference(imgs, metas(2, 512), True)
        if probs.shape != (2, 512, 512, classes) or \
                not bool(torch.isfinite(probs).all()):
            raise AssertionError(f'{mode}: bad probabilities')
        served[mode] = dict(batch=2, launches=counts,
                            first_call_s=seconds,
                            foreground_share=float(
                                sum(p.mean() for p in preds) / len(preds)))
    # the card against the CPU, f32, TF32 off
    atol = LOGIT_ATOL.get(config, 1e-5)
    x = torch.rand((1, check_size, check_size, 3),
                   generator=torch.Generator().manual_seed(2))
    on_card = model.encode_decode(x.cuda()).float().cpu()
    checks = dict(cpu_check=compare_logits(
        torch, on_card, cpu_model_fn().encode_decode(x), margin_floor,
        atol))
    if card_model is not None:
        # and against another model on the card, from the same weights
        checks['card_check'] = compare_logits(
            torch, on_card, card_model.encode_decode(x.cuda()).float().cpu(),
            margin_floor, atol)
    emit(phase, ok=True, config=config, served=served, **checks)
    return launches


def compare_logits(torch, got, want, margin_floor=0.0, atol=1e-5):
    """got against want, (1, H, W, 2) f32 logits of one image in whole
    mode: rtol 1e-5 and ``atol`` (1e-5 but where ``LOGIT_ATOL`` says),
    the class margin within 1e-3 of its spread (or
    within ``margin_floor`` of the largest logit, if that is more), the
    argmax agreeing on 0.999 of the pixels. Raises, or returns the
    measures (``logit_measures``)."""
    m = logit_measures(got, want)
    # The seeded models' logits are small (STC-UNet: |max| ~0.2) and their
    # class margins spread ~1e-2, so the limits are set against those, not
    # against 1.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    margin_limit = max(1e-3 * m['margin_std'],
                       margin_floor * m['logits_abs_max'])
    if m['margin_max_abs_err'] > margin_limit:
        raise AssertionError(f'class margin off by {m["margin_max_abs_err"]}'
                             f', over 1e-3 of its spread {m["margin_std"]}'
                             f' and {margin_floor} of the largest logit')
    if m['argmax_agreement'] < 0.999:
        raise AssertionError(f'argmax agreement {m["argmax_agreement"]} < '
                             f'0.999')
    floor = (f' or {margin_floor} of the largest logit, if more'
             if margin_floor else '')
    return dict(size=got.shape[1], mode='whole', dtype='float32', **m,
                margin_limit=margin_limit,
                tolerance=f'logits rtol 1e-5 atol {atol}; class margin '
                          f'within 1e-3 of its std{floor}; argmax >= 0.999')


def whole_and_p50(torch, model, img):
    """Whole inference of the B=8 batch ``img[:8]`` (CUDA events, median
    of 5 after 2 warm-up calls) and the bs-1 p50 latency (host clock with
    synchronize, 20 calls after 2)."""
    model.test_cfg = dict(mode='whole')
    whole_ms = event_ms(torch, lambda: model.whole_inference(
        img[:8], None, False), iters=5)
    lat = []
    one = img[:1]
    for i in range(22):
        t0 = time.perf_counter()
        model.whole_inference(one, None, False)
        torch.cuda.synchronize()
        if i >= 2:
            lat.append((time.perf_counter() - t0) * 1e3)
    return whole_ms, statistics.median(lat)


def phase_maxvit_timing(torch, model, tf32):
    """MaxViT-UNet whole inference at the TF32 setting ``tf32`` (label,
    cudnn, matmul): B=8 and the bs-1 p50 on bf16 512² images, the peak
    memory, and one B=8 forward by kernel group."""
    label, cudnn, matmul = tf32
    set_tf32(torch, cudnn, matmul)
    g = torch.Generator(device='cuda').manual_seed(3)
    img = torch.rand((8, 512, 512, 3), generator=g,
                     device='cuda').to(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    whole_ms, p50 = whole_and_p50(torch, model, img)
    peak = torch.cuda.max_memory_allocated()
    emit('profile', run='maxvit whole', batch=8, tf32=label,
         **profile_run(torch, lambda: model.whole_inference(img, None, False),
                       whole_ms))
    set_tf32(torch, False, False)
    emit('maxvit_timing', config=MAXVIT_CONFIG, image='bf16 512x512',
         tf32=label, cudnn_allow_tf32=cudnn, matmul_allow_tf32=matmul,
         whole_ms_b8=whole_ms, whole_slices_per_s=8e3 / whole_ms,
         p50_ms_bs1=p50, peak_mem_gb=peak / 1e9,
         timer='CUDA events, median of 5 after 2 warmup; p50 on the host '
               'clock with synchronize, 20 calls')


def phase_timing(torch, model, settings, phase='timing', run='slide',
                 profile_whole=False, beside=None):
    """bench.py's protocol: slide B=14, whole B=8, p50 at bs 1, bf16; one
    row per TF32 setting ``(label, cudnn, matmul)``, each with the peak
    memory of the slide and the whole runs and a profile of one slide
    forward (and, with ``profile_whole``, of one whole B=8 and one bs-1
    forward). ``beside`` (rows of another run of this phase) goes into the
    line as it is."""
    g = torch.Generator(device='cuda').manual_seed(3)
    img = torch.rand((14, 512, 512, 3), generator=g,
                     device='cuda').to(torch.bfloat16)
    rows = []
    for label, cudnn, matmul in settings:
        set_tf32(torch, cudnn, matmul)
        model.test_cfg = dict(SLIDE)
        torch.cuda.reset_peak_memory_stats()
        slide_ms = event_ms(torch, lambda: model.slide_inference(
            img, None, False), iters=5)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        whole_ms, p50 = whole_and_p50(torch, model, img)
        rows.append(dict(
            tf32=label, cudnn_allow_tf32=cudnn, matmul_allow_tf32=matmul,
            slide_ms_b14=slide_ms, slide_slices_per_s=14e3 / slide_ms,
            slide_peak_mem_gb=peak / 1e9,
            whole_ms_b8=whole_ms, whole_slices_per_s=8e3 / whole_ms,
            whole_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            p50_ms_bs1=p50))
        model.test_cfg = dict(SLIDE)
        emit('profile', run=run, batch=img.shape[0], tf32=label,
             **profile_run(torch, lambda: model.slide_inference(
                 img, None, False), slide_ms))
        if profile_whole:
            model.test_cfg = dict(mode='whole')
            for batch, ms in ((8, whole_ms), (1, p50)):
                emit('profile', run=f'{phase} whole', batch=batch,
                     tf32=label, **profile_run(
                         torch, lambda: model.whole_inference(
                             img[:batch], None, False), ms))
    set_tf32(torch, False, False)
    emit(phase, image='bf16 512x512', timer='CUDA events, median of 5 '
         'after 2 warmup; p50 on the host clock with synchronize, 20 calls',
         rows=rows, **({} if beside is None else dict(einsum_rows=beside)))
    return rows


def bound(r, flop_rate=F32_FLOPS, key='bound'):
    """Fill in r's bound: the largest of its bytes over the memory rate,
    its flops over ``flop_rate`` (the peak for their inputs' type) and its
    exponentials (``exps``, if any) over the special-function units'
    rate; as ``{key}_ms`` and ``{key}_by``. ``flash_rows`` also fills
    ``bound_tc`` at TF32_FLOPS / 3: products in 3xTF32, three TF32 products
    per f32 product on the tensor cores."""
    t_bytes = r['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = max(r['flops'] / flop_rate, r.get('exps', 0) / EXPS_PER_S) * 1e3
    r.update({f'{key}_ms': max(t_bytes, t_ops),
              f'{key}_by': 'bytes' if t_bytes >= t_ops else 'operations'})
    return r


def achieved(r):
    """r's achieved rate, its bytes over its device time, as ``gb_s``."""
    r['gb_s'] = r['bytes'] / (r['device_ms'] * 1e-3) / 1e9
    return r


def coordatt_rows(torch, cf, x, a_h, a_w):
    """K1 and K2 on x (N, H, W, C) timed beside their plain versions and
    one-call PyTorch yardsticks; the rows, without their bounds."""
    xb = x.numel() * x.element_size()
    sb = (a_h.numel() + a_w.numel()) * 4     # K1's f32 sums
    gb = (a_h.numel() + a_w.numel()) * x.element_size()   # K2's gates
    rows = dict(
        strip_pools=timed(
            torch, lambda: cf.strip_pools(x),
            lambda: (torch.sum(x, 2, dtype=torch.float32),
                     torch.sum(x, 1, dtype=torch.float32)),
            lambda: cf.strip_pools_reference(x)),
        gate_add=timed(
            torch, lambda: cf.gate_add(x, a_h, a_w),
            lambda: torch.addcmul(x, a_h[:, :, None, :], a_w[:, None, :, :]),
            lambda: cf.gate_add_reference(x, a_h, a_w)))
    rows['strip_pools'].update(
        library='torch.sum(x, 2, dtype=f32) + torch.sum(x, 1, dtype=f32), '
                'two calls', bytes=xb + sb, flops=2 * x.numel())
    rows['gate_add'].update(
        library='torch.addcmul(x, a_h[:,:,None,:], a_w[:,None,:,:])',
        bytes=2 * xb + gb, flops=2 * x.numel())
    return rows


def gate_dots_row(torch, cf, do, a_h, a_w):
    """K2b on do timed beside its plain version and two einsums (cuBLAS's
    reductions kept in f32), then held against its plain version; the row
    with its bound and achieved rate."""
    dtype = str(do.dtype)[6:]
    r = timed(torch, lambda: cf.gate_dots(do, a_h, a_w),
              lambda: (torch.einsum('nhwc,nwc->nhc', do, a_w),
                       torch.einsum('nhwc,nhc->nwc', do, a_h)),
              lambda: cf.gate_dots_reference(do, a_h, a_w))
    r.update(
        library=f'torch.einsum nhwc,nwc->nhc + nhwc,nhc->nwc ({dtype}, '
                'f32 accumulation), two calls',
        bytes=(do.numel() + a_h.numel() + a_w.numel()) * do.element_size() +
        (a_h.numel() + a_w.numel()) * 4,
        flops=4 * do.numel(), shape=list(do.shape),
        max_abs_err=check_gate_dots(torch, cf, do, a_h, a_w))
    return achieved(bound(r))


def totals(rows, keys=('ms', 'device_ms', 'plain_ms', 'library_ms',
                       'library_device_ms', 'bound_ms')):
    """{name}_total_{key} over each kernel's rows."""
    return {f'{name}_total_{key}': sum(r[key] for r in rs)
            for name, rs in rows.items() for key in keys}


def phase_kernel_timing(torch, cf, err):
    """K1 and K2 at the Up-stage shapes of the B=14 slide batch (126
    tiles, f32 x as in the model), K2b at those of the B=8 train batch
    (bf16, as the train step gives them), each beside its plain version
    and a one-call PyTorch yardstick; then each held against its plain
    version on those inputs, its max abs error folded into err. K1 and K2
    are also held against theirs at the bf16 train shapes, and timed there
    beside their yardsticks (``train_bf16``, with K2b's rows), and K2b is
    timed and held at the slide shapes in f32 too (``slide_f32``). Every
    K1 and K2b row has its achieved rate (``gb_s``: bytes over
    device_ms)."""
    n = 14 * 9
    per = {name: [] for name in KERNELS}
    slide_f32 = dict(gate_dots=[])
    for h, w, c in STAGES:
        x = torch.randn((n, h, w, c), device='cuda')
        a_h = torch.rand((n, h, c), device='cuda')
        a_w = torch.rand((n, w, c), device='cuda')
        rows = coordatt_rows(torch, cf, x, a_h, a_w)
        for name, r in rows.items():
            r['shape'] = [n, h, w, c]
            per[name].append(bound(r))
        achieved(rows['strip_pools'])
        e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
        err['strip_pools'] = max(err['strip_pools'], e1)
        err['gate_add'] = max(err['gate_add'], e2)
        rows['strip_pools']['max_abs_err'] = e1
        rows['gate_add']['max_abs_err'] = e2
        r = gate_dots_row(torch, cf, x, a_h, a_w)   # x as do
        err['gate_dots'] = max(err['gate_dots'], r['max_abs_err'])
        slide_f32['gate_dots'].append(r)
        del x, a_h, a_w
        torch.cuda.empty_cache()
    # K2b's yardstick: two einsums, with cuBLAS's reductions kept in f32
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    train_checked = []
    train_bf16 = {name: [] for name in CF_KERNELS}
    for i, (h, w, c) in enumerate(WHOLE_STAGES):
        shape = (TRAIN_BATCH, h, w, c)
        x, do, a_h, a_w = gates(torch, shape, torch.bfloat16, 100 + i)
        # the train step gives K1 and K2 these shapes too
        e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
        err['strip_pools'] = max(err['strip_pools'], e1)
        err['gate_add'] = max(err['gate_add'], e2)
        train_checked.append(dict(shape=list(shape), strip_pools_err=e1,
                                  gate_add_err=e2))
        for name, r in coordatt_rows(torch, cf, x, a_h, a_w).items():
            r['shape'] = list(shape)
            train_bf16[name].append(bound(r))
        achieved(train_bf16['strip_pools'][-1])
        del x
        r = gate_dots_row(torch, cf, do, a_h, a_w)
        err['gate_dots'] = max(err['gate_dots'], r['max_abs_err'])
        per['gate_dots'].append(r)
        train_bf16['gate_dots'].append(r)
        del do, a_h, a_w
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    torch.cuda.empty_cache()
    emit('kernel_timing', dtype=dict(strip_pools='float32',
                                     gate_add='float32',
                                     gate_dots='bfloat16'),
         batch=dict(strip_pools=n, gate_add=n, gate_dots=TRAIN_BATCH),
         timer='ms: CUDA event pair, host time included (as in earlier runs); '
               'device_ms: the host hidden behind a sleep kernel',
         stages=per, train_shapes_checked=dict(dtype='bfloat16',
                                               rows=train_checked),
         train_bf16=dict(batch=TRAIN_BATCH, rows=train_bf16,
                         **totals(train_bf16)),
         slide_f32=dict(batch=n, rows=slide_f32, **totals(slide_f32)))
    return per


def phase_fork_kernel_timing(torch, cf, err):
    """K1 at CARUnet's seven CoordAtt shapes of a B=8 512² batch
    (``CARUNET_K1``), in f32 and in bf16 (the train step's): each held
    against its plain version and its own rerun (``check_strip_pools``,
    its max abs error folded into err), then timed beside its plain
    version and two ``torch.sum`` (``ms``, ``device_ms``), with its bound
    (bytes over 3.35 TB/s), achieved GB/s and launch plan (16-byte
    vectors where C is a multiple of 32 floats or 64 bfloat16, else one
    element a lane). The totals are one CARUnet-ca forward's seven
    launches; ``loses_to_library`` lists the shapes where the two
    ``torch.sum`` take less device time."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        rows[name] = []
        for i, shape in enumerate(CARUNET_K1):
            g = torch.Generator(device='cuda').manual_seed(200 + i)
            x = torch.randn(shape, generator=g, device='cuda').to(dtype)
            e = check_strip_pools(torch, cf, x)
            err['strip_pools'] = max(err['strip_pools'], e)
            r = timed(torch, lambda: cf.strip_pools(x),
                      lambda: (torch.sum(x, 2, dtype=torch.float32),
                               torch.sum(x, 1, dtype=torch.float32)),
                      lambda: cf.strip_pools_reference(x))
            n, h, w, c = shape
            plan = cf.strip_plan(shape, x.element_size(),
                                 x.data_ptr() % 16 == 0)
            r.update(shape=list(shape), max_abs_err=e,
                     vector_loads=bool(plan['vec']),
                     bytes=x.numel() * x.element_size() +
                     (n * h * c + n * w * c) * 4, flops=2 * x.numel())
            rows[name].append(achieved(bound(r)))
            del x
    torch.cuda.empty_cache()
    emit('fork_kernel_timing', kernel='strip_pools', batch=8,
         shapes='CARUnet-ca: encoder 16/32/64/64, decoder 32/16/16',
         library='torch.sum(x, 2, dtype=f32) + torch.sum(x, 1, dtype=f32), '
                 'two calls',
         timer='ms: CUDA event pair, host time included; device_ms: the '
               'host hidden behind a sleep kernel',
         tolerance='rtol 1e-5 atol 1e-4, bit-identical reruns',
         rows=rows,
         totals={name: totals(dict(strip_pools=rs))
                 for name, rs in rows.items()},
         loses_to_library={name: [r['shape'] for r in rs
                                  if r['device_ms'] > r['library_device_ms']]
                           for name, rs in rows.items()})
    return rows


def train_step_for(torch, model, compute_dtype=None, mesh=None,
                   remat=False, optim=None):
    """The port's train step on model and its optimizer: bench.py's Adam
    and poly lr, or ``optim`` (``(optimizer, lr_config, max_iters)``)
    (over the ranks of ``mesh``, if given; rematerialising the whole loss
    with ``remat``)."""
    from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
    from stc_unet_tpu_torch.engine import make_train_step
    opt_cfg, lr_config, max_iters = optim or (OPTIMIZER, LR_CONFIG,
                                              MAX_ITERS)
    schedule = build_lr_schedule(lr_config, opt_cfg['lr'], max_iters)
    optimizer = build_optimizer(model, opt_cfg)
    return make_train_step(model, optimizer, schedule,
                           compute_dtype=compute_dtype, mesh=mesh,
                           remat=remat), optimizer


def grad_errors(grads, ref, norms=None):
    """Per tensor, |g - ref| / |ref| in 2-norms, over the tensors whose
    norm is at least 1e-4 of the largest; and the same over all tensors
    as one vector. ``norms`` holds ``ref``'s norms where the caller has
    them (``ref_norms``)."""
    norms = norms or ref_norms(ref)
    big = max(norms.values())
    diff = {k: (grads[k] - r).norm().item() for k, r in ref.items()}
    whole = math.sqrt(sum(d * d for d in diff.values()) /
                      sum(n * n for n in norms.values()))
    return {k: diff[k] / norms[k] for k in ref
            if norms[k] >= 1e-4 * big}, whole


def ref_norms(ref):
    """The 2-norm of each tensor of ``ref``."""
    return {k: r.norm().item() for k, r in ref.items()}


def first_grads(torch, model, img, gt):
    """The gradient of the train losses of ``model`` (train mode) on one
    batch, as f32 tensors on the CPU."""
    from stc_unet_tpu_torch.engine import total_loss_from_dict
    model.train()
    total, _ = total_loss_from_dict(model.compute_losses(img, gt))
    total.backward()
    return {k: p.grad.float().cpu() for k, p in model.named_parameters()}


def nudges(torch, model, state, img):
    """For each of ``NUDGE_SEEDS``, the inputs of one nudge
    (``nudged_grads``): each parameter of ``model`` in ``state``, in its
    order, then ``img``, with every element moved by one part in 2^23 (one
    f32 ulp or less), up where a draw from the seed's CPU generator is
    under 0.5, else down; as (the moved parameters by name, the moved
    image). torch draws from a CPU generator one element at a time, so
    each seed's generator runs in a thread of its own (torch and numpy
    leave the interpreter lock while they work); each draws its tensors in
    the order one nudge does, so the draws are those of drawing them a
    nudge at a time. The threads move the elements in numpy, whose f32
    product is torch's: a torch op there starts a team of OpenMP threads
    in each thread, and with those DC-UNet's train check took up to three
    times as long."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    params = dict(model.named_parameters())
    moved = [(k, v) for k, v in state.items() if k in params]
    moved.append((None, img))
    up, down = np.float32(1 + 2.0 ** -23), np.float32(1 - 2.0 ** -23)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        out = {k: torch.from_numpy(np.where(
            torch.rand(t.shape, generator=g).numpy() < 0.5, up, down) *
            t.numpy()) for k, t in moved}
        return out, out.pop(None)

    with ThreadPoolExecutor(len(NUDGE_SEEDS)) as pool:
        return list(pool.map(draw, NUDGE_SEEDS))


def nudged_grads(torch, model, state, gt, nudge, prepare=None,
                 stats=False):
    """The first step's gradients of the port on the CPU after moving the
    image and every parameter by one part in 2^23 (one f32 ulp or less),
    as ``nudge`` (one seed's of ``nudges``: the moved parameters of
    ``state`` and image) gives them: how far f32 rounding alone moves the
    gradient here. Taken on the CPU, so that nothing the card does widens
    it, on ``model``, a CPU model of the config that takes the nudged
    ``state`` (its gradients cleared; one model serves every nudge). With
    ``stats``, also the BN running stats after that step."""
    moved, img = nudge
    model.zero_grad(set_to_none=True)
    model.load_state_dict({k: moved.get(k, v) for k, v in state.items()})
    if prepare is not None:
        prepare(model)
    grads = first_grads(torch, model, img, gt)
    return (grads, first_step(model)['stats']) if stats else grads


def check_pair(torch, cfg, init_segmentor, size, prepare=None, seed=0,
               source=None):
    """The models and batch of a train check: the card's model, with
    ``init_weights(seed)`` past seed 0 (init_segmentor's), or a copy of
    ``source``, a card model of ``cfg`` but for its dropout rates that
    ``prepare`` sets to 0 (no second build and init); the port on the CPU
    with its state, ``prepare(model)`` applied to both; the state before
    ``prepare``; and a B=2 f32 batch of ``size``² images from seed 4 +
    ``seed``, with ignored pixels."""
    card = init_segmentor(cfg) if source is None else copy.deepcopy(source)
    if seed:
        card.init_weights(seed)
    cpu = copy.deepcopy(card).cpu()
    state = {k: v.cpu().clone() for k, v in card.state_dict().items()}
    if prepare is not None:
        prepare(card)
        prepare(cpu)
    g = torch.Generator().manual_seed(4 + seed)
    img = torch.rand((2, size, size, 3), generator=g)
    gt = (img.mean(-1) > 0.5).long()
    gt[:, :3] = 255                      # ignored pixels
    return card, cpu, state, img, gt


def _worst(rel, k=6):
    return dict(sorted(rel.items(), key=lambda kv: -kv[1])[:k])


def step_faults(a, b, yard_whole, yard, pixel, stats_yard=None):
    """Run ``a`` of two train steps against run ``b`` (each a dict of the
    steps' ``logs``, the first step's ``grads`` and BN ``stats``) in
    ``train_check``'s bands: each step's losses to rtol 1e-5 and
    ``acc_seg`` to 3 pixels (``pixel``, one pixel's share in %), the
    first gradient as a whole within 3x ``yard_whole`` and each tensor
    within 3x its own ``yard`` (the one-ulp yardsticks), the first step's
    BN running stats to rtol 1e-4 / atol 1e-5, or, where ``stats_yard``
    gives a tensor's one-ulp yardstick, to 3x it if that is more. Returns
    (faults, the per-tensor gradient errors, the whole's, the stats'
    largest error)."""
    faults = []
    # the losses: f32 sums in another order (rtol 1e-5); the accuracy
    # counts pixels, and the seeded model's class margins are ~1e-3, so a
    # few pixels near the boundary may flip: at most 3
    for x, y in zip(a['logs'], b['logs']):
        for k in y:
            limit = 1e-5 * abs(y[k]) + 1e-6 if 'loss' in k else 3 * pixel
            if not math.isfinite(x[k]) or abs(x[k] - y[k]) > limit:
                faults.append(f'{k}: {x[k]} against {y[k]}')
    # the gradients, |g - g_ref| / |g_ref| in 2-norms, as one vector and
    # per tensor. Tensors whose gradient is 0 up to noise (the conv biases
    # before a train-mode BN) are left out of the per-tensor figures: those
    # under 1e-4 of the largest norm.
    rel, whole = grad_errors(a['grads'], b['grads'])
    if whole > 3 * yard_whole:
        faults.append(f'gradient off by {whole} of its norm, over 3 x '
                      f'{yard_whole}')
    floor = min(yard.values())
    faults += [f'gradient {k} off by {e} of its norm, over 3 x '
               f'{yard.get(k, floor)}'
               for k, e in rel.items() if e > 3 * yard.get(k, floor)]
    # the BN running stats after the first step, which come from the
    # forward of the same weights (rtol 1e-4, atol 1e-5); the second
    # step's follow Adam's first update, whose sign on coordinates with a
    # near-zero gradient is noise (tools/parity_train.py), so only its
    # count is checked
    stats_err = 0.0
    for k, ref in b['stats'].items():
        diff = (a['stats'][k] - ref).abs()
        stats_err = max(stats_err, diff.max().item())
        limit = 1e-5 + 1e-4 * ref.abs()
        if stats_yard is not None:
            limit = limit.clamp(min=3 * stats_yard[k])
        if bool((diff > limit).any()):
            faults.append(f'{k} off by {diff.max().item()}')
    return faults, rel, whole, stats_err


def phase_train_check(torch, cfg, init_segmentor, size, phase='train_check',
                      focus=('coordatt', '.ca.'), prepare=None,
                      step2_from_cpu=False, grad_floor=GRAD_FLOOR,
                      remat=None, stats_yard=False, bn_calls=None,
                      source=None):
    """Two train steps at full width on the card and on the port on the
    CPU, from the same weights: ``size``² images, B=2, f32, TF32 off (set
    by main), with every dropout rate of ``cfg`` at 0 (set by the caller;
    ``prepare(model)``, when given, is applied to every model built here,
    for rates the config does not set). With ``step2_from_cpu`` the card's
    second step starts from the CPU's parameters, buffers and Adam state
    after the first, so that it is held as tightly as the first: Adam
    moves a coordinate whose gradient is f32 noise by up to lr, so two
    correct runs drift apart after a step (in DC-UNet enough to move the
    second loss by 1.6e-5 of itself).
    Compares each step's losses, the first step's gradients and BN running
    stats, and the step count of every BN (``step_faults``): 2, or twice
    ``bn_calls(key)`` for a BN that runs more than once a forward (torch
    counts each run; MultiResUnet's ``multires_bn_calls``). ``focus`` (a
    name and a key fragment) picks the tensors of the kernels' layers for
    their own report. ``source`` is ``check_pair``'s.

    The gradient of the seeded full-width model at this input is touchy:
    moving the image and the weights by one f32 ulp moves it by about 1 %
    of its norm as a whole, and single deep tensors by a few percent. So
    the card's first-step gradient is held to the CPU's within 3 times
    what the largest of eight such one-ulp nudges does to the CPU's own
    gradient (the yardstick, measured in the same run): as a whole against
    the whole's yardstick, and each tensor against its own (at least
    ``grad_floor``). A nudge moves nearly every tensor together, by an
    amount that varies several-fold from one nudge to the next, so two
    nudges are too few to gauge it, and four were too few for the flash
    model (one of them moved its gradient by a third of what it moved the
    einsum model's). The kernels themselves are held tightly in phases
    ``kernels``, ``window_attention_kernels`` and
    ``flash_attention_kernels``, their autograd included. With
    ``stats_yard`` each BN stat tensor may also be off by 3 times the
    most the nudges move it (a BN after a convolution of a large fan-in,
    whose batch mean is a small difference of large sums: the ResNet
    models' PSP and ASPP bottlenecks sum 4096 and 2560 channels over 3x3).

    ``remat`` (``(kern, config, make_cfg, modes)``) also runs the two
    steps on the card in each rematerialised mode: ``'loss'`` is
    ``make_train_step(remat=True)``, any other mode the model of
    ``make_cfg(mode)`` (its ``with_cp``), from the same weights (and, with
    ``step2_from_cpu``, the same second start). Each is held in the same
    bands to the CPU and to the card's plain steps, its BN counts must be
    2, and each step must launch the forward kernels twice and the
    backward ones once as often as the plain step (``remat_launches``);
    one ``remat_train_check`` line."""
    card, cpu, cpu_state, img, gt = check_pair(torch, cfg, init_segmentor,
                                               size, prepare, source=source)
    (card_step, card_opt), (cpu_step, cpu_opt) = (
        train_step_for(torch, card), train_step_for(torch, cpu))
    kern = None if remat is None else remat[0]
    runs = {'card': dict(logs=[], counts=[]), 'cpu': dict(logs=[])}
    start2 = None
    for i in range(2):
        for where, model, step in (('card', card, card_step),
                                   ('cpu', cpu, cpu_step)):
            dev = 'cuda' if where == 'card' else 'cpu'
            if i == 1 and where == 'card' and step2_from_cpu:
                # copies: the CPU's second step updates its tensors in place
                start2 = ({k: v.clone() for k, v in
                           cpu.state_dict().items()},
                          copy.deepcopy(cpu_opt.state_dict()))
                card.load_state_dict(start2[0])
                card_opt.load_state_dict(start2[1])
            if kern is not None:
                reset_counts(kern)
            lv = step(img.to(dev), gt.to(dev))
            if where == 'card' and kern is not None:
                runs[where]['counts'].append(read_counts(kern))
            runs[where]['logs'].append({k: v.item() for k, v in lv.items()})
            if i == 0:
                runs[where].update(first_step(model))
    faults = []
    pixel = 100.0 / int((gt != 255).sum())
    nudged, syard = [], None
    spare = copy.deepcopy(cpu)
    norms = ref_norms(runs['cpu']['grads'])
    for n in nudges(torch, spare, cpu_state, img):
        grads, stats = nudged_grads(torch, spare, cpu_state, gt, n, prepare,
                                    stats=True)
        nudged.append(grad_errors(grads, runs['cpu']['grads'], norms))
        if stats_yard:
            moved = {k: (v - runs['cpu']['stats'][k]).abs().max().item()
                     for k, v in stats.items()}
            syard = moved if syard is None else {
                k: max(v, moved[k]) for k, v in syard.items()}
    yard_whole = max(w for _, w in nudged)
    yard = {k: max(grad_floor, *(r[k] for r, _ in nudged))
            for k in nudged[0][0]}
    found, rel, whole, stats_err = step_faults(
        runs['card'], runs['cpu'], yard_whole, yard, pixel, syard)
    faults += found
    ratio = {k: e / yard[k] for k, e in rel.items()}
    name, part = focus
    focused = {k: e for k, e in rel.items() if part in k}
    for m in (card, cpu):
        for k, v in m.state_dict().items():
            if not k.endswith('num_batches_tracked'):
                continue
            want = 2 * (1 if bn_calls is None else bn_calls(k))
            if int(v) != want:
                faults.append(f'{k}: {int(v)}, want {want}')
    emit(phase, ok=not faults, faults=faults[:8], size=size, batch=2,
         dtype='float32', tf32=False, step2_from_cpu=step2_from_cpu,
         dropout_ratio=0.0, losses={k: r['logs'] for k, r in runs.items()},
         grad_tensors=len(runs['cpu']['grads']),
         grad_tensors_compared=len(rel),
         grad_whole=whole, grad_tensor_median=statistics.median(rel.values()),
         grad_worst=_worst(rel),
         **{f'grad_{name}_worst': _worst(focused, 4),
            f'grad_{name}_over_own_one_ulp_worst': _worst(
                {k: r for k, r in ratio.items() if part in k}, 4),
            f'one_ulp_{name}_worst': [
                _worst({k: e for k, e in r.items() if part in k}, 2)
                for r, _ in nudged]},
         grad_over_own_one_ulp_worst=_worst(ratio),
         one_ulp_whole=[w for _, w in nudged],
         one_ulp_tensor_median=[statistics.median(r.values())
                                for r, _ in nudged],
         one_ulp_worst=[_worst(r, 3) for r, _ in nudged],
         bn_stats_step1_max_abs_err=stats_err,
         bn_stats_one_ulp_worst=None if syard is None else _worst(syard, 4),
         tolerance=f'losses rtol 1e-5; acc_seg within 3 pixels; gradient '
                   f'as a whole within 3x the largest of '
                   f'{len(NUDGE_SEEDS)} one-ulp wholes, each tensor within '
                   f'3x the largest of its own {len(NUDGE_SEEDS)} one-ulp '
                   f'changes (at least {grad_floor}), nudges on the CPU; '
                   f'step-1 BN stats rtol 1e-4 atol 1e-5' +
                   ('' if syard is None else
                    ', or 3x their own one-ulp change if more'))
    if faults:
        raise AssertionError(f'{phase}: {faults[:3]}')
    del card, card_step, card_opt
    torch.cuda.empty_cache()
    if remat is not None:
        remat_checks(torch, init_segmentor, remat, cfg, cpu_state, img, gt,
                     prepare, start2, runs, yard_whole, yard, pixel, syard)
    del cpu, cpu_step, cpu_opt
    torch.cuda.empty_cache()


def first_step(model):
    """The first step's gradients and BN running stats, on the CPU."""
    return dict(grads={k: p.grad.float().cpu() for k, p in
                       model.named_parameters()},
                stats={k: v.cpu().clone() for k, v in
                       model.state_dict().items()
                       if k.endswith(('running_mean', 'running_var'))})


def remat_launches(plain):
    """A rematerialised step's launches: the forward kernels run again in
    the backward's recompute, the backward ones once."""
    return {k: n * (2 if k in FORWARD_KERNELS else 1)
            for k, n in plain.items()}


def remat_checks(torch, init_segmentor, remat, cfg, state, img, gt,
                 prepare, start2, runs, yard_whole, yard, pixel, syard):
    """``phase_train_check``'s rematerialised modes (see there)."""
    kern, config, make_cfg, modes = remat
    faults, results = [], {}
    for mode in modes:
        model = init_segmentor(cfg if mode == 'loss' else make_cfg(mode))
        model.load_state_dict(state)
        if prepare is not None:
            prepare(model)
        step, opt = train_step_for(torch, model, remat=mode == 'loss')
        run = dict(logs=[], counts=[])
        for i in range(2):
            if i == 1 and start2 is not None:
                model.load_state_dict(start2[0])
                opt.load_state_dict(start2[1])
            reset_counts(kern)
            lv = step(img.cuda(), gt.cuda())
            run['counts'].append(read_counts(kern))
            run['logs'].append({k: v.item() for k, v in lv.items()})
            if i == 0:
                run.update(first_step(model))
        row = dict(launches_per_step=run['counts'][0], losses=run['logs'])
        for against in ('cpu', 'card'):
            found, rel, whole, stats_err = step_faults(
                run, runs[against], yard_whole, yard, pixel, syard)
            faults += [f'{mode} against the {against}: {f}' for f in found]
            row[f'against_{against}'] = dict(
                grad_whole=whole, grad_worst=_worst(rel, 3),
                bn_stats_step1_max_abs_err=stats_err)
        want = [remat_launches(c) for c in runs['card']['counts']]
        if run['counts'] != want:
            faults.append(f'{mode}: launches {run["counts"]}, want {want}')
        faults += [f'{mode}: {k} {int(v)}, want 2'
                   for k, v in model.state_dict().items()
                   if k.endswith('num_batches_tracked') and int(v) != 2]
        results[mode] = row
        del model, step, opt
        torch.cuda.empty_cache()
    emit('remat_train_check', ok=not faults, faults=faults[:8],
         config=config, size=int(img.shape[1]), batch=2, dtype='float32',
         tf32=False,
         plain_launches_per_step=runs['card']['counts'][0], modes=results,
         tolerance="train_check's bands, against the CPU's plain steps and "
                   "the card's; launches: the forward kernels twice")
    if faults:
        raise AssertionError(f'remat_train_check: {faults[:3]}')


def phase_train(torch, kern, model, settings, config, expected,
                dropout_ratio, phase='train', batch=TRAIN_BATCH, remat=False,
                profile=True, optim=None):
    """bench.py's train step on the full-width model: ``batch`` (B=8)
    images at 512², bf16 compute, Adam lr 1e-5 with the poly lr (or
    ``optim``, ``train_step_for``'s), the config's dropout from a seeded
    generator (``remat``: the step rematerialises its whole loss); the
    auxiliary heads' entries of the log vars are counted. Per TF32
    setting ``(label, cudnn,
    matmul)``: 2 warm-up steps, each checked to launch the kernels
    ``expected`` times, then 10 steps timed with one CUDA event pair; the
    loss must be finite and every parameter must move but the config's
    ``STILL``, which must not. With ``profile``
    the first setting's run is profiled by kernel group. Returns the
    launches of all steps."""
    g = torch.Generator(device='cuda').manual_seed(5)
    img = torch.rand((batch, 512, 512, 3), generator=g, device='cuda')
    gt = (img.mean(-1) > 0.5).long()
    drop = torch.Generator(device='cuda').manual_seed(6)
    params = dict(model.named_parameters())
    launches = dict.fromkeys(KERNELS, 0)
    want = per_call(expected)
    rows = []
    for label, cudnn, matmul in settings:
        set_tf32(torch, cudnn, matmul)
        step, _ = train_step_for(torch, model, torch.bfloat16, remat=remat,
                                 optim=optim)
        before = {k: p.detach().clone() for k, p in params.items()}
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(2):
            reset_counts(kern)
            log_vars = step(img, gt, drop)
            losses.append(log_vars['loss'])
            counts = read_counts(kern)
            if counts != want:
                raise AssertionError(f'train step launches {counts}, want '
                                     f'{want}')
            for k in KERNELS:
                launches[k] += counts[k]
        iters = 10
        reset_counts(kern)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            losses.append(step(img, gt, drop)['loss'])
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        counts = read_counts(kern)
        if counts != {k: iters * n for k, n in want.items()}:
            raise AssertionError(f'{iters} train steps launched {counts}')
        for k in KERNELS:
            launches[k] += counts[k]
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).float().cpu()
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f'train loss not finite: {losses.tolist()}')
        unmoved = [k for k, p in params.items()
                   if torch.equal(p, before[k])]
        still = list(STILL.get(config, ()))
        if unmoved != still:
            raise AssertionError(f'{len(unmoved)} parameters did not move, '
                                 f'e.g. {unmoved[:3]}; want {still}')
        del before
        rows.append(dict(tf32=label, cudnn_allow_tf32=cudnn,
                         matmul_allow_tf32=matmul, step_ms=ms,
                         img_per_s=batch * 1e3 / ms,
                         peak_mem_gb=peak / 1e9, losses=losses.tolist()))
        if profile and len(rows) == 1:
            emit('profile', run=f'{phase} step', config=config, batch=batch,
                 tf32=label,
                 **profile_run(torch, lambda: step(img, gt, drop), ms))
    set_tf32(torch, False, False)
    opt_cfg, lr_config, max_iters = optim or (OPTIMIZER, LR_CONFIG,
                                              MAX_ITERS)
    aux = sorted(k for k in log_vars if k.startswith('aux'))
    emit(phase, ok=True, config=config, batch=batch, remat=remat,
         size=512, compute_dtype='bfloat16', optimizer=opt_cfg,
         lr_config=lr_config, max_iters=max_iters,
         dropout_ratio=dropout_ratio, log_vars=sorted(log_vars),
         aux_log_vars=aux,
         aux_losses=sum(1 for k in aux if 'loss' in k),
         timer='one CUDA event pair over 10 steps after 2 warm-up steps',
         launches_per_step=want, rows=rows)
    return launches


def maxvit_cfg(Config, with_cp=False, one_block=False):
    """``my_config/MaxViT-UNet.py`` with ``with_cp`` in the encoder and the
    decoder; ``one_block``: as its train checks build it, a block a stage
    and every dropout rate at 0."""
    cfg = Config.fromfile(os.path.join(REPO, MAXVIT_CONFIG))
    for part in (cfg.model.backbone, cfg.model.decode_head):
        part.with_cp = with_cp
        if one_block:
            part.update(attn_drop=0.0, drop=0.0, drop_path=0.0)
    if one_block:
        cfg.model.backbone.depths = (1, 1, 1, 1)
        cfg.model.decode_head.update(depths=(1, 1, 1), dropout_ratio=0.0)
    return cfg


def phase_remat_train(torch, kern, model, config, expected, modes,
                      make_model, tf32, dropout_ratio):
    """``remat_train``: bench.py's train step (``phase_train``: B=8 at
    512², bf16, the config's dropout, one CUDA event pair over 10 steps
    after 2 warm-up steps) on ``model``'s weights, plain and in each
    rematerialised mode: ``'loss'`` rematerialises the whole loss
    (``make_train_step(remat=True)``), any other mode is the model
    ``make_model(mode)`` (its ``with_cp``). One line each, with img/s and
    the peak memory; the plain step must launch the kernels ``expected``
    times, a rematerialised one the forward kernels twice. ``model``'s
    weights and buffers are put back as they came, so the phases after
    this one see the model the earlier ones trained. Returns the
    launches."""
    launches = dict.fromkeys(KERNELS, 0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for mode in (None,) + tuple(modes):
        m = model if mode in (None, 'loss') else make_model(mode)
        label = config if mode is None else (
            f'{config} remat=True' if mode == 'loss'
            else f'{config} with_cp={mode!r}')
        ran = phase_train(torch, kern, m, [tf32], label,
                          expected if mode is None
                          else remat_launches(per_call(expected)),
                          dropout_ratio, phase='remat_train',
                          remat=mode == 'loss', profile=False)
        for name in KERNELS:
            launches[name] += ran[name]
        if m is not model:
            del m
        model.load_state_dict(state)
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    return launches


def with_cp_model(init_segmentor, make_cfg, model):
    """``make_model`` of ``phase_remat_train``: the model of
    ``make_cfg(mode)`` with ``model``'s weights."""
    def make(mode):
        m = init_segmentor(make_cfg(mode))
        m.load_state_dict(model.state_dict(), strict=True)
        return m
    return make


def monolithic_ready(model):
    """``model`` as the monolithic train checks hold it: every dropout and
    drop-path rate at 0 (ViT's and SwinUNet's are hard-coded, as in the
    JAX package), and the query and key rows of every ViT ``qkv_layer``
    scaled by head_dim^-1/2, so that TransUNet's scores, which it
    multiplies by sqrt(head_dim) (the JAX module's quirk), come out as
    q·k/sqrt(head_dim). Without that scale the seeded TransUNet's softmax
    saturates, and a one-ulp nudge moves its first gradient by up to 43 %
    of its norm (PERF.md §6), too much to hold the card to the CPU by."""
    import torch
    from stc_unet_tpu_torch.models.bricks import Dropout, Dropout2d
    from stc_unet_tpu_torch.models.decode_heads.vit import MultiHeadAttention
    from stc_unet_tpu_torch.models.utils.swin_core import DropPath
    for m in model.modules():
        if isinstance(m, (Dropout, Dropout2d)):
            m.p = 0.0
        elif isinstance(m, DropPath):
            m.rate = 0.0
        elif isinstance(m, MultiHeadAttention):
            w = m.qkv_layer.weight        # rows (head_dim, 3, heads)
            c = w.shape[1]
            hd = c // m.head_num
            with torch.no_grad():
                w.view(hd, 3, m.head_num, c)[:, :2].mul_(hd ** -0.5)
    return model


def config_file(Config, config):
    """The config file ``config`` of the repo."""
    return Config.fromfile(os.path.join(REPO, config))


def monolithic_check_cfg(Config, config, load=config_file):
    """``config`` (loaded by ``load``) as ``monolithic_train_check`` builds
    it: the head's dropout at 0, SwinUNet at ``img_size`` 64."""
    cfg = load(Config, config)
    cfg.model.decode_head.dropout_ratio = 0.0
    if 'SwinUnet' in config:
        cfg.model.decode_head.img_size = 64
    return cfg


def grad_readings(torch, init_segmentor, Config, seeds):
    """``python3 chip_smoke.py --grad-readings N``: for each config of
    ``MONOLITHIC``, built as ``monolithic_train_check`` builds it, and for
    the weights (``init_weights(seed)``) and image of each seed below N,
    the first step's gradient on the card (cuDNN on, TF32 off) against the
    CPU's, beside what the eight one-ulp nudges move the CPU's: as a
    whole, and the worst tensors by their error and by their error over
    their own nudges. ``GRAD_FLOORS`` come from these readings."""
    for config in MONOLITHIC:
        cfg = monolithic_check_cfg(Config, config)
        for seed in range(seeds):
            card, cpu, state, img, gt = check_pair(
                torch, cfg, init_segmentor, 64, monolithic_ready, seed)
            ref = first_grads(torch, cpu, img, gt)
            norms = ref_norms(ref)
            rel, whole = grad_errors(
                first_grads(torch, card, img.cuda(), gt.cuda()), ref, norms)
            nudged = [grad_errors(nudged_grads(torch, cpu, state, gt, n,
                                               monolithic_ready), ref, norms)
                      for n in nudges(torch, cpu, state, img)]
            yard = {k: max(GRAD_FLOOR, *(r[k] for r, _ in nudged))
                    for k in rel}
            emit('grad_readings', config=config, seed=seed, size=64,
                 batch=2, dtype='float32', tf32=False, cudnn=True,
                 grad_whole=whole,
                 one_ulp_whole_max=max(w for _, w in nudged),
                 grad_tensor_max=max(rel.values()), grad_worst=_worst(rel),
                 grad_over_own_one_ulp_worst=_worst(
                     {k: e / yard[k] for k, e in rel.items()}))
            del card, cpu
            torch.cuda.empty_cache()


def phase_monolithic(torch, kern, init_segmentor, Config, tf32, smi,
                     configs=MONOLITHIC, prefix='monolithic',
                     load=config_file, forward=None, bn_calls=None,
                     stats_yard=RESNET, optims=None):
    """U-Net and the paper's monolithic baselines (``MONOLITHIC``), the
    ResNet-50 baselines (``RESNET``, with ``prefix`` ``'resnet'``), the
    fork's live heads (``FORK``, ``prefix`` ``'fork'``, ``load``
    ``fork_cfg``) or the stock zoo (``ZOO``, ``'zoo'``, ``zoo_cfg``),
    each at full width from seed 0. ``forward`` gives a
    config's kernel launches a forward, which a train step repeats (none
    if not given: only CARUnet's CoordAtt gates launch K1); each request,
    timed call and step is checked against them. ``bn_calls`` gives a
    config's BN call counts (``phase_train_check``); the configs in
    ``stats_yard`` hold their BN stats with the one-ulp yardstick too
    (its ``stats_yard``); ``optims`` gives a config's ``(optimizer,
    lr_config, max_iters)`` for its timed step (bench.py's Adam if
    not):

    - ``monolithic_slice``: whole requests of B=2 at 512² in bf16 through
      the entry point, the ``forward`` launches, the card's f32 logits (TF32
      off) held to the port on the CPU by ``compare_logits`` at 256²
      (SwinUNet at 512², its ``img_size``). A seeded TransUNet's class
      margin spreads over 0.6 % of its largest logit, so 1e-3 of that
      spread is 6e-6 of the logit, tighter than the logits themselves are
      held (1e-5), and the f32 sums of its 8 transformer blocks reach
      1.1e-3 of the spread: the margin is held to 1e-3 of its spread or
      1e-5 of the largest logit, whichever is more;
    - ``monolithic_train_check``: ``phase_train_check`` at 64² on
      ``monolithic_check_cfg`` and ``monolithic_ready`` models (copies of
      the served model, which differs from them only in dropout rates;
      SwinUNet's, at ``img_size`` 64, built anew), cuDNN on as in
      training, each gradient tensor held to at least the config's
      ``GRAD_FLOORS`` where it has one. The card's second step starts
      from the CPU's state after the first (``step2_from_cpu``);
    - ``monolithic_timing``: at the TF32 setting ``tf32``, whole B=8 and
      the bs-1 p50 (``whole_and_p50``) with the peak memory, and the bf16
      train step (``phase_train``, the config's dropout) at B=8, or, when
      that runs out of memory, at the largest of 4, 2, 1 that fits, with
      the error recorded;
    - for a config with ``with_cp`` tiers (``REMAT_MODES``: DC-UNet), the
      train check in each tier (``remat_train_check``) and the timed step
      plain and in each tier (``remat_train``).

    Returns the launches."""
    launches = dict.fromkeys(KERNELS, 0)
    label, cudnn, matmul = tf32
    for config, focus in configs.items():
        swin = 'SwinUnet' in config
        expected = (forward or {}).get(config, {})
        model = init_segmentor(load(Config, config))

        def cpu_model():
            return copy.deepcopy(model).cpu().eval()

        served = phase_slice(torch, kern, model, cpu_model, config,
                             ('whole',), expected, phase=f'{prefix}_slice',
                             check_size=512 if swin else 256,
                             margin_floor=1e-5)
        modes = REMAT_MODES.get(config, ())

        def with_cp_cfg(mode, check=True):
            cfg = monolithic_check_cfg(Config, config, load) if check \
                else load(Config, config)
            cfg.model.decode_head.with_cp = mode
            return cfg

        phase_train_check(torch, monolithic_check_cfg(Config, config, load),
                          init_segmentor, 64, phase=f'{prefix}_train_check',
                          focus=focus, prepare=monolithic_ready,
                          step2_from_cpu=True,
                          grad_floor=GRAD_FLOORS.get(config, GRAD_FLOOR),
                          remat=(kern, config, with_cp_cfg, modes)
                          if modes else None,
                          stats_yard=config in stats_yard,
                          bn_calls=(bn_calls or {}).get(config),
                          source=None if swin else model)
        set_tf32(torch, cudnn, matmul)
        g = torch.Generator(device='cuda').manual_seed(3)
        img = torch.rand((8, 512, 512, 3), generator=g,
                         device='cuda').to(torch.bfloat16)
        reset_counts(kern)
        torch.cuda.reset_peak_memory_stats()
        whole_ms, p50 = whole_and_p50(torch, model, img)
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts(kern)
        emit('profile', run=f'{prefix} whole', config=config, batch=8,
             tf32=label, **profile_run(torch, lambda: model.whole_inference(
                 img, None, False), whole_ms))
        del img
        set_tf32(torch, False, False)
        oom = []
        trained = None
        for batch in (TRAIN_BATCH, 4, 2, 1):
            try:
                trained = phase_train(torch, kern, model, [tf32], config,
                                      expected, 'the config\'s',
                                      f'{prefix}_train', batch=batch,
                                      optim=(optims or {}).get(config))
                break
            except torch.cuda.OutOfMemoryError as e:
                oom.append(dict(batch=batch,
                                error=str(e).splitlines()[0][:300]))
                model.zero_grad(set_to_none=True)
                torch.cuda.empty_cache()
        if trained is None:
            raise AssertionError(f'{config}: no train batch fits: {oom}')
        # whole_and_p50's forwards: 2 + 5 at B=8, 2 + 20 at bs 1
        want = {k: 29 * n for k, n in per_call(expected).items()}
        if counts != want:
            raise AssertionError(f'{config}: launched {counts}, want {want}')
        if modes:
            ran = phase_remat_train(
                torch, kern, model, config, {}, modes,
                with_cp_model(init_segmentor,
                              lambda mode: with_cp_cfg(mode, False), model),
                tf32, "the config's")
            for name in KERNELS:
                launches[name] += ran[name]
        emit(f'{prefix}_timing', config=config, image='bf16 512x512',
             tf32=label, cudnn_allow_tf32=cudnn, matmul_allow_tf32=matmul,
             nvidia_smi=smi, whole_ms_b8=whole_ms,
             whole_slices_per_s=8e3 / whole_ms, p50_ms_bs1=p50,
             whole_peak_mem_gb=peak / 1e9, train_out_of_memory=oom,
             timer='CUDA events, median of 5 after 2 warmup; p50 on the '
                   'host clock with synchronize, 20 calls; the train step '
                   'in its own line (monolithic_train)')
        for name in KERNELS:
            launches[name] += served[name] + trained[name] + counts[name]
        del model
        torch.cuda.empty_cache()
    return launches


def phase_pspnet_trained(torch, kern, tf32):
    """The stock PSPNet's trained protocol on the card
    (``stc_unet_tpu_torch.tools.parity_pspnet``, ``PSPNET_TRAINED``: the
    JAX tool's fixture, config surgery and 12 epochs at 256², B=8, bf16,
    through the train and test CLIs) at the TF32 setting ``tf32``; its
    checkpoint must reach mDice ``min_mdice`` through the test CLI, and
    the steps' log vars must hold the auxiliary head's loss. Prints the
    port's mDice and mIoU beside the JAX package's
    (``PARITY_PSPNET.json``); the model launches no kernel of the
    port."""
    from stc_unet_tpu_torch.tools import parity_pspnet
    label, cudnn, matmul = tf32
    set_tf32(torch, cudnn, matmul)
    work = os.path.join(REPO, 'work_dirs')
    os.makedirs(work, exist_ok=True)
    reset_counts(kern)
    with tempfile.TemporaryDirectory(dir=work) as root:
        t = PSPNET_TRAINED
        record = parity_pspnet.main([
            '--work-dir', root, '--device', 'cuda', '--size', str(t['size']),
            '--epochs', str(t['epochs']), '--batch', str(t['batch'])])
    counts = read_counts(kern)
    set_tf32(torch, False, False)
    record.pop('checkpoint')
    losses = record.pop('losses')
    faults = []
    if record['port']['mDice'] < t['min_mdice']:
        faults.append(f'mDice {record["port"]["mDice"]} < '
                      f'{t["min_mdice"]}')
    if 'aux.loss_ce' not in losses:
        faults.append(f'no auxiliary loss among {sorted(losses)}')
    if any(counts.values()):
        faults.append(f'launched {counts}')
    emit('pspnet_trained', ok=not faults, faults=faults, tf32=label,
         min_mdice=t['min_mdice'], launches=counts,
         first_losses={k: v[0] for k, v in losses.items()},
         last_losses={k: v[-1] for k, v in losses.items()}, **record)
    if faults:
        raise AssertionError(f'pspnet_trained: {faults}')


def _kernel_group(name):
    low = name.lower()
    for group, keys in (
            ('coordatt K1/K2/K2b', ('strip_band', 'gate_add')),
            ('window attention K3f/K3b', ('wa_fwd', 'wa_bwd', 'wa_dbias')),
            ('flash attention Lf/Ldkv/Ldq', ('flash_fwd', 'flash_bwd')),
            ('dual pools P', ('dual_pools',)),
            ('optimizer', ('adam', 'multi_tensor')),
            ('conv (FFT)', ('fft', 'cf32')),
            ('conv', ('fprop', 'conv', 'implicit', 'nchwtonhwc',
                      'nhwctonchw', 'wgrad', 'dgrad')),
            ('matmul', ('gemm', 'bmm', 'gemv')),
            ('layer norm', ('layer_norm',)),
            ('random (dropout masks)', ('distribution', 'philox')),
            ('softmax', ('softmax',)),
            ('upsample', ('upsample',)),
            ('pool', ('pool',)),
            ('reduce', ('reduce',)),
            ('elementwise', ('elementwise', 'copy', 'fill', 'cat'))):
        if any(k in low for k in keys):
            return group
    return 'other'


def profile_run(torch, fn, run_ms):
    """Device time by kernel over one call of fn; the idle share is
    1 - (kernel time / the event-timed call, run_ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, groups = [], {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or \
                e.key == 'Command Buffer Full':
            continue
        ms = getattr(e, 'device_time_total',
                     getattr(e, 'cuda_time_total', 0)) / 1e3
        rows.append(dict(name=e.key[:100], ms=ms, calls=e.count))
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + ms
    rows.sort(key=lambda r: -r['ms'])
    busy = sum(r['ms'] for r in rows)
    return dict(run_ms=run_ms, kernel_ms=busy,
                idle_share=max(0.0, 1 - busy / run_ms),
                groups=dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                top=rows[:15])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--grad-readings', type=int, metavar='N',
                        help='print grad_readings over N seeds and exit')
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script needs an '
              'NVIDIA card', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, 'stc_unet_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repo (no '
              'stc_unet_tpu_torch beside it)', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from stc_unet_tpu_torch.apis import init_segmentor
    from stc_unet_tpu_torch.ops import _build
    from stc_unet_tpu_torch.ops import coordatt_fused as cf
    from stc_unet_tpu_torch.ops import window_attention as wa
    from stc_unet_tpu_torch.utils import Config
    # the package exports the function flash_attention under the module's
    # name, so the module is taken by its full name
    fa = importlib.import_module('stc_unet_tpu_torch.ops.flash_attention')

    # 1. env; torch's TF32 defaults are what init_segmentor's caller gets
    default_tf32 = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
    set_tf32(torch, False, False)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit('env', torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=kind,
         count=torch.cuda.device_count(), nvidia_smi=smi,
         default_cudnn_allow_tf32=default_tf32[0],
         default_matmul_allow_tf32=default_tf32[1],
         cudnn_allow_tf32=False, matmul_allow_tf32=False,
         cpu_threads=torch.get_num_threads(),
         cpus_usable=len(os.sched_getaffinity(0)), cpus=os.cpu_count())
    if args.grad_readings:
        grad_readings(torch, init_segmentor, Config, args.grad_readings)
        return 0

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit('build', seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v['path'], REPO)
                    for k, v in libs.items()},
         built={k: v['built'] for k, v in libs.items()},
         ptxas=[ln.strip() for v in libs.values()
                for ln in v['log'].splitlines()
                if 'registers' in ln or 'spill' in ln][:120])

    # 3. kernels against their plain versions
    err = phase_kernels(torch, cf, str(libs['coordatt_fused']['path']))
    err.update(phase_window_attention_kernels(torch, wa,
                                              libs['window_attention']))
    err.update(phase_flash_attention_kernels(
        torch, fa, str(libs['flash_attention']['path'])))
    phase_launch_limits(torch, cf, wa, fa)
    kern = kernel_functions()

    p_kernels = p_one_kernel(torch)

    # 4. the STC-UNet path
    cfg_path = os.path.join(REPO, STC_CONFIG)

    def stc_cfg(flash=False):
        cfg = Config.fromfile(cfg_path)
        cfg.model.backbone.flash_attention = flash
        return cfg

    model = init_segmentor(stc_cfg())

    def cpu_model(card):
        return lambda: copy.deepcopy(card).cpu().eval()

    launches = phase_slice(torch, kern, model, cpu_model(model),
                           STC_CONFIG, ('slide', 'whole'), STC_FORWARD)
    phase_tf32_check(torch, model, cpu_model(model),
                     ('torch default',) + default_tf32)
    evaluated = phase_test_path(torch, kern, model,
                                cpu_model(model),
                                ('torch default',) + default_tf32)
    for name in KERNELS:
        launches[name] += evaluated[name]
    # the training path, then the test CLI on its split and checkpoint
    work = os.path.join(REPO, 'work_dirs')
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as root:
        for phase in (phase_train_path, phase_test_cli):
            ran = phase(torch, kern, ('torch default',) + default_tf32, root)
            for name in KERNELS:
                launches[name] += ran[name]
        # data parallelism: ranks sharing the card, and the launcher on
        # the train path's split
        ran = phase_data_parallel(torch, root)
        for name in KERNELS:
            launches[name] += ran[name]
    phase_device_pipeline(torch)
    for phase in (phase_trained_path, phase_profile_input):
        ran = phase(torch, kern, ('torch default',) + default_tf32)
        for name in KERNELS:
            launches[name] += ran[name]

    # 5. timing
    stc_rows = phase_timing(torch, model, [('off', False, False),
                                           ('torch default',) + default_tf32,
                                           ('on', True, True)])
    per = phase_kernel_timing(torch, cf, err)

    # 6. and 7. the train step
    cfg = stc_cfg()
    cfg.model.decode_head.dropout_ratio = 0.0
    phase_train_check(torch, cfg, init_segmentor, 64,
                      remat=(kern, STC_CONFIG, None, ('loss',)))
    trained = phase_train(torch, kern, model,
                          [('torch default',) + default_tf32,
                           ('off', False, False), ('on', True, True)],
                          STC_CONFIG, STC_STEP, 0.1)
    for name in KERNELS:
        launches[name] += trained[name]
    trained = phase_remat_train(torch, kern, model, STC_CONFIG, STC_STEP,
                                ('loss',), None,
                                ('torch default',) + default_tf32, 0.1)
    for name in KERNELS:
        launches[name] += trained[name]

    # 9. the STC-UNet flash path, with the einsum model's weights
    model.eval()
    flash = init_segmentor(stc_cfg(True))
    flash.load_state_dict(model.state_dict(), strict=True)
    flash_config = f'{STC_CONFIG} with backbone.flash_attention=True'
    served = phase_slice(torch, kern, flash,
                         cpu_model(flash),
                         flash_config, ('slide', 'whole'), FLASH_FORWARD,
                         phase='flash_slice', card_model=model)
    del model
    torch.cuda.empty_cache()
    phase_timing(torch, flash, [('torch default',) + default_tf32],
                 phase='flash_timing', run='flash slide', profile_whole=True,
                 beside=[r for r in stc_rows if r['tf32'] == 'torch default'])
    per.update(phase_flash_attention_timing(torch, fa, err))
    cfg = stc_cfg(True)
    cfg.model.decode_head.dropout_ratio = 0.0
    phase_train_check(torch, cfg, init_segmentor, 64,
                      phase='flash_train_check', focus=('attention', '.ma.'))
    trained = phase_train(torch, kern, flash,
                          [('torch default',) + default_tf32], flash_config,
                          FLASH_STEP, 0.1, phase='flash_train')
    for name in KERNELS:
        launches[name] += served[name] + trained[name]
    del flash
    torch.cuda.empty_cache()

    # 8. the MaxViT-UNet path: whole inference, timing, the train step
    mv_path = os.path.join(REPO, MAXVIT_CONFIG)
    model = init_segmentor(Config.fromfile(mv_path))
    served = phase_slice(torch, kern, model,
                         cpu_model(model),
                         MAXVIT_CONFIG, ('whole',), MAXVIT_FORWARD,
                         phase='maxvit_slice')
    phase_maxvit_timing(torch, model, ('torch default',) + default_tf32)
    per.update(phase_window_attention_timing(torch, wa, err))
    # two steps card vs CPU at 256², the least size the /32 stage's 8x8
    # windows take, with one block per stage to keep the CPU side short
    phase_train_check(torch, maxvit_cfg(Config, one_block=True),
                      init_segmentor, 256, phase='maxvit_train_check',
                      focus=('attention', '.attention.'),
                      remat=(kern, f'{MAXVIT_CONFIG} (a block a stage)',
                             lambda mode: maxvit_cfg(Config, mode, True),
                             MAXVIT_REMAT))
    trained = phase_train(torch, kern, model,
                          [('torch default',) + default_tf32], MAXVIT_CONFIG,
                          MAXVIT_STEP, 0.1, phase='maxvit_train')
    for name in KERNELS:
        launches[name] += served[name] + trained[name]
    trained = phase_remat_train(
        torch, kern, model, MAXVIT_CONFIG, MAXVIT_STEP, MAXVIT_REMAT,
        with_cp_model(init_segmentor,
                      lambda mode: maxvit_cfg(Config, mode), model),
        ('torch default',) + default_tf32, 0.1)
    for name in KERNELS:
        launches[name] += trained[name]
    del model
    torch.cuda.empty_cache()

    # 14. U-Net and the monolithic baselines: no kernel, every earlier
    # kernel still held above
    ran = phase_monolithic(torch, kern, init_segmentor, Config,
                           ('torch default',) + default_tf32, smi)
    for name in KERNELS:
        launches[name] += ran[name]
    # 15. PSPNet and DeepLabv3+ (ResNet-50, output stride 8): no kernel
    ran = phase_monolithic(torch, kern, init_segmentor, Config,
                           ('torch default',) + default_tf32, smi, RESNET,
                           'resnet')
    for name in KERNELS:
        launches[name] += ran[name]
    # 17. the fork's live heads: K1 in CARUnet's CoordAtt gates
    ran = phase_monolithic(
        torch, kern, init_segmentor, Config,
        ('torch default',) + default_tf32, smi,
        {name: focus for name, (focus, _, _) in FORK.items()}, 'fork',
        fork_cfg, {name: k for name, (_, _, k) in FORK.items()}, BN_CALLS)
    for name in KERNELS:
        launches[name] += ran[name]
    phase_fork_kernel_timing(torch, cf, err)
    # 18. to 20. the stock zoo: Swin-T UPerNet and PSPNet-R50-D8 with
    # their auxiliary FCNHeads, the semantic FPN, FastFCN and the ViT
    # UPerNet with their necks, SETR-PUP, SETR-MLA, the Segmenter and DPT,
    # no kernel; then the stock PSPNet's trained protocol
    ran = phase_monolithic(
        torch, kern, zoo_init(init_segmentor), Config,
        ('torch default',) + default_tf32, smi,
        {config: focus for config, (focus, _) in ZOO.items()}, 'zoo',
        zoo_run_cfg, stats_yard=ZOO,
        optims={config: zoo_optim(Config, config) for config in ZOO})
    for name in KERNELS:
        launches[name] += ran[name]
    phase_pspnet_trained(torch, kern, ('torch default',) + default_tf32)

    # 10. the CoordAtt probe: kernel P
    per['dual_pools'], launches['dual_pools'], err['dual_pools'] = \
        phase_coordatt_probe(torch, kern, p_kernels)

    # the kernels of every path: the times of one forward's (K1, K2, K3f,
    # Lf) or one step's (K2b, K3b, Ldkv, Ldq) launches at the timed shapes;
    # P's over the probe's four stages. The L kernels' bound is that of
    # the type they compute in, 3xTF32 on the tensor cores.
    kernels = []
    for name in KERNELS:
        rows = per[name]
        calls = [r.get('calls', 1) for r in rows]
        b = 'bound_tc' if name in TC_KERNELS else 'bound'
        kernels.append(dict(
            name=name, route='cuda', source=SOURCES[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err[name],
            **{key: sum(n * r[key] for n, r in zip(calls, rows))
               for key in ('ms', 'device_ms', 'plain_ms', 'library_ms',
                           'library_device_ms')},
            bound_ms=sum(n * r[f'{b}_ms'] for n, r in zip(calls, rows)),
            bound_by='bytes' if all(r[f'{b}_by'] == 'bytes' for r in rows)
            else 'operations'))
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stc_unet_tpu_torch``) on one card.

Drives the port's four paths at full width, with random weights from seed
0: STC-UNet (``my_config/STC-UNet.py``) and MaxViT-UNet
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
   argmax >= 0.999);
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
    (``coordatt_probe``).

    python3 chip_smoke.py

Each phase prints one JSON line; then come the card's name and power limit
(as nvidia-smi gives them), the kernels' JSON line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the exit code is not 0 and no result line is printed.
Without CUDA, or outside a checkout of the repo, it exits 1 at once.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
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
# launches per forward (and per train step, which adds the backward)
STC_FORWARD = dict(strip_pools=4, gate_add=4)
STC_STEP = dict(strip_pools=4, gate_add=4, gate_dots=4)
MAXVIT_FORWARD = dict(window_attention=28)
MAXVIT_STEP = dict(window_attention=28, window_attention_backward=28)
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


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


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


def check_kernels(torch, cf, x, a_h, a_w):
    """K1 and K2 on x against their plain versions; max abs errors."""
    sh, sw = cf.strip_pools(x)
    sh2, sw2 = cf.strip_pools(x)
    eh, ew = cf.strip_pools_reference(x)
    torch.testing.assert_close(sh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sw, ew, rtol=1e-5, atol=1e-4)
    if not (torch.equal(sh, sh2) and torch.equal(sw, sw2)):
        raise AssertionError(f'strip_pools not deterministic {x.shape}')
    e1 = max((sh - eh).abs().max().item(), (sw - ew).abs().max().item())
    del sh, sw, sh2, sw2, eh, ew
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
    """got against want, (1, H, W, 2) f32 logits: the largest error over
    the largest |logit|, the class margin's largest error over its spread
    (std), the argmax agreement and the class-1 share."""
    margin = want[..., 1] - want[..., 0]
    margin_err = ((got[..., 1] - got[..., 0]) - margin).abs().max().item()
    err, top = (got - want).abs().max().item(), want.abs().max().item()
    return dict(
        max_abs_err=err, logits_abs_max=top, logit_err_over_max=err / top,
        margin_std=margin.std().item(), margin_max_abs_err=margin_err,
        margin_err_over_spread=margin_err / margin.std().item(),
        argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean()
        .item(),
        class1_share=(margin > 0).float().mean().item())


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
                phase='slice', card_model=None):
    """Serve requests in each of ``modes`` (B=2 at 512², bf16 images);
    check each forward's launches against ``expected``; hold the card's
    logits against the port on the CPU (f32, TF32 off) and, when
    ``card_model`` is given, against that model's on the card. Returns
    the launches."""
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
        if len(preds) != 2 or any(p.shape != (512, 512) or
                                  not set(p.ravel().tolist()) <= {0, 1}
                                  for p in preds):
            raise AssertionError(f'{mode}: bad predictions')
        probs = model.inference(imgs, metas(2, 512), True)
        if probs.shape != (2, 512, 512, 2) or \
                not bool(torch.isfinite(probs).all()):
            raise AssertionError(f'{mode}: bad probabilities')
        served[mode] = dict(batch=2, launches=counts,
                            first_call_s=seconds,
                            foreground_share=float(
                                sum(p.mean() for p in preds) / len(preds)))
    # the card against the CPU, f32, TF32 off
    x = torch.rand((1, 256, 256, 3),
                   generator=torch.Generator().manual_seed(2))
    on_card = model.encode_decode(x.cuda()).float().cpu()
    checks = dict(cpu_check=compare_logits(
        torch, on_card, cpu_model_fn().encode_decode(x)))
    if card_model is not None:
        # and against another model on the card, from the same weights
        checks['card_check'] = compare_logits(
            torch, on_card, card_model.encode_decode(x.cuda()).float().cpu())
    emit(phase, ok=True, config=config, served=served, **checks)
    return launches


def compare_logits(torch, got, want):
    """got against want, (1, 256, 256, 2) f32 logits of one image in whole
    mode: rtol/atol 1e-5, the class margin within 1e-3 of its spread, the
    argmax agreeing on 0.999 of the pixels. Raises, or returns the
    measures (``logit_measures``)."""
    m = logit_measures(got, want)
    # The seeded models' logits are small (STC-UNet: |max| ~0.2) and their
    # class margins spread ~1e-2, so the limits are set against those, not
    # against 1.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if m['margin_max_abs_err'] > 1e-3 * m['margin_std']:
        raise AssertionError(f'class margin off by {m["margin_max_abs_err"]}'
                             f', over 1e-3 of its spread {m["margin_std"]}')
    if m['argmax_agreement'] < 0.999:
        raise AssertionError(f'argmax agreement {m["argmax_agreement"]} < '
                             f'0.999')
    return dict(size=256, mode='whole', dtype='float32', **m,
                tolerance='logits rtol 1e-5 atol 1e-5; class margin within '
                          '1e-3 of its std; argmax >= 0.999')


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


def train_step_for(torch, model, compute_dtype=None):
    """The port's train step on model: bench.py's Adam and poly lr."""
    from stc_unet_tpu_torch.core import build_lr_schedule, build_optimizer
    from stc_unet_tpu_torch.engine import make_train_step
    schedule = build_lr_schedule(LR_CONFIG, OPTIMIZER['lr'], MAX_ITERS)
    return make_train_step(model, build_optimizer(model, OPTIMIZER),
                           schedule, compute_dtype=compute_dtype)


def grad_errors(grads, ref):
    """Per tensor, |g - ref| / |ref| in 2-norms, over the tensors whose
    norm is at least 1e-4 of the largest; and the same over all tensors
    as one vector."""
    norms = {k: r.norm().item() for k, r in ref.items()}
    big = max(norms.values())
    diff = {k: (grads[k] - r).norm().item() for k, r in ref.items()}
    whole = math.sqrt(sum(d * d for d in diff.values()) /
                      sum(n * n for n in norms.values()))
    return {k: diff[k] / norms[k] for k in ref
            if norms[k] >= 1e-4 * big}, whole


def nudged_grads(torch, cfg, state, img, gt, seed):
    """The first step's gradients of the port on the CPU after moving the
    image and every parameter by one part in 2^23 (one f32 ulp or less),
    up or down at random: how far f32 rounding alone moves the gradient
    here. Taken on the CPU, so that nothing the card does widens it."""
    from stc_unet_tpu_torch.apis import init_segmentor
    from stc_unet_tpu_torch.engine import total_loss_from_dict
    g = torch.Generator().manual_seed(seed)

    def nudge(t):
        up = torch.rand(t.shape, generator=g) < 0.5
        return t * torch.where(up, 1 + 2.0 ** -23, 1 - 2.0 ** -23)

    model = init_segmentor(cfg, device='cpu')
    params = dict(model.named_parameters())
    model.load_state_dict({k: nudge(v) if k in params else v
                           for k, v in state.items()})
    model.train()
    total, _ = total_loss_from_dict(model.compute_losses(nudge(img), gt))
    total.backward()
    return {k: p.grad.float() for k, p in model.named_parameters()}


def _worst(rel, k=6):
    return dict(sorted(rel.items(), key=lambda kv: -kv[1])[:k])


def phase_train_check(torch, cfg, init_segmentor, size, phase='train_check',
                      focus=('coordatt', '.ca.')):
    """Two train steps at full width on the card and on the port on the
    CPU, from the same weights: ``size``² images, B=2, f32, TF32 off (set
    by main), with every dropout rate of ``cfg`` at 0 (set by the caller).
    Compares each step's losses, the first step's gradients and BN running
    stats, and the step count of every BN. ``focus`` (a name and a key
    fragment) picks the tensors of the kernels' layers for their own
    report.

    The gradient of the seeded full-width model at this input is touchy:
    moving the image and the weights by one f32 ulp moves it by about 1 %
    of its norm as a whole, and single deep tensors by a few percent. So
    the card's first-step gradient is held to the CPU's within 3 times
    what the largest of eight such one-ulp nudges does to the CPU's own
    gradient (the yardstick, measured in the same run): as a whole against
    the whole's yardstick, and each tensor against its own (at least
    GRAD_FLOOR). A nudge moves nearly every tensor together, by an amount
    that varies several-fold from one nudge to the next, so two nudges are
    too few to gauge it, and four were too few for the flash model (one
    of them moved its gradient by a third of what it moved the einsum
    model's). The kernels themselves are held tightly in phases
    ``kernels``, ``window_attention_kernels`` and
    ``flash_attention_kernels``, their autograd included."""
    card = init_segmentor(cfg)
    cpu = init_segmentor(cfg, device='cpu')
    cpu_state = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu.load_state_dict(cpu_state)
    g = torch.Generator().manual_seed(4)
    img = torch.rand((2, size, size, 3), generator=g)
    gt = (img.mean(-1) > 0.5).long()
    gt[:, :3] = 255                      # ignored pixels
    steps = {'card': train_step_for(torch, card),
             'cpu': train_step_for(torch, cpu)}
    models = {'card': card, 'cpu': cpu}
    logs, grads, stats = {'card': [], 'cpu': []}, {}, {}
    for i in range(2):
        for where in ('card', 'cpu'):
            dev = 'cuda' if where == 'card' else 'cpu'
            lv = steps[where](img.to(dev), gt.to(dev))
            logs[where].append({k: v.item() for k, v in lv.items()})
            if i == 0:
                grads[where] = {k: p.grad.float().cpu() for k, p in
                                models[where].named_parameters()}
                stats[where] = {k: v.cpu().clone() for k, v in
                                models[where].state_dict().items()
                                if k.endswith(('running_mean',
                                               'running_var'))}
    # the losses: f32 sums in another order (rtol 1e-5); the accuracy
    # counts pixels, and the seeded model's class margins are ~1e-3, so a
    # few pixels near the boundary may flip: at most 3
    faults = []
    pixel = 100.0 / int((gt != 255).sum())
    for a, b in zip(logs['card'], logs['cpu']):
        for k in b:
            limit = 1e-5 * abs(b[k]) + 1e-6 if 'loss' in k else 3 * pixel
            if not math.isfinite(a[k]) or abs(a[k] - b[k]) > limit:
                faults.append(f'{k}: card {a[k]} cpu {b[k]}')
    # the gradients, |g - g_ref| / |g_ref| in 2-norms, as one vector and
    # per tensor. Tensors whose gradient is 0 up to noise (the conv biases
    # before a train-mode BN) are left out of the per-tensor figures: those
    # under 1e-4 of the largest norm.
    rel, whole = grad_errors(grads['card'], grads['cpu'])
    nudged = [grad_errors(nudged_grads(torch, cfg, cpu_state, img, gt, s),
                          grads['cpu']) for s in NUDGE_SEEDS]
    yard_whole = max(w for _, w in nudged)
    yard = {k: max(GRAD_FLOOR, *(r[k] for r, _ in nudged)) for k in rel}
    if whole > 3 * yard_whole:
        faults.append(f'gradient off by {whole} of its norm, over 3 x '
                      f'{yard_whole}')
    faults += [f'gradient {k} off by {e} of its norm, over 3 x {yard[k]}'
               for k, e in rel.items() if e > 3 * yard[k]]
    ratio = {k: e / yard[k] for k, e in rel.items()}
    name, part = focus
    focused = {k: e for k, e in rel.items() if part in k}
    # the BN running stats after the first step, which come from the
    # forward of the same weights (rtol 1e-4, atol 1e-5); the second
    # step's follow Adam's first update, whose sign on coordinates with a
    # near-zero gradient is noise (tools/parity_train.py), so only its
    # count is checked
    stats_err = 0.0
    for k, ref in stats['cpu'].items():
        diff = (stats['card'][k] - ref).abs()
        stats_err = max(stats_err, diff.max().item())
        if bool((diff > 1e-5 + 1e-4 * ref.abs()).any()):
            faults.append(f'{k} off by {diff.max().item()}')
    for m in (card, cpu):
        for k, v in m.state_dict().items():
            if k.endswith('num_batches_tracked') and int(v) != 2:
                faults.append(f'{k}: {int(v)}, want 2')
    emit(phase, ok=not faults, faults=faults[:8], size=size, batch=2,
         dtype='float32', tf32=False, dropout_ratio=0.0, losses=logs,
         grad_tensors=len(grads['cpu']), grad_tensors_compared=len(rel),
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
         tolerance=f'losses rtol 1e-5; acc_seg within 3 pixels; gradient '
                   f'as a whole within 3x the largest of '
                   f'{len(NUDGE_SEEDS)} one-ulp wholes, each tensor within '
                   f'3x the largest of its own {len(NUDGE_SEEDS)} one-ulp '
                   f'changes (at least {GRAD_FLOOR}), nudges on the CPU; '
                   f'step-1 BN stats rtol 1e-4 atol 1e-5')
    if faults:
        raise AssertionError(f'{phase}: {faults[:3]}')
    del card, cpu, steps, models
    torch.cuda.empty_cache()


def phase_train(torch, kern, model, settings, config, expected,
                dropout_ratio, phase='train'):
    """bench.py's train step on the full-width model: B=8 at 512², bf16
    compute, Adam lr 1e-5 with the poly lr, the config's dropout from a
    seeded generator. Per TF32 setting ``(label, cudnn, matmul)``: 2
    warm-up steps, each checked to launch the kernels ``expected`` times,
    then 10 steps timed with one CUDA event pair; the loss must be finite
    and every parameter must move. The first setting's run is profiled by
    kernel group. Returns the launches of all steps."""
    g = torch.Generator(device='cuda').manual_seed(5)
    img = torch.rand((TRAIN_BATCH, 512, 512, 3), generator=g, device='cuda')
    gt = (img.mean(-1) > 0.5).long()
    drop = torch.Generator(device='cuda').manual_seed(6)
    params = dict(model.named_parameters())
    launches = dict.fromkeys(KERNELS, 0)
    want = per_call(expected)
    rows = []
    for label, cudnn, matmul in settings:
        set_tf32(torch, cudnn, matmul)
        step = train_step_for(torch, model, torch.bfloat16)
        before = {k: p.detach().clone() for k, p in params.items()}
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(2):
            reset_counts(kern)
            losses.append(step(img, gt, drop)['loss'])
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
        still = [k for k, p in params.items() if torch.equal(p, before[k])]
        if still:
            raise AssertionError(f'{len(still)} parameters did not move, '
                                 f'e.g. {still[:3]}')
        del before
        rows.append(dict(tf32=label, cudnn_allow_tf32=cudnn,
                         matmul_allow_tf32=matmul, step_ms=ms,
                         img_per_s=TRAIN_BATCH * 1e3 / ms,
                         peak_mem_gb=peak / 1e9, losses=losses.tolist()))
        if len(rows) == 1:
            emit('profile', run=f'{phase} step', batch=TRAIN_BATCH,
                 tf32=label,
                 **profile_run(torch, lambda: step(img, gt, drop), ms))
    set_tf32(torch, False, False)
    emit(phase, ok=True, config=config, batch=TRAIN_BATCH,
         size=512, compute_dtype='bfloat16', optimizer=OPTIMIZER,
         lr_config=LR_CONFIG, max_iters=MAX_ITERS,
         dropout_ratio=dropout_ratio,
         timer='one CUDA event pair over 10 steps after 2 warm-up steps',
         launches_per_step=want, rows=rows)
    return launches


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
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)

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
    from stc_unet_tpu_torch.ops import dual_pools as dp
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
         cudnn_allow_tf32=False, matmul_allow_tf32=False)

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
    modules = dict(**dict.fromkeys(CF_KERNELS, cf),
                   **dict.fromkeys(WA_KERNELS, wa),
                   **dict.fromkeys(FA_KERNELS, fa), dual_pools=dp)
    kern = {name: getattr(modules[name], name) for name in KERNELS}

    p_kernels = p_one_kernel(torch)

    # 4. the STC-UNet path
    cfg_path = os.path.join(REPO, STC_CONFIG)

    def stc_cfg(flash=False):
        cfg = Config.fromfile(cfg_path)
        cfg.model.backbone.flash_attention = flash
        return cfg

    model = init_segmentor(stc_cfg())

    def cpu_model(make_cfg, card):
        def build():
            m = init_segmentor(make_cfg(), device='cpu')
            m.load_state_dict({k: v.cpu() for k, v in
                               card.state_dict().items()})
            return m
        return build

    launches = phase_slice(torch, kern, model, cpu_model(stc_cfg, model),
                           STC_CONFIG, ('slide', 'whole'), STC_FORWARD)
    phase_tf32_check(torch, model, cpu_model(stc_cfg, model),
                     ('torch default',) + default_tf32)

    # 5. timing
    stc_rows = phase_timing(torch, model, [('off', False, False),
                                           ('torch default',) + default_tf32,
                                           ('on', True, True)])
    per = phase_kernel_timing(torch, cf, err)

    # 6. and 7. the train step
    cfg = stc_cfg()
    cfg.model.decode_head.dropout_ratio = 0.0
    phase_train_check(torch, cfg, init_segmentor, 64)
    trained = phase_train(torch, kern, model,
                          [('torch default',) + default_tf32,
                           ('off', False, False), ('on', True, True)],
                          STC_CONFIG, STC_STEP, 0.1)
    for name in KERNELS:
        launches[name] += trained[name]

    # 9. the STC-UNet flash path, with the einsum model's weights
    model.eval()
    flash = init_segmentor(stc_cfg(True))
    flash.load_state_dict(model.state_dict(), strict=True)
    flash_config = f'{STC_CONFIG} with backbone.flash_attention=True'
    served = phase_slice(torch, kern, flash,
                         cpu_model(lambda: stc_cfg(True), flash),
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
                         cpu_model(lambda: Config.fromfile(mv_path), model),
                         MAXVIT_CONFIG, ('whole',), MAXVIT_FORWARD,
                         phase='maxvit_slice')
    phase_maxvit_timing(torch, model, ('torch default',) + default_tf32)
    per.update(phase_window_attention_timing(torch, wa, err))
    # two steps card vs CPU at 256², the least size the /32 stage's 8x8
    # windows take, with one block per stage to keep the CPU side short
    cfg = Config.fromfile(mv_path)
    for part in (cfg.model.backbone, cfg.model.decode_head):
        part.update(attn_drop=0.0, drop=0.0, drop_path=0.0)
    cfg.model.backbone.depths = (1, 1, 1, 1)
    cfg.model.decode_head.update(depths=(1, 1, 1), dropout_ratio=0.0)
    phase_train_check(torch, cfg, init_segmentor, 256,
                      phase='maxvit_train_check',
                      focus=('attention', '.attention.'))
    trained = phase_train(torch, kern, model,
                          [('torch default',) + default_tf32], MAXVIT_CONFIG,
                          MAXVIT_STEP, 0.1, phase='maxvit_train')
    for name in KERNELS:
        launches[name] += served[name] + trained[name]
    del model
    torch.cuda.empty_cache()

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

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stc_unet_tpu_torch``) on one card.

Drives the port's two paths at full width (``my_config/STC-UNet.py``,
random weights from seed 0): STC-UNet inference through ``init_segmentor``
and ``model(return_loss=False, img=[...], img_metas=[...])`` in slide mode
(crop 256, stride 170: the 9 tiles of each 512² image run as one batch)
and in whole mode; and the train step through ``make_train_step`` (Adam,
poly lr, bf16 compute, B=8 at 512², as ``bench.py`` trains). On the way it

1. records the environment (torch, CUDA, the card's name and power limit,
   torch's TF32 defaults, which the entry point runs with) and turns TF32
   off for every comparison;
2. builds the CUDA kernels from ``stc_unet_tpu_torch/csrc``;
3. holds each kernel (K1 ``strip_pools``, K2 ``gate_add``, K2b
   ``gate_dots``) against its plain PyTorch version on the card, at the
   Up-stage shapes of the slide tiles and of whole 512² images, and at odd
   shapes, in f32 and bf16, with bit-identical reruns for K1 and K2b;
4. serves slide and whole requests (B=2 at 512², bf16 images, as the
   benchmark feeds them) and checks that each forward launched each kernel
   4 times; holds the card's logits on a 256² image against the port on
   the CPU (f32, TF32 off);
5. times slide (B=14, 126 tiles), whole (B=8) and the bs-1 whole latency
   with CUDA events, with TF32 off, at torch's defaults and on, and breaks
   one slide forward of each down by kernel with torch.profiler; times each
   kernel at the Up-stage shapes of the B=14 slide batch (K2b: of the B=8
   train batch, bf16) beside its plain version, a one-call PyTorch
   yardstick and its bound (bytes over 3.35 TB/s), and checks it against
   its plain version there too, K1 and K2 also at the B=8 train shapes;
6. takes two train steps at full width on the card and on the port on the
   CPU from the same weights (64², B=2, f32, TF32 off, no dropout) and
   compares the losses, the first step's gradients (each tensor against
   what a one-ulp nudge of the image and weights does to it on the CPU)
   and the BN running stats (phase ``train_check``);
7. trains at full width (phase ``train``): checks that every step launched
   K1, K2 and K2b 4 times each, that the loss is finite and that every
   parameter moved; times 10 steps after 2 warm-up steps with CUDA events
   (img/s) and records the peak memory, at torch's TF32 defaults, off and
   on, and breaks one step at the defaults down by kernel group.

    python3 chip_smoke.py

Each phase prints one JSON line; then come the card's name and power limit
(as nvidia-smi gives them), the kernels' JSON line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the exit code is not 0 and no result line is printed.
Without CUDA, or outside a checkout of the repo, it exits 1 at once.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_FLOPS = 67e12            # H100 SXM float32 outside the tensor cores
STAGES = [(32, 32, 1024), (64, 64, 512), (128, 128, 256), (256, 256, 128)]
WHOLE_STAGES = [(2 * h, 2 * w, c) for h, w, c in STAGES]   # 512² images
TRAIN_BATCH = 8              # bench.py's train step: B=8 at 512², bf16
ODD = [(3, 37, 53, 24), (2, 19, 23, 13), (1, 130, 71, 40)]
SLIDE = dict(mode='slide', crop_size=(256, 256), stride=(170, 170))
SOURCE = 'stc_unet_tpu_torch/csrc/coordatt_fused.cu'
REPLACES = {'strip_pools': 'stc_unet_tpu/ops/coordatt_fused.py:94',
            'gate_add': 'stc_unet_tpu/ops/coordatt_fused.py:150',
            'gate_dots': 'stc_unet_tpu/ops/coordatt_fused.py:186'}
KERNELS = tuple(REPLACES)
# bench.py's train step
OPTIMIZER = dict(type='Adam', lr=1e-5, betas=(0.9, 0.999))
LR_CONFIG = dict(policy='poly', power=0.9, min_lr=1e-6, by_epoch=False)
MAX_ITERS = 1000
# The least yardstick of one gradient tensor in train_check, as a share of
# its norm: f32 sums taken in another order differ by that much even where
# a one-ulp nudge of the inputs moves the tensor less.
GRAD_FLOOR = 1e-5
NUDGE_SEEDS = (7, 8, 9, 10)


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def reset_counts(cf):
    for name in KERNELS:
        getattr(cf, name).launches = 0


def read_counts(cf):
    return {name: getattr(cf, name).launches for name in KERNELS}


def set_tf32(torch, cudnn, matmul):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


def metas(n, size):
    return [dict(ori_shape=(size, size, 3), img_shape=(size, size, 3),
                 pad_shape=(size, size, 3), flip=False) for _ in range(n)]


def event_ms(torch, fn, warmup=2, iters=10):
    """Median device time of one call, from a CUDA event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_kernels(torch, cf):
    """K1, K2 and K2b against their plain versions on the card, at the
    Up-stage shapes of slide tiles and of whole 512² images (N=2: the
    whole and the train geometry) and odd shapes."""
    err = dict.fromkeys(KERNELS, 0.0)
    checked = []
    shapes = [(2,) + s for s in STAGES + WHOLE_STAGES] + ODD
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(shapes):
            x, do, a_h, a_w = gates(torch, shape, dtype, i)
            e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
            e3 = check_gate_dots(torch, cf, do, a_h, a_w)
            for name, e in zip(KERNELS, (e1, e2, e3)):
                err[name] = max(err[name], e)
            checked.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                                strip_pools_err=e1, gate_add_err=e2,
                                gate_dots_err=e3))
            del x, do, a_h, a_w
    emit('kernels', ok=True, checked=checked,
         tolerance=dict(
             strip_pools='rtol 1e-5 atol 1e-4, bit-identical reruns',
             gate_add='f32 rtol/atol 1e-6; bf16 <= 1 ulp',
             gate_dots='rtol 1e-5 atol 1e-4, bit-identical reruns; '
                       'gate_add autograd: dx == do, d a_h and d a_w '
                       'f32 rtol 1e-5 atol 1e-4, bf16 rtol 2^-7'))
    return err


def phase_slice(torch, cf, model, cpu_model_fn):
    """Serve slide and whole requests; count launches; hold the card's
    logits against the port on the CPU."""
    g = torch.Generator(device='cuda').manual_seed(1)
    imgs = torch.rand((2, 512, 512, 3), generator=g,
                      device='cuda').to(torch.bfloat16)
    launches = dict.fromkeys(KERNELS, 0)
    served = {}
    for mode in ('slide', 'whole'):
        model.test_cfg = dict(SLIDE) if mode == 'slide' else dict(mode=mode)
        reset_counts(cf)
        t0 = time.perf_counter()
        preds = model(return_loss=False, img=[imgs], img_metas=[metas(2, 512)])
        seconds = time.perf_counter() - t0
        counts = read_counts(cf)
        if counts != {'strip_pools': 4, 'gate_add': 4, 'gate_dots': 0}:
            raise AssertionError(f'{mode}: kernel launches {counts}, want 4 '
                                 'of K1 and K2, none of K2b')
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
    on_cpu = cpu_model_fn().encode_decode(x)
    max_err = (on_card - on_cpu).abs().max().item()
    margin = on_cpu[..., 1] - on_cpu[..., 0]
    margin_err = ((on_card[..., 1] - on_card[..., 0]) -
                  margin).abs().max().item()
    margin_std = margin.std().item()
    # The seeded model's logits are small (|max| ~0.2) and its class margin
    # spreads ~1e-2, so the limits are set against those, not against 1.
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-5, atol=1e-5)
    if margin_err > 1e-3 * margin_std:
        raise AssertionError(f'class margin off by {margin_err}, over 1e-3 '
                             f'of its spread {margin_std}')
    agree = (on_card.argmax(-1) == on_cpu.argmax(-1)).float().mean().item()
    if agree < 0.999:
        raise AssertionError(f'argmax agreement {agree} < 0.999')
    emit('slice', ok=True, config='my_config/STC-UNet.py', served=served,
         cpu_check=dict(size=256, mode='whole', dtype='float32',
                        max_abs_err=max_err, argmax_agreement=agree,
                        logits_abs_max=on_cpu.abs().max().item(),
                        margin_std=margin_std,
                        margin_max_abs_err=margin_err,
                        class1_share=(margin > 0).float().mean().item(),
                        tolerance='logits rtol 1e-5 atol 1e-5; class '
                                  'margin within 1e-3 of its std; argmax '
                                  '>= 0.999'))
    return launches


def phase_timing(torch, model, settings):
    """bench.py's protocol: slide B=14, whole B=8, p50 at bs 1, bf16; one
    row per TF32 setting ``(label, cudnn, matmul)``."""
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
        rows.append(dict(
            tf32=label, cudnn_allow_tf32=cudnn, matmul_allow_tf32=matmul,
            slide_ms_b14=slide_ms, slide_slices_per_s=14e3 / slide_ms,
            slide_peak_mem_gb=peak / 1e9,
            whole_ms_b8=whole_ms, whole_slices_per_s=8e3 / whole_ms,
            p50_ms_bs1=statistics.median(lat)))
        model.test_cfg = dict(SLIDE)
        emit('profile', run='slide', batch=img.shape[0], tf32=label,
             **profile_run(torch, lambda: model.slide_inference(
                 img, None, False), slide_ms))
    set_tf32(torch, False, False)
    emit('timing', image='bf16 512x512', timer='CUDA events, median of 5 '
         'after 2 warmup; p50 on the host clock with synchronize, 20 calls',
         rows=rows)
    return rows


def bound(r):
    """Fill in r's bound: the larger of its bytes over the memory rate and
    its operations over the f32 rate."""
    t_bytes = r['bytes'] / HBM_BYTES_PER_S * 1e3
    t_ops = r['flops'] / F32_FLOPS * 1e3
    r.update(bound_ms=max(t_bytes, t_ops),
             bound_by='bytes' if t_bytes >= t_ops else 'operations')
    return r


def phase_kernel_timing(torch, cf, err):
    """K1 and K2 at the Up-stage shapes of the B=14 slide batch (126
    tiles, f32 x as in the model), K2b at those of the B=8 train batch
    (bf16, as the train step gives them), each beside its plain version
    and a one-call PyTorch yardstick; then each held against its plain
    version on those inputs, its max abs error folded into err. K1 and K2
    are also held against theirs at the bf16 train shapes."""
    n = 14 * 9
    per = {name: [] for name in KERNELS}
    for h, w, c in STAGES:
        x = torch.randn((n, h, w, c), device='cuda')
        a_h = torch.rand((n, h, c), device='cuda')
        a_w = torch.rand((n, w, c), device='cuda')
        xb, sb = x.numel() * 4, (n * h * c + n * w * c) * 4
        rows = {
            'strip_pools': dict(
                ms=event_ms(torch, lambda: cf.strip_pools(x)),
                plain_ms=event_ms(torch,
                                  lambda: cf.strip_pools_reference(x)),
                library_ms=event_ms(torch, lambda: (
                    torch.sum(x, 2, dtype=torch.float32),
                    torch.sum(x, 1, dtype=torch.float32))),
                library='torch.sum(x, 2, dtype=f32) + torch.sum(x, 1, '
                        'dtype=f32), two calls',
                bytes=xb + sb, flops=2 * x.numel()),
            'gate_add': dict(
                ms=event_ms(torch, lambda: cf.gate_add(x, a_h, a_w)),
                plain_ms=event_ms(torch, lambda: cf.gate_add_reference(
                    x, a_h, a_w)),
                library_ms=event_ms(torch, lambda: torch.addcmul(
                    x, a_h[:, :, None, :], a_w[:, None, :, :])),
                library='torch.addcmul(x, a_h[:,:,None,:], a_w[:,None,:,:])',
                bytes=2 * xb + sb, flops=2 * x.numel()),
        }
        for name, r in rows.items():
            r['shape'] = [n, h, w, c]
            per[name].append(bound(r))
        e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
        err['strip_pools'] = max(err['strip_pools'], e1)
        err['gate_add'] = max(err['gate_add'], e2)
        rows['strip_pools']['max_abs_err'] = e1
        rows['gate_add']['max_abs_err'] = e2
        del x, a_h, a_w
        torch.cuda.empty_cache()
    # K2b's yardstick: two einsums, with cuBLAS's reductions kept in f32
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    train_checked = []
    for i, (h, w, c) in enumerate(WHOLE_STAGES):
        shape = (TRAIN_BATCH, h, w, c)
        x, do, a_h, a_w = gates(torch, shape, torch.bfloat16, 100 + i)
        # the train step gives K1 and K2 these shapes too
        e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
        err['strip_pools'] = max(err['strip_pools'], e1)
        err['gate_add'] = max(err['gate_add'], e2)
        train_checked.append(dict(shape=list(shape), strip_pools_err=e1,
                                  gate_add_err=e2))
        del x
        r = dict(
            ms=event_ms(torch, lambda: cf.gate_dots(do, a_h, a_w)),
            plain_ms=event_ms(torch, lambda: cf.gate_dots_reference(
                do, a_h, a_w)),
            library_ms=event_ms(torch, lambda: (
                torch.einsum('nhwc,nwc->nhc', do, a_w),
                torch.einsum('nhwc,nhc->nwc', do, a_h))),
            library='torch.einsum nhwc,nwc->nhc + nhwc,nhc->nwc (bf16, '
                    'f32 accumulation), two calls',
            bytes=(do.numel() + a_h.numel() + a_w.numel()) * 2 +
            (a_h.numel() + a_w.numel()) * 4,
            flops=4 * do.numel(), shape=list(shape),
            max_abs_err=check_gate_dots(torch, cf, do, a_h, a_w))
        err['gate_dots'] = max(err['gate_dots'], r['max_abs_err'])
        per['gate_dots'].append(bound(r))
        del do, a_h, a_w
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    torch.cuda.empty_cache()
    emit('kernel_timing', dtype=dict(strip_pools='float32',
                                     gate_add='float32',
                                     gate_dots='bfloat16'),
         batch=dict(strip_pools=n, gate_add=n, gate_dots=TRAIN_BATCH),
         stages=per, train_shapes_checked=dict(dtype='bfloat16',
                                               rows=train_checked))
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


def phase_train_check(torch, cfg, init_segmentor):
    """Two train steps at full width on the card and on the port on the
    CPU, from the same weights: 64² images, B=2, f32, TF32 off (set by
    main), no dropout. Compares each step's losses, the first step's
    gradients and BN running stats, and the step count of every BN.

    The gradient of the seeded full-width model at this input is touchy:
    moving the image and the weights by one f32 ulp moves it by about 1 %
    of its norm as a whole, and single deep tensors by a few percent. So
    the card's first-step gradient is held to the CPU's within 3 times
    what the largest of four such one-ulp nudges does to the CPU's own
    gradient (the yardstick, measured in the same run): as a whole against
    the whole's yardstick, and each tensor against its own (at least
    GRAD_FLOOR). A nudge moves nearly every tensor together, by an amount
    that varies several-fold from one nudge to the next, so two nudges are
    too few to gauge it. The kernels themselves are held tightly in phase
    ``kernels``, the autograd of ``gate_add`` included."""
    cfg.model.decode_head.dropout_ratio = 0.0
    card = init_segmentor(cfg)
    cpu = init_segmentor(cfg, device='cpu')
    cpu_state = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu.load_state_dict(cpu_state)
    g = torch.Generator().manual_seed(4)
    img = torch.rand((2, 64, 64, 3), generator=g)
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
    coordatt = {k: e for k, e in rel.items() if '.ca.' in k}
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
    emit('train_check', ok=not faults, faults=faults[:8], size=64, batch=2,
         dtype='float32', tf32=False, dropout_ratio=0.0, losses=logs,
         grad_tensors=len(grads['cpu']), grad_tensors_compared=len(rel),
         grad_whole=whole, grad_tensor_median=statistics.median(rel.values()),
         grad_worst=_worst(rel),
         grad_coordatt_worst=_worst(coordatt, 4),
         grad_over_own_one_ulp_worst=_worst(ratio),
         grad_coordatt_over_own_one_ulp_worst=_worst(
             {k: r for k, r in ratio.items() if '.ca.' in k}, 4),
         one_ulp_whole=[w for _, w in nudged],
         one_ulp_tensor_median=[statistics.median(r.values())
                                for r, _ in nudged],
         one_ulp_worst=[_worst(r, 3) for r, _ in nudged],
         one_ulp_coordatt_worst=[_worst({k: e for k, e in r.items()
                                         if '.ca.' in k}, 2)
                                 for r, _ in nudged],
         bn_stats_step1_max_abs_err=stats_err,
         tolerance=f'losses rtol 1e-5; acc_seg within 3 pixels; gradient '
                   f'as a whole within 3x the largest of '
                   f'{len(NUDGE_SEEDS)} one-ulp wholes, each tensor within '
                   f'3x the largest of its own {len(NUDGE_SEEDS)} one-ulp '
                   f'changes (at least {GRAD_FLOOR}), nudges on the CPU; '
                   f'step-1 BN stats rtol 1e-4 atol 1e-5')
    if faults:
        raise AssertionError(f'train_check: {faults[:3]}')
    del card, cpu, steps, models
    torch.cuda.empty_cache()


def phase_train(torch, cf, model, settings):
    """bench.py's train step on the full-width model: B=8 at 512², bf16
    compute, Adam lr 1e-5 with the poly lr, dropout 0.1 from a seeded
    generator. Per TF32 setting ``(label, cudnn, matmul)``: 2 warm-up
    steps, each checked to launch K1, K2 and K2b 4 times, then 10 steps
    timed with one CUDA event pair; the loss must be finite and every
    parameter must move. The first setting's run is profiled by kernel
    group. Returns the launches of all steps."""
    g = torch.Generator(device='cuda').manual_seed(5)
    img = torch.rand((TRAIN_BATCH, 512, 512, 3), generator=g, device='cuda')
    gt = (img.mean(-1) > 0.5).long()
    drop = torch.Generator(device='cuda').manual_seed(6)
    params = dict(model.named_parameters())
    launches = dict.fromkeys(KERNELS, 0)
    rows = []
    for label, cudnn, matmul in settings:
        set_tf32(torch, cudnn, matmul)
        step = train_step_for(torch, model, torch.bfloat16)
        before = {k: p.detach().clone() for k, p in params.items()}
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(2):
            reset_counts(cf)
            losses.append(step(img, gt, drop)['loss'])
            counts = read_counts(cf)
            if counts != dict.fromkeys(KERNELS, 4):
                raise AssertionError(f'train step launches {counts}, want 4 '
                                     'of each')
            for k in KERNELS:
                launches[k] += counts[k]
        iters = 10
        reset_counts(cf)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            losses.append(step(img, gt, drop)['loss'])
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        counts = read_counts(cf)
        if counts != dict.fromkeys(KERNELS, 4 * iters):
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
            emit('profile', run='train step', batch=TRAIN_BATCH, tf32=label,
                 **profile_run(torch, lambda: step(img, gt, drop), ms))
    set_tf32(torch, False, False)
    emit('train', ok=True, config='my_config/STC-UNet.py', batch=TRAIN_BATCH,
         size=512, compute_dtype='bfloat16', optimizer=OPTIMIZER,
         lr_config=LR_CONFIG, max_iters=MAX_ITERS, dropout_ratio=0.1,
         timer='one CUDA event pair over 10 steps after 2 warm-up steps',
         launches_per_step=dict.fromkeys(KERNELS, 4), rows=rows)
    return launches


def _kernel_group(name):
    low = name.lower()
    for group, keys in (
            ('coordatt K1/K2/K2b', ('strip_band', 'gate_add')),
            ('optimizer', ('adam', 'multi_tensor')),
            ('conv (FFT)', ('fft', 'cf32')),
            ('conv', ('fprop', 'conv', 'implicit', 'nchwtonhwc',
                      'nhwctonchw', 'wgrad', 'dgrad')),
            ('matmul', ('gemm', 'bmm', 'gemv')),
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
    from stc_unet_tpu_torch.utils import Config

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
                if 'registers' in ln or 'spill' in ln][:24])

    # 3. kernels against their plain versions
    err = phase_kernels(torch, cf)

    # 4. the main path
    cfg_path = os.path.join(REPO, 'my_config', 'STC-UNet.py')
    model = init_segmentor(Config.fromfile(cfg_path))

    def cpu_model():
        m = init_segmentor(Config.fromfile(cfg_path), device='cpu')
        m.load_state_dict({k: v.cpu() for k, v in
                           model.state_dict().items()})
        return m

    launches = phase_slice(torch, cf, model, cpu_model)

    # 5. timing
    phase_timing(torch, model, [('off', False, False),
                                ('torch default',) + default_tf32,
                                ('on', True, True)])
    per = phase_kernel_timing(torch, cf, err)

    # 6. and 7. the train step
    phase_train_check(torch, Config.fromfile(cfg_path), init_segmentor)
    trained = phase_train(torch, cf, model, [('torch default',) + default_tf32,
                                             ('off', False, False),
                                             ('on', True, True)])
    for name in KERNELS:
        launches[name] += trained[name]

    kernels = []
    for name in KERNELS:
        rows = per[name]
        kernels.append(dict(
            name=name, route='cuda', source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=err[name],
            ms=sum(r['ms'] for r in rows),
            plain_ms=sum(r['plain_ms'] for r in rows),
            bound_ms=sum(r['bound_ms'] for r in rows),
            bound_by='bytes' if all(r['bound_by'] == 'bytes' for r in rows)
            else 'operations',
            library_ms=sum(r['library_ms'] for r in rows)))
    print(smi, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stc_unet_tpu_torch``) on one card.

Drives the port's main path, STC-UNet inference at full width
(``my_config/STC-UNet.py``, random weights from seed 0), through
``init_segmentor`` and ``model(return_loss=False, img=[...],
img_metas=[...])`` in slide mode (crop 256, stride 170: the 9 tiles of each
512² image run as one batch) and in whole mode. On the way it

1. records the environment (torch, CUDA, the card's name and power limit,
   torch's TF32 defaults, which the entry point runs with) and turns TF32
   off for every comparison;
2. builds the CUDA kernels from ``stc_unet_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card, at the
   Up-stage shapes of the slide tiles and of whole 512² images, and at odd
   shapes, in f32 and bf16;
4. serves slide and whole requests (B=2 at 512², bf16 images, as the
   benchmark feeds them) and checks that each forward launched each kernel
   4 times; holds the card's logits on a 256² image against the port on
   the CPU (f32, TF32 off);
5. times slide (B=14, 126 tiles), whole (B=8) and the bs-1 whole latency
   with CUDA events, with TF32 off, at torch's defaults and on, and breaks
   one slide forward of each down by kernel with torch.profiler; times each
   kernel at the Up-stage shapes of the B=14 slide batch beside its plain
   version, a one-call PyTorch yardstick and its bound (bytes over
   3.35 TB/s), and checks it against its plain version there too.

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
ODD = [(3, 37, 53, 24), (2, 19, 23, 13), (1, 130, 71, 40)]
SLIDE = dict(mode='slide', crop_size=(256, 256), stride=(170, 170))
SOURCE = 'stc_unet_tpu_torch/csrc/coordatt_fused.cu'
REPLACES = {'strip_pools': 'stc_unet_tpu/ops/coordatt_fused.py:94',
            'gate_add': 'stc_unet_tpu/ops/coordatt_fused.py:150'}


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


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


def phase_kernels(torch, cf):
    """K1 and K2 against their plain versions on the card, at the Up-stage
    shapes of slide tiles and of whole 512² images (N=2) and odd shapes."""
    err = {'strip_pools': 0.0, 'gate_add': 0.0}
    checked = []
    shapes = [(2,) + s for s in STAGES + WHOLE_STAGES] + ODD
    for dtype in (torch.float32, torch.bfloat16):
        for i, shape in enumerate(shapes):
            g = torch.Generator(device='cuda').manual_seed(i)
            x = torch.randn(shape, generator=g, device='cuda').to(dtype)
            n, h, w, c = shape
            a_h = torch.rand((n, h, c), generator=g, device='cuda').to(dtype)
            a_w = torch.rand((n, w, c), generator=g, device='cuda').to(dtype)
            e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
            err['strip_pools'] = max(err['strip_pools'], e1)
            err['gate_add'] = max(err['gate_add'], e2)
            checked.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                                strip_pools_err=e1, gate_add_err=e2))
    emit('kernels', ok=True, checked=checked,
         tolerance=dict(
             strip_pools='rtol 1e-5 atol 1e-4, bit-identical reruns',
             gate_add='f32 rtol/atol 1e-6; bf16 <= 1 ulp'))
    return err


def phase_slice(torch, cf, model, cpu_model_fn):
    """Serve slide and whole requests; count launches; hold the card's
    logits against the port on the CPU."""
    g = torch.Generator(device='cuda').manual_seed(1)
    imgs = torch.rand((2, 512, 512, 3), generator=g,
                      device='cuda').to(torch.bfloat16)
    launches = {'strip_pools': 0, 'gate_add': 0}
    served = {}
    for mode in ('slide', 'whole'):
        model.test_cfg = dict(SLIDE) if mode == 'slide' else dict(mode=mode)
        cf.strip_pools.launches = cf.gate_add.launches = 0
        t0 = time.perf_counter()
        preds = model(return_loss=False, img=[imgs], img_metas=[metas(2, 512)])
        seconds = time.perf_counter() - t0
        counts = {'strip_pools': cf.strip_pools.launches,
                  'gate_add': cf.gate_add.launches}
        if counts != {'strip_pools': 4, 'gate_add': 4}:
            raise AssertionError(f'{mode}: kernel launches {counts}, want 4')
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
        emit('profile', **profile_slide(torch, model, img, slide_ms),
             tf32=label)
    set_tf32(torch, False, False)
    emit('timing', image='bf16 512x512', timer='CUDA events, median of 5 '
         'after 2 warmup; p50 on the host clock with synchronize, 20 calls',
         rows=rows)
    return rows


def phase_kernel_timing(torch, cf, err):
    """Each kernel at the Up-stage shapes of the B=14 slide batch (126
    tiles, f32 x as in the model), beside its plain version and a
    one-call PyTorch yardstick; then each held against its plain version
    on those inputs, its max abs error folded into err."""
    n = 14 * 9
    per = {'strip_pools': [], 'gate_add': []}
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
            t_bytes = r['bytes'] / HBM_BYTES_PER_S * 1e3
            t_ops = r['flops'] / F32_FLOPS * 1e3
            r.update(shape=[n, h, w, c], bound_ms=max(t_bytes, t_ops),
                     bound_by='bytes' if t_bytes >= t_ops else 'operations')
            per[name].append(r)
        e1, e2 = check_kernels(torch, cf, x, a_h, a_w)
        err['strip_pools'] = max(err['strip_pools'], e1)
        err['gate_add'] = max(err['gate_add'], e2)
        rows['strip_pools']['max_abs_err'] = e1
        rows['gate_add']['max_abs_err'] = e2
        del x, a_h, a_w
        torch.cuda.empty_cache()
    emit('kernel_timing', dtype='float32', tiles=n, stages=per)
    return per


def _kernel_group(name):
    low = name.lower()
    for group, keys in (
            ('coordatt K1/K2', ('strip_pools', 'gate_add')),
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


def profile_slide(torch, model, img, forward_ms):
    """Device time by kernel over one slide forward of img; the idle share
    is 1 - (kernel time / the event-timed forward, forward_ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        model.slide_inference(img, None, False)
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
    return dict(slide_batch=img.shape[0], forward_ms=forward_ms,
                kernel_ms=busy, idle_share=max(0.0, 1 - busy / forward_ms),
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

    kernels = []
    for name in ('strip_pools', 'gate_add'):
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

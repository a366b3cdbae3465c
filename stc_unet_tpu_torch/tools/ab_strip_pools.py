"""K1 (``stc_strip_pools``) of this checkout against K1 of another source
file, in turns on one card.

    python -m stc_unet_tpu_torch.tools.ab_strip_pools OTHER.cu

``OTHER.cu`` is another version of ``csrc/coordatt_fused.cu`` with the same
C interface (for example the parent commit's, unpacked with
``git archive``). It is compiled with the port's nvcc flags and bound as
the port binds its own build. At each shape (f32: the Up stages of the
B=14 slide batch, 126 tiles, and the whole-512² up4 stage at N=2) the two
are timed in the order other, this, this, other, each as the median of 20
CUDA event pairs after 3 warm-up launches, and each is held against
``strip_pools_reference``. Prints one JSON line per shape and a summary
line with the sums over the four slide stages.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from stc_unet_tpu_torch.ops import _build
from stc_unet_tpu_torch.ops import coordatt_fused as cf

SLIDE = [(126, 32, 32, 1024), (126, 64, 64, 512), (126, 128, 128, 256),
         (126, 256, 256, 128)]
WHOLE_UP4 = (2, 512, 512, 128)


def _ms(lib, x, warmup=3, iters=20):
    for _ in range(warmup):
        cf._strip_pools_kernel(x, lib)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cf._strip_pools_kernel(x, lib)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _err(lib, x):
    sh, sw = cf._strip_pools_kernel(x, lib)
    eh, ew = cf.strip_pools_reference(x)
    return max((sh - eh).abs().max().item(), (sw - ew).abs().max().item())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('other', type=Path,
                        help='another coordatt_fused.cu to compare with')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('ab_strip_pools: CUDA is not available')
    with tempfile.TemporaryDirectory() as tmp:
        other = Path(tmp) / 'libother.so'
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(other),
                        str(args.other.resolve())], check=True)
        libs = {'other': cf.bind(ctypes.CDLL(str(other)),
                                 ('stc_strip_pools',)),
                'this': cf._kernels()}
    totals = {'other': 0.0, 'this': 0.0}
    for i, shape in enumerate(SLIDE + [WHOLE_UP4]):
        g = torch.Generator(device='cuda').manual_seed(i)
        x = torch.randn(shape, generator=g, device='cuda')
        times = {'other': [], 'this': []}
        for which in ('other', 'this', 'this', 'other'):
            times[which].append(_ms(libs[which], x))
        row = dict(shape=list(shape), dtype='float32')
        for which, ts in times.items():
            row[f'{which}_ms'] = statistics.mean(ts)
            row[f'{which}_ms_runs'] = ts
            row[f'{which}_max_abs_err'] = _err(libs[which], x)
            if shape in SLIDE:
                totals[which] += row[f'{which}_ms']
        print(json.dumps(row), flush=True)
        del x
        torch.cuda.empty_cache()
    print(json.dumps(dict(slide_stages_ms=totals,
                          device=torch.cuda.get_device_name(0))), flush=True)


if __name__ == '__main__':
    main()

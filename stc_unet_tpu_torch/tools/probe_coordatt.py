"""CoordAtt strip-pool probe on the card: kernel P against K1.

Counterpart of the pool part of ``tools/probe_coordatt.py``. At the
probe's four slide-tile decoder stages (B=14 tiles, hw x hw x C =
32² x 1024, 64² x 512, 128² x 256, 256² x 128, bf16 x) it times

- P ``dual_pools`` (``csrc/dual_pools.cu``) as ``dual_plan`` launches it:
  one launch, bands of up to 64 rows in parallel, the bands' column sums
  added inside the launch;
- where a stage has more than one band, P with the other way of adding
  them (``dual_pools_cluster``: a thread-block cluster of the bands,
  through distributed shared memory; ``dual_pools_last``: the last band
  block to finish, from an f32 scratch), whichever the plan does not take;
- K1 ``strip_pools`` (``csrc/coordatt_fused.cu``): the model's kernel,
  bands of rows in parallel and an ordered second pass;
- the two f32 ``torch.sum`` calls (P's plain version, the yardstick),

each with CUDA events (median of 10 calls after 2), beside the bound: x
read once and the two f32 outputs written, over 3.35 TB/s. Each is timed
twice (``tools/timing.py``): ``*_ms`` with the host's time to queue the
call, ``*_device_ms`` with the host's work hidden. P (both ways of adding
the bands) is held to its plain version at each stage (rtol 1e-5, atol
1e-4, as K1; reruns bit-identical). Each stage gives P's plan and, for the
cluster build, the most clusters of its size the card holds at once
(``cudaOccupancyMaxActiveClusters``). The record also gives the global
loads of each build of P in its SASS (``cuobjdump -sass``) and, where the
run built the library, ptxas's registers and spills of each. It prints
the card's name and power limit and one JSON line and writes no file. It
needs a CUDA card::

    python -m stc_unet_tpu_torch.tools.probe_coordatt [--batch 14]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

STAGES = [(32, 1024), (64, 512), (128, 256), (256, 128)]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
_DTYPE_NAMES = {'f': 'f32', '13__nv_bfloat16': 'bf16'}
_COMBINE_NAMES = {'0': 'one_band', '1': 'cluster', '2': 'last'}


def kernel_name(mangled: str):
    """'dual_band<bf16, 8, cluster>' for a (mangled) build of P, else
    None."""
    m = re.search(r'dual_bandI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E', mangled)
    if m is None:
        return None
    return (f'dual_band<{_DTYPE_NAMES[m[1]]}, {m[2]}, '
            f'{_COMBINE_NAMES[m[3]]}>')


def ptxas_usage(log: str) -> dict:
    """{'dual_band<bf16, 8, cluster>': {'registers': r, 'spill_bytes': s},
    ...} of each build of P, from nvcc's ``-Xptxas=-v`` log."""
    from stc_unet_tpu_torch.tools import probe_strip_pools
    return probe_strip_pools.ptxas_usage(log, kernel_name)


def sass_loads(sass: str) -> dict:
    """{'dual_band<bf16, 8, cluster>': {'LDG.E.128.CONSTANT': n, ...},
    ...}: the global-load and bulk-copy instructions of each build of P,
    from ``cuobjdump -sass``."""
    from stc_unet_tpu_torch.tools import probe_strip_pools
    return probe_strip_pools.vector_loads(sass, kernel_name)


def vector_builds_load_128(loads: dict) -> bool:
    """Whether there are 12 builds of P (2 types x vectors or not x 3 ways
    of adding the bands) and each vector build holds 128-bit global loads
    (or bulk or tensor-map copies)."""
    vector = {k: v for k, v in loads.items() if ', 1, ' not in k}
    return len(loads) == 12 and len(vector) == 6 and all(
        any(op.startswith(('LDG.E.128', 'UBLKCP', 'UTMALDG')) for op in ops)
        for ops in vector.values())


def check_dual_pools(x, combine=None):
    """P on x (a CUDA tensor) against its plain version (rtol 1e-5, atol
    1e-4) and its own rerun (bit-identical); the max abs error. With
    ``combine`` the bands are added that way (``dual_plan``)."""
    import torch

    from stc_unet_tpu_torch.ops import dual_pools as dp
    sh, sw = dp._dual_pools_kernel(x, combine)
    sh2, sw2 = dp._dual_pools_kernel(x, combine)
    eh, ew = dp.dual_pools_reference(x)
    torch.testing.assert_close(sh, eh, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(sw, ew, rtol=1e-5, atol=1e-4)
    if not (torch.equal(sh, sh2) and torch.equal(sw, sw2)):
        raise AssertionError(f'dual_pools not deterministic {x.shape}')
    return max((sh - eh).abs().max().item(), (sw - ew).abs().max().item())


def max_clusters(plan, dtype_code) -> int:
    """The most clusters of the plan's size and block that the card holds
    at once, for P's cluster build."""
    from stc_unet_tpu_torch.ops import _build
    from stc_unet_tpu_torch.ops import dual_pools as dp
    out = ctypes.c_int(0)
    _build.check_launch(dp._kernels().stc_dual_pools_clusters(
        dtype_code, plan['vec'], plan['warps'], plan['bands'],
        ctypes.byref(out)), 'stc_dual_pools_clusters')
    return out.value


def builds() -> dict:
    """ptxas's registers and spills and the SASS loads of each build of P
    in the built library."""
    from stc_unet_tpu_torch.ops import _build
    lib = _build.build_all(['dual_pools'])['dual_pools']
    sass = subprocess.run(
        [str(_build.Path(_build._nvcc()).parent / 'cuobjdump'), '-sass',
         str(lib['path'])], capture_output=True, text=True, check=True,
        timeout=300).stdout
    return dict(ptxas=ptxas_usage(lib['log']), sass_loads=sass_loads(sass))


def probe(batch: int = 14, seed: int = 0, check: bool = True) -> dict:
    """Time P (as planned and with the other way of adding the bands), K1
    and the two sums at the four stages, and with ``check`` hold both
    builds of P to its plain version there first; the record, with each
    stage's times (and P's max abs error)."""
    import torch

    from stc_unet_tpu_torch.ops import coordatt_fused as cf
    from stc_unet_tpu_torch.ops import dual_pools as dp
    from stc_unet_tpu_torch.tools.timing import device_ms, event_ms
    if not torch.cuda.is_available():
        raise RuntimeError('probe_coordatt needs a CUDA card')
    g = torch.Generator(device='cuda').manual_seed(seed)
    stages, err = [], 0.0
    for hw, c in STAGES:
        x = torch.rand((batch, hw, hw, c), generator=g,
                       device='cuda').to(torch.bfloat16)
        plan = dp.dual_plan(x.shape, 2, True)
        calls = dict(dual_pools=lambda: dp.dual_pools(x))
        other = None
        if plan['bands'] > 1:
            other = 'last' if plan['combine'] == 'cluster' else 'cluster'
            calls[f'dual_pools_{other}'] = \
                lambda: dp._dual_pools_kernel(x, other)
        calls.update(strip_pools=lambda: cf.strip_pools(x),
                     torch_sums=lambda: dp.dual_pools_reference(x))
        e = None
        if check:
            e = check_dual_pools(x)
            if other is not None:
                e = max(e, check_dual_pools(x, other))
            err = max(err, e)
        out_bytes = (batch * hw * c * 2) * 4
        extra = {}
        if plan['bands'] > 1:
            extra['max_active_clusters'] = max_clusters(
                dp.dual_plan(x.shape, 2, True, 'cluster'), 1)
        stages.append(dict(
            hw=hw, c=c, batch=batch, plan=plan, **extra,
            **{f'{name}_ms': event_ms(fn) for name, fn in calls.items()},
            **{f'{name}_device_ms': device_ms(fn)
               for name, fn in calls.items()},
            bound_ms=(x.numel() * 2 + out_bytes) / HBM_BYTES_PER_S * 1e3,
            bytes=x.numel() * 2 + out_bytes, flops=2 * x.numel(),
            **({} if e is None else dict(dual_pools_max_abs_err=e))))
        del x
        torch.cuda.empty_cache()
    total = {k: sum(s[k] for s in stages) for k in
             ('dual_pools_ms', 'strip_pools_ms', 'torch_sums_ms',
              'dual_pools_device_ms', 'strip_pools_device_ms',
              'torch_sums_device_ms', 'bound_ms')}
    # both ways of adding the bands, over the stages of more than one band
    multi = [s for s in stages if s['plan']['bands'] > 1]
    total['multi_band_device_ms'] = {
        way: sum(s['dual_pools_device_ms'] if s['plan']['combine'] == way
                 else s[f'dual_pools_{way}_device_ms'] for s in multi)
        for way in ('cluster', 'last')}
    return dict(probe='coordatt strip pools', dtype='bfloat16',
                device=torch.cuda.get_device_name(0),
                timer='CUDA events, median of 10 after 2; *_device_ms with '
                      'the host hidden behind a sleep kernel',
                stages=stages, total=total, builds=builds(),
                **({} if not check else dict(
                    dual_pools_max_abs_err=err,
                    tolerance='rtol 1e-5 atol 1e-4 against two f32 '
                              'torch.sum; reruns bit-identical')))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--batch', type=int, default=14)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('probe_coordatt: CUDA is not available', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(probe(args.batch)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

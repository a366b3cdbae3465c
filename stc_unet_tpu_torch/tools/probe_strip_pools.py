"""Ablation probe of the CoordAtt strip-sum kernels K1 and K2b.

Builds variants of ``csrc/coordatt_fused.cu``, each the committed source
with one edit, or runs the committed build with another launch plan, and
times K1 ``strip_pools`` and K2b ``gate_dots`` of each at STC-UNet's four
Up-stage shapes: B=8 bf16 (the train step's 512² batch) and B=126 f32 (the
slide batch's 256² tiles). Each time is ``device_ms`` (``tools/timing.py``:
the host's work hidden), median of 10 calls after 2; the totals are over
the four stages. The variants:

- ``base``: the source and plan as they are;
- ``scalar``: the same build with one element a lane (the plan's ``vec``
  0), as the wrapper runs odd C or unaligned tensors;
- ``group_2`` and ``group_4``: load groups of 2 or 4 pixels in place of 8
  (``kGroup``), so 2 to 4 or 4 to 8 vectors a lane in flight in place of 8
  to 16;
- ``chunk_512``: a warp's column partials a chunk of 512 floats in place
  of 1024 (``kChunkFloats``; bf16 chunks of 8 pixels in place of 16, f32
  of 16 in place of 32), so a block barrier twice as often and half the
  shared memory for them;
- ``warps_8``: blocks of at most 8 warps (bands of 32 rows) in the plan;
- ``scalar_bands``: the second pass, which adds the bands, one float a
  thread in place of four, as the kernel before this design had it;
- ``no_bands``: no second pass (a wrong result where H has more than one
  band): what adding the bands costs.

Every variant but ``no_bands`` keeps the function, and each is held to the
plain versions at the bf16 512² stage and at an H of 1025 (17 bands), as
``worst``: the largest |got - want| over the card check's limit (rtol
1e-5, atol 1e-4; below 1 passes). It also reports ptxas's registers and
spill bytes of each build and, for ``base``, the global loads of each
kernel in its SASS. It prints the card's name and power limit and one JSON
line, and writes nothing but its builds (under
``build/stc_unet_tpu_torch/probe_strip_pools/``). It needs a CUDA card and
``nvcc``::

    python -m stc_unet_tpu_torch.tools.probe_strip_pools
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys

from stc_unet_tpu_torch.ops import _build

# (H, W, C) of the four Up stages: of the 512² train batch, of a 256² tile
TRAIN = [(64, 64, 1024), (128, 128, 512), (256, 256, 256), (512, 512, 128)]
SLIDE = [(32, 32, 1024), (64, 64, 512), (128, 128, 256), (256, 256, 128)]
TRAIN_BATCH, SLIDE_BATCH = 8, 126

# variant: [(pattern, replacement, matches)]; every pattern must match the
# committed source that many times
_GROUP = r'constexpr int kGroup = 8;'
EDITS = {
    'base': [],
    'scalar': [],
    'group_2': [(_GROUP, 'constexpr int kGroup = 2;', 1)],
    'group_4': [(_GROUP, 'constexpr int kGroup = 4;', 1)],
    'chunk_512': [(r'constexpr int kChunkFloats = 1024;',
                   'constexpr int kChunkFloats = 512;', 1)],
    'warps_8': [],
    'scalar_bands': [(r'const bool vec4 = wc % 4 == 0',
                      'const bool vec4 = false', 1)],
    'no_bands': [(r'  if \(bands > 1\) \{\n    const int64_t wc',
                  '  if (false) {\n    const int64_t wc', 1)],
}
# variants that run the committed build with another plan
PLANS = {'scalar': dict(vec=0), 'warps_8': dict(max_warps=8)}
SAME_FUNCTION = tuple(v for v in EDITS if v != 'no_bands')


def variant_source(name: str, source: str) -> str:
    """The committed ``source`` with variant ``name``'s edits; raises if
    an edit does not match as often as it should."""
    for pattern, repl, count in EDITS[name]:
        source, n = re.subn(pattern, lambda _: repl, source)
        if n != count:
            raise ValueError(f'{name}: {pattern!r} matched {n} times, '
                             f'expected {count}')
    return source


def kernel_name(mangled: str):
    """'strip_band<bf16, 8, dots>' for a (mangled) K1/K2b kernel name,
    else None."""
    m = re.search(r'strip_bandI(f|13__nv_bfloat16)Li(\d+)ELb([01])E',
                  mangled)
    if m is None:
        return None
    return (f'strip_band<{"f32" if m[1] == "f" else "bf16"}, {m[2]}, '
            f'{"dots" if m[3] == "1" else "pools"}>')


def ptxas_usage(log: str) -> dict:
    """{'strip_band<bf16, 8, pools>': {'registers': r, 'spill_bytes': s},
    ...} of each K1/K2b build, from nvcc's ``-Xptxas=-v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            fn = kernel_name(line)
        elif fn and 'spill stores' in line:
            out.setdefault(fn, {})['spill_bytes'] = int(
                line.split('bytes spill stores')[0].split()[-1])
        elif fn and 'Used' in line and 'registers' in line:
            out.setdefault(fn, {})['registers'] = int(
                line.split('Used')[1].split()[0])
    return out


def vector_loads(sass: str) -> dict:
    """{'strip_band<bf16, 8, pools>': {'LDG.E.128.CONSTANT': n, ...}, ...}:
    the global-load and bulk-copy instructions of each K1/K2b build, from
    ``cuobjdump -sass``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = kernel_name(line)
            if fn:
                counts[fn] = {}
        elif fn:
            m = re.search(r'\b(LDG(?:\.[A-Z0-9]+)*|UBLKCP(?:\.[A-Z0-9]+)*|'
                          r'UTMALDG(?:\.[A-Z0-9]+)*|LDGSTS(?:\.[A-Z0-9]+)*)',
                          line)
            if m:
                counts[fn][m[1]] = counts[fn].get(m[1], 0) + 1
    return counts


def _build_variants(names):
    """Compile every variant with its own source at once, one nvcc each;
    {name: (library path, nvcc log)}. Variants without edits share the
    committed build."""
    out_dir = _build.BUILD_DIR / 'probe_strip_pools'
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.SRC_DIR / 'coordatt_fused.cu').read_text()
    base = _build.build_all(['coordatt_fused'])['coordatt_fused']
    procs, libs = {}, {}
    for name in names:
        if not EDITS[name]:
            libs[name] = (base['path'], base['log'])
            continue
        src = out_dir / f'{name}.cu'
        src.write_text(variant_source(name, source))
        lib = out_dir / f'lib{name}.so'
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {n: p.communicate()[0] for n, (_, p) in procs.items()}
    for name, (lib, proc) in procs.items():
        if proc.returncode:
            raise RuntimeError(f'nvcc failed on variant {name}:\n'
                               f'{logs[name][-3000:]}')
        libs[name] = (lib, logs[name])
    return libs


@contextlib.contextmanager
def _variant(cf, name, path):
    """The K1/K2b wrappers launching the kernels of ``path`` with variant
    ``name``'s plan."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in cf._SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = _build.INT
    saved_lib, saved_plan = cf._lib, cf.strip_plan
    change = PLANS.get(name, {})

    def plan(shape, itemsize, aligned):
        p = saved_plan(shape, itemsize, aligned and 'vec' not in change)
        if p['warps'] > change.get('max_warps', p['warps']):
            n, h, w, c = shape
            warps = change['max_warps']
            bands = -(-h // (warps * cf._SLOTS))
            p.update(warps=warps, bands=bands,
                     blocks=n * bands * p['tiles'],
                     scratch=(n, bands, w, c) if bands > 1 else None)
        return p
    cf._lib, cf.strip_plan = lib, plan
    try:
        yield
    finally:
        cf._lib, cf.strip_plan = saved_lib, saved_plan


def _worst(got, want):
    return max(((g - e).abs() / (1e-5 * e.abs() + 1e-4)).max().item()
               for g, e in zip(got, want))


def _inputs(torch, batch, stage, dtype, g):
    h, w, c = stage
    x = torch.randn((batch, h, w, c), generator=g, device='cuda').to(dtype)
    a_h = torch.rand((batch, h, c), generator=g, device='cuda').to(dtype)
    a_w = torch.rand((batch, w, c), generator=g, device='cuda').to(dtype)
    return x, a_h, a_w


def probe(seed: int = 0) -> dict:
    """Build every variant, time K1 and K2b of each and hold those that
    keep the function to the plain versions; the record."""
    import torch

    from stc_unet_tpu_torch.ops import coordatt_fused as cf
    from stc_unet_tpu_torch.tools.timing import device_ms
    if not torch.cuda.is_available():
        raise RuntimeError('probe_strip_pools needs a CUDA card')
    libs = _build_variants(EDITS)
    sass = subprocess.run(
        [str(_build.Path(_build._nvcc()).parent / 'cuobjdump'), '-sass',
         str(libs['base'][0])], capture_output=True, text=True,
        check=True).stdout
    g = torch.Generator(device='cuda').manual_seed(seed)
    cases = [('bf16', TRAIN_BATCH, TRAIN, torch.bfloat16),
             ('f32', SLIDE_BATCH, SLIDE, torch.float32)]
    check = [_inputs(torch, TRAIN_BATCH, TRAIN[-1], torch.bfloat16, g),
             _inputs(torch, 2, (1025, 3, 64), torch.float32, g)]
    want = [(cf.strip_pools_reference(x), cf.gate_dots_reference(x, a, b))
            for x, a, b in check]
    rows = {}
    for name, (path, log) in libs.items():
        row = dict(ptxas=ptxas_usage(log))
        with _variant(cf, name, path):
            for label, batch, stages, dtype in cases:
                times = []
                for stage in stages:
                    x, a_h, a_w = _inputs(torch, batch, stage, dtype, g)
                    times.append(dict(
                        strip_pools=device_ms(lambda: cf.strip_pools(x)),
                        gate_dots=device_ms(
                            lambda: cf.gate_dots(x, a_h, a_w))))
                    del x, a_h, a_w
                    torch.cuda.empty_cache()
                row[label] = dict(stages=times, **{
                    f'{k}_total': sum(t[k] for t in times)
                    for k in times[0]})
            if name in SAME_FUNCTION:
                row['worst'] = max(
                    max(_worst(cf.strip_pools(x), w1),
                        _worst(cf.gate_dots(x, a_h, a_w), w2))
                    for (x, a_h, a_w), (w1, w2) in zip(check, want))
        rows[name] = row
    return dict(probe='strip sums ablation (K1, K2b)',
                device=torch.cuda.get_device_name(0),
                shapes=dict(bf16=[[TRAIN_BATCH, *s] for s in TRAIN],
                            f32=[[SLIDE_BATCH, *s] for s in SLIDE]),
                timer='device_ms: the host hidden behind a sleep kernel, '
                      'median of 10 after 2; per stage and over the four',
                worst='max |got - want| / (1e-5 |want| + 1e-4) against the '
                      'plain versions at (8, 512, 512, 128) bf16 and (2, '
                      '1025, 3, 64) f32',
                sass_loads=vector_loads(sass), variants=rows)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)
    import torch
    if not torch.cuda.is_available():
        print('probe_strip_pools: CUDA is not available', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(probe()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

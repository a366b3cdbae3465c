"""Ablation probe of the flash-attention backward kernels Ldkv and Ldq.

Builds variants of ``csrc/flash_attention.cu``, each the committed source
with one edit, and times Ldkv and Ldq of each at one x4 call of the B=8
train step: (8, 2, 4096, 256) f32, as strided views of (N, L, 2·256)
rows, as the model gives them. The variants:

- ``base``: the source as it is;
- ``no_scores``: the score products s and dp left out (zeros);
- ``no_grads``: the gradient products (dv, dk; dq) left out;
- ``no_prefetch``: the next streamed tile is never copied;
- ``masked_copy``: whole tiles take the masked copy path too;
- ``trunc_hi``: hi = x truncated to TF32 (one integer operation fewer
  than rounding it to nearest);
- ``cvt_rna_hi``: hi rounded to nearest by ``cvt.rna.tf32.f32`` in place
  of the two integer operations.

The first three compute a wrong result and show what each part costs; the
last three compute the same function, and each is held to the plain
versions at (1, 2, 4096, 256) as ``worst``: the largest |got - want| over
the check's limit (rtol 1e-4, atol 1e-5 of the largest value; below 1
passes). For each variant it also reports ptxas's registers and spills
and, from ``cuobjdump -sass``, the instructions and the TF32 MMAs of the
two kernels at DP = 256 with 16-byte copies. Times are CUDA events,
median of 5 calls after 2. It prints the card's name and power limit and
one JSON line, and writes nothing but its builds (under
``build/stc_unet_tpu_torch/probe_flash_bwd/``). It needs a CUDA card and
``nvcc``::

    python -m stc_unet_tpu_torch.tools.probe_flash_bwd
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import importlib
import json
import os
import re
import subprocess
import sys

from stc_unet_tpu_torch.ops import _build

SHAPE = (8, 2, 4096, 256)    # one x4 call of the B=8 train step
CHECK_N = 1                  # batch of the check against the plain version

_ZERO_SCORES = ('    for (int j = 0; j < 2; ++j)\n'
                '      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;')
_CVT_RNA = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));')
# variant: [(pattern, replacement, matches)]; every pattern must match the
# committed source that many times
EDITS = {
    'base': [],
    'no_scores': [(r'    score_tile<DP>\(acc, [^;]*;', _ZERO_SCORES, 2)],
    'no_grads': [(r'    grad_tile<DP, NT>\([^;]*;[^\n]*', '', 3)],
    'no_prefetch': [(r'if \((q|k)0 \+ kTile < L(q|k)\) \{', 'if (false) {',
                     2)],
    'masked_copy': [(r'if \(VEC && d == DP && r0 \+ kTile <= L\) \{',
                     'if (false) {', 1)],
    'trunc_hi': [(r'  hi = tf32_rna\(x\);',
                  '  hi = __float_as_uint(x) & 0xffffe000u;', 1)],
    'cvt_rna_hi': [(r'  hi = tf32_rna\(x\);', _CVT_RNA, 1)],
}
SAME_FUNCTION = ('base', 'masked_copy', 'trunc_hi', 'cvt_rna_hi')
KERNELS = ('flash_bwd_dkv_tc', 'flash_bwd_dq_tc')


def variant_source(name: str, source: str) -> str:
    """The committed ``source`` with variant ``name``'s edits; raises if
    an edit does not match as often as it should."""
    for pattern, repl, count in EDITS[name]:
        source, n = re.subn(pattern, lambda _: repl, source)
        if n != count:
            raise ValueError(f'{name}: {pattern!r} matched {n} times, '
                             f'expected {count}')
    return source


def _build_variants(names):
    """Compile every variant at once, one nvcc each; {name: (library
    path, nvcc log)}."""
    out_dir = _build.BUILD_DIR / 'probe_flash_bwd'
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.SRC_DIR / 'flash_attention.cu').read_text()
    procs = {}
    for name in names:
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
    return {n: (lib, logs[n]) for n, (lib, _) in procs.items()}


def _is_timed(fn: str) -> bool:
    """Whether a (mangled) kernel name is Ldkv or Ldq at DP = 256 with
    16-byte copies (``...ILi256ELb1E...``)."""
    return any(k in fn for k in KERNELS) and 'ILi256ELb1E' in fn


def ptxas_usage(log: str) -> dict:
    """{kernel: {'registers': r, 'spill_bytes': s}} of the timed kernels,
    from nvcc's ``-Xptxas=-v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        if 'Compiling entry function' in line:
            fn = line.split("'")[1]
        elif fn and _is_timed(fn) and 'spill stores' in line:
            out.setdefault(_short(fn), {})['spill_bytes'] = int(
                line.split('bytes spill stores')[0].split()[-1])
        elif fn and _is_timed(fn) and 'Used' in line:
            out.setdefault(_short(fn), {})['registers'] = int(
                line.split('Used')[1].split()[0])
    return out


def _short(fn: str) -> str:
    return next(k for k in KERNELS if k in fn)


def sass_counts(library) -> dict:
    """{kernel: {'instructions': n, 'tf32_mmas': m}} of the timed kernels,
    from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME
    return count_sass(subprocess.run(
        [os.path.join(CUDA_HOME, 'bin', 'cuobjdump'), '-sass', str(library)],
        capture_output=True, text=True, check=True, timeout=300).stdout)


def count_sass(sass: str) -> dict:
    """``sass_counts`` of the text ``cuobjdump -sass`` printed: the
    instructions are the lines that start with an address comment."""
    out, fn = {}, None
    count = collections.Counter()
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :')[1].strip()
            fn = _short(name) if _is_timed(name) else None
            if fn:
                out[fn] = count = collections.Counter()
        elif fn and re.match(r'\s+/\*[0-9a-f]{4,}\*/', line):
            count['instructions'] += 1
            if 'MMA' in line and 'TF32' in line:
                count['tf32_mmas'] += 1
    return {k: dict(v) for k, v in out.items()}


@contextlib.contextmanager
def _library(fa, path):
    """The flash-attention wrappers launching the kernels of ``path``."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in fa._SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = _build.INT
    saved, fa._lib = fa._lib, lib
    try:
        yield
    finally:
        fa._lib = saved


def _inputs(torch, n, h, length, d, g):
    """q, k, v, do as strided (N, H, L, d) views of (N, L, 4 H d) rows."""
    x = torch.randn((n, length, 4 * h * d), generator=g, device='cuda')
    return [x[..., j * h * d:(j + 1) * h * d].reshape(
        n, length, h, d).transpose(1, 2) for j in range(4)]


def _worst(got, want):
    limit = 1e-4 * want.abs() + 1e-5 * want.abs().max()
    return ((got - want).abs() / limit).max().item()


def probe(seed: int = 0) -> dict:
    """Build every variant, time Ldkv and Ldq of each and hold those that
    keep the function to the plain versions; the record."""
    import torch

    from stc_unet_tpu_torch.tools.timing import event_ms

    # the package's ``flash_attention`` is the function; this is its module
    fa = importlib.import_module('stc_unet_tpu_torch.ops.flash_attention')
    if not torch.cuda.is_available():
        raise RuntimeError('probe_flash_bwd needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build_variants(EDITS)
    g = torch.Generator(device='cuda').manual_seed(seed)
    n, h, length, d = SHAPE
    scale = d ** -0.5
    q, k, v, do = _inputs(torch, n, h, length, d, g)
    o, lse = fa.flash_attention_forward(q, k, v, scale)
    di = (o * do).sum(-1)
    c = [t[:CHECK_N] for t in (q, k, v, do, lse, di)]
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        c[0], c[1], c[2], c[4], c[3], c[5], scale)
    want_dq = fa.flash_attention_bwd_dq_reference(
        c[0], c[1], c[2], c[4], c[3], c[5], scale)
    rows = {}
    for name, (path, log) in libs.items():
        with _library(fa, path):
            row = dict(
                dkv_ms=event_ms(lambda: fa.flash_attention_bwd_dkv(
                    q, k, v, lse, do, di, scale), iters=5),
                dq_ms=event_ms(lambda: fa.flash_attention_bwd_dq(
                    q, k, v, lse, do, di, scale), iters=5),
                ptxas=ptxas_usage(log), sass=sass_counts(path))
            if name in SAME_FUNCTION:
                dk, dv = fa.flash_attention_bwd_dkv(
                    c[0], c[1], c[2], c[4], c[3], c[5], scale)
                dq = fa.flash_attention_bwd_dq(
                    c[0], c[1], c[2], c[4], c[3], c[5], scale)
                row['worst'] = dict(dk=_worst(dk, want_dk),
                                    dv=_worst(dv, want_dv),
                                    dq=_worst(dq, want_dq))
        rows[name] = row
    return dict(probe='flash attention backward ablation', dtype='float32',
                shape=list(SHAPE), check_shape=[CHECK_N] + list(SHAPE[1:]),
                device=torch.cuda.get_device_name(0),
                timer='CUDA events, median of 5 after 2',
                worst='max |got - want| / (1e-4 |want| + 1e-5 max |want|) '
                      'against the plain versions',
                variants=rows)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)
    import torch
    if not torch.cuda.is_available():
        print('probe_flash_bwd: CUDA is not available', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(probe()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

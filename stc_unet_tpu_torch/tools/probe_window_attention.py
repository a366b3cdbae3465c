"""Ablation probe of MaxViT's window-attention kernels K3f and K3b.

Builds variants of ``csrc/window_attention.cu``, each the committed source
with one edit, and times K3f and K3b of each at MaxViT-UNet's four B=8
stage shapes (32 heads, 8x8 windows, bf16, q, k and v the thirds of one
qkv row as the model gives them), at rates 0 and 0.1: ``device_ms``
(``tools/timing.py``: the host's work hidden), median of 10 calls after
2, and the totals over one forward's or one step's 28 calls. The
variants:

- ``base``: the source as it is;
- ``no_philox``: no Philox call; the dropout's compare and multiply stay,
  on bits that are not random;
- ``no_exp``: ``ex2.approx`` replaced by a multiply;
- ``no_phase2``: K3b's second phase (dk and dv) left out;
- ``blocks_8192`` and ``blocks_1024``: K3f's grid aims at 8192 or 1024
  blocks in place of 2048 (more or fewer windows a block);
- ``bounds_5_4``: ``__launch_bounds__`` asking for 5 blocks an SM of K3f
  and 4 of K3b, which caps their registers at 102 and 128.

The first three compute a wrong result and show what each part costs; the
last three compute the same function, and each is held to the plain
versions at the /4 stage at rate 0.1 as ``worst``: the largest |got -
want| over the card check's bf16 limit (rtol 2^-7, atol 2^-7 of the
largest value; dbias rtol 1e-4, atol 1e-5; below 1 passes). For each
variant it also reports ptxas's registers and spill bytes of each
build. It prints the card's name and power limit and one JSON line, and
writes nothing but its builds (under
``build/stc_unet_tpu_torch/probe_window_attention/``). It needs a CUDA
card and ``nvcc``::

    python -m stc_unet_tpu_torch.tools.probe_window_attention
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

HEADS = 32
# (windows W, tokens N, channels C, calls per forward) at B=8, 512²
STAGES = [(2048, 64, 64, 8), (512, 64, 128, 8), (128, 64, 256, 8),
          (32, 64, 512, 4)]
RATES = (0.0, 0.1)

_FWD = r'__launch_bounds__\(kThreads\)\nwa_fwd\('
_BWD = r'__launch_bounds__\(kThreads\)\nwa_bwd\('
# variant: [(pattern, replacement, matches)]; every pattern must match the
# committed source that many times
EDITS = {
    'base': [],
    'no_philox': [(r'const uint4 bits = philox4\([^;]*;',
                   'const uint4 bits = make_uint4(ctr, t, ctr >> 3, key0);',
                   2)],
    'no_exp': [(re.escape('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                          '"f"(x));'), 'y = x * 0.5f;', 1)],
    'no_phase2': [(r'    if \(rows\) \{\n      float dka', '    if (false) {'
                   '\n      float dka', 1)],
    'blocks_8192': [(r'\(long long\)W \* H / 2048', '(long long)W * H / 8192',
                     1)],
    'blocks_1024': [(r'\(long long\)W \* H / 2048', '(long long)W * H / 1024',
                     1)],
    'bounds_5_4': [(_FWD, '__launch_bounds__(kThreads, 5)\nwa_fwd(', 1),
                   (_BWD, '__launch_bounds__(kThreads, 4)\nwa_bwd(', 1)],
}
SAME_FUNCTION = ('base', 'blocks_8192', 'blocks_1024', 'bounds_5_4')


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
    """'wa_fwd<bf16, 16>' for a (mangled) K3 kernel name, else None."""
    m = re.search(r'(wa_fwd|wa_bwd)I(f|13__nv_bfloat16)Li(\d+)E', mangled)
    if m is None:
        return None
    return f'{m[1]}<{"f32" if m[2] == "f" else "bf16"}, {m[3]}>'


def ptxas_usage(log: str) -> dict:
    """{'wa_fwd<bf16, 2>': {'registers': r, 'spill_bytes': s}, ...} of each
    K3 build, from nvcc's ``-Xptxas=-v`` log."""
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


def _build_variants(names):
    """Compile every variant at once, one nvcc each; {name: (library
    path, nvcc log)}."""
    out_dir = _build.BUILD_DIR / 'probe_window_attention'
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.SRC_DIR / 'window_attention.cu').read_text()
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


@contextlib.contextmanager
def _library(wa, path):
    """The window-attention wrappers launching the kernels of ``path``."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in wa._SIGNATURES.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = _build.INT
    saved, wa._lib = wa._lib, lib
    try:
        yield
    finally:
        wa._lib = saved


def _inputs(torch, w, n, c, g):
    """q, k, v (the thirds of one bf16 qkv tensor), bias_e, seed, do."""
    qkv = torch.randn((w, n, 3 * c), generator=g, device='cuda').to(
        torch.bfloat16)
    bias_e = 0.1 * torch.randn((n, HEADS * n), generator=g, device='cuda')
    seed = torch.randint(2 ** 62, (1,), generator=g, device='cuda')
    do = torch.randn((w, n, c), generator=g, device='cuda').to(
        torch.bfloat16)
    return (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:], bias_e, seed,
            do)


def _worst(got, want, dbias=False):
    got, want = got.float(), want.float()
    rtol, atol = (1e-4, 1e-5) if dbias else (2 ** -7, 2 ** -7)
    limit = rtol * want.abs() + atol * want.abs().max()
    return ((got - want).abs() / limit).max().item()


def probe(seed: int = 0) -> dict:
    """Build every variant, time K3f and K3b of each and hold those that
    keep the function to the plain versions; the record."""
    import torch

    from stc_unet_tpu_torch.ops import window_attention as wa
    from stc_unet_tpu_torch.tools.timing import device_ms
    if not torch.cuda.is_available():
        raise RuntimeError('probe_window_attention needs a CUDA card')
    libs = _build_variants(EDITS)
    g = torch.Generator(device='cuda').manual_seed(seed)
    scale = HEADS ** -0.5
    inputs = [_inputs(torch, w, n, c, g) for w, n, c, _ in STAGES]
    q, k, v, b, sd, do = inputs[0]
    check_rate = RATES[-1]
    want = (wa.window_attention_reference(q, k, v, b, sd, HEADS, scale,
                                          check_rate),) + \
        wa.window_attention_backward_reference(q, k, v, b, sd, do, HEADS,
                                               scale, check_rate)
    rows = {}
    for name, (path, log) in libs.items():
        row = dict(ptxas=ptxas_usage(log))
        with _library(wa, path):
            for rate in RATES:
                times = {}
                for (w, _, _, calls), (q, k, v, b, sd, do) in zip(STAGES,
                                                                  inputs):
                    times[w] = (
                        device_ms(lambda: wa.window_attention(
                            q, k, v, b, sd, HEADS, scale, rate)),
                        device_ms(lambda: wa.window_attention_backward(
                            q, k, v, b, sd, do, HEADS, scale, rate)))
                row[f'rate {rate}'] = dict(
                    stages={str(w): t for w, t in times.items()},
                    window_attention_total=sum(
                        s[3] * times[s[0]][0] for s in STAGES),
                    window_attention_backward_total=sum(
                        s[3] * times[s[0]][1] for s in STAGES))
            if name in SAME_FUNCTION:
                q, k, v, b, sd, do = inputs[0]
                got = (wa.window_attention(q, k, v, b, sd, HEADS, scale,
                                           check_rate),) + \
                    wa.window_attention_backward(q, k, v, b, sd, do, HEADS,
                                                 scale, check_rate)
                row['worst'] = {
                    key: _worst(x, y, key == 'dbias') for key, x, y in zip(
                        ('out', 'dq', 'dk', 'dv', 'dbias'), got, want)}
        rows[name] = row
    return dict(probe='window attention ablation', dtype='bfloat16',
                heads=HEADS, stages=[list(s) for s in STAGES],
                device=torch.cuda.get_device_name(0),
                timer='device_ms: the host hidden behind a sleep kernel, '
                      'median of 10 after 2; (K3f, K3b) per stage',
                worst='max |got - want| / the bf16 limit against the plain '
                      f'versions at the /4 stage, rate {check_rate}',
                variants=rows)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)
    import torch
    if not torch.cuda.is_available():
        print('probe_window_attention: CUDA is not available',
              file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps(probe()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

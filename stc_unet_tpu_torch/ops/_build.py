"""Build the port's CUDA kernels from ``csrc/`` at first use.

Each ``csrc/<name>.cu`` becomes
``build/stc_unet_tpu_torch/lib<name>_<hash>.so`` at the root of the
checkout: a shared library with a plain C interface, compiled by ``nvcc``
for ``sm_90a`` and loaded with ``ctypes``. The hash
covers the sources and the flags, so an edit rebuilds. All sources are
compiled at once, one ``nvcc`` each, in parallel.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'stc_unet_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA '
                           'toolkit that builds the port\'s kernels')
    nvcc = os.path.join(CUDA_HOME, 'bin', 'nvcc')
    if not os.path.exists(nvcc):
        raise RuntimeError(f'nvcc not found at {nvcc}')
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in ('.cu', '.cuh', '.h'):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f'lib{name}_{h.hexdigest()[:16]}.so'


def build_all(names=None) -> Dict[str, dict]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no library for its current hash. Returns, per name, ``path``,
    ``built`` (compiled by this call), ``seconds`` and ``log`` (nvcc's
    output, with ptxas's register and spill counts)."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob('*.cu'))
    out = {n: dict(path=_target(n), built=False, seconds=0.0, log='')
           for n in names}
    todo = [n for n in names if not out[n]['path'].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for n in todo:
            tmp = out[n]['path'].with_name(
                f'{out[n]["path"].name}.{os.getpid()}.tmp')
            cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(SRC_DIR / f'{n}.cu')]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        # wait for every compile before reporting any failure
        logs = {n: proc.communicate()[0] for n, (_, proc) in procs.items()}
        for n, (tmp, proc) in procs.items():
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on csrc/{n}.cu '
                                   f'(exit {proc.returncode}):\n{logs[n]}')
            os.replace(tmp, out[n]['path'])
            out[n].update(built=True, seconds=time.perf_counter() - t0,
                          log=logs[n])
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]['path']))
    return _LIBS[name]

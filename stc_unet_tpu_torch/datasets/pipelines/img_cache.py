"""The decoded-image cache of the loading transforms (≙
``stc_unet_tpu/datasets/pipelines/img_cache.py``).

Decoding a PNG recomputes the same array from an unchanged file every
epoch; augmentation has to stay random, the decode does not. With
``cache='ram'`` or ``'disk'`` on ``LoadImageFromFile`` or
``LoadAnnotations`` (or ``data.img_cache`` in a config, which the CLIs
hand to :func:`~stc_unet_tpu_torch.datasets.inject_img_cache`), each file
is decoded once:

- ``'ram'``: a dict of decoded arrays shared by every transform of the
  process, for datasets that fit in host memory (a 512² BGR slice is
  0.75 MB);
- ``'disk'``: one ``.npz`` a file under ``cache_dir`` (default
  ``~/.cache/stc_unet_tpu_torch/img_cache``), written through a temporary
  file and an atomic rename.

An entry is keyed by the file's absolute path and the decode parameters,
and holds the file's mtime and size: an edited file is decoded again and
overwrites its entry. Every serve is a fresh writable array that shares
no memory with the cache, since later transforms write into it (the
``label_map`` remap, ``PhotoMetricDistortion``). The dict operations
hold the GIL, so the loader's threads may share the cache.
"""
from __future__ import annotations

import hashlib
import os
import os.path as osp
import tempfile
from typing import Callable, Optional

import numpy as np

# entry id -> (signature, array), shared by every transform of the process
_RAM_CACHE: dict = {}


def _file_sig(path: str) -> np.ndarray:
    st = os.stat(path)
    return np.array([st.st_mtime_ns, st.st_size], np.int64)


class DecodedImageCache:
    """``get(path, decode)`` returns ``decode(path)``, decoded once a file
    (module docstring). ``mode`` is ``'ram'`` or ``'disk'``; ``params``
    (the loader's decode settings) go into the key, so one file decoded
    two ways has two entries."""

    def __init__(self, mode: str, cache_dir: Optional[str] = None,
                 params: tuple = ()):
        if mode not in ('ram', 'disk'):
            raise ValueError(f"img cache mode must be 'ram' or 'disk', "
                             f"got {mode!r}")
        self.mode = mode
        self.params = tuple(params)
        self.cache_dir = cache_dir or osp.join(
            osp.expanduser('~'), '.cache', 'stc_unet_tpu_torch', 'img_cache')

    def _entry_id(self, path: str) -> str:
        return repr((osp.abspath(path),) + self.params)

    def _disk_path(self, entry_id: str) -> str:
        digest = hashlib.sha1(entry_id.encode()).hexdigest()
        return osp.join(self.cache_dir, digest + '.npz')

    def get(self, path: str, decode: Callable[[str], np.ndarray]
            ) -> np.ndarray:
        entry_id = self._entry_id(path)
        sig = _file_sig(path)
        if self.mode == 'ram':
            hit = _RAM_CACHE.get(entry_id)
            if hit is None or not np.array_equal(hit[0], sig):
                arr = np.ascontiguousarray(decode(path))
                _RAM_CACHE[entry_id] = (sig, arr)
            else:
                arr = hit[1]
            return arr.copy()
        npz = self._disk_path(entry_id)
        if osp.isfile(npz):
            try:
                with np.load(npz, allow_pickle=False) as z:
                    if np.array_equal(z['sig'], sig):
                        return z['arr']
            except (OSError, ValueError, KeyError):
                pass                   # a damaged entry: decode again
        arr = np.ascontiguousarray(decode(path))
        os.makedirs(self.cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix='.tmp')
        try:
            with os.fdopen(fd, 'wb') as f:
                np.savez(f, sig=sig, arr=arr)
            os.replace(tmp, npz)
        except BaseException:
            if osp.exists(tmp):
                os.unlink(tmp)
            raise
        return arr


def build_img_cache(cache, cache_dir=None, params=()):
    """None, ``'none'`` or False → None; ``'ram'`` or ``'disk'`` → a
    :class:`DecodedImageCache`."""
    if not cache or cache == 'none':
        return None
    return DecodedImageCache(cache, cache_dir=cache_dir, params=params)


def clear_ram_cache():
    """Drop every array of the RAM cache."""
    _RAM_CACHE.clear()

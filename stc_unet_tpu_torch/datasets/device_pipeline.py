"""Train augmentation on the card (≙
``stc_unet_tpu/datasets/device_pipeline.py``).

The host only decodes, resizes and pads each sample to one static shape
(``DeviceFormatBundle``), and the loader collates uint8 batches. Crop,
flip, photometric distortion and normalize then run here, batched, on
tensors on the card. The JAX package jits the four into one XLA program;
the port runs them as torch ops (a few tens of elementwise passes over
the batch; no hand-written kernel).

Each transform comes in two halves. ``draw_*`` takes the per-sample
parameters from a ``torch.Generator`` that the caller hands in, on the
CPU: the stream is then the same wherever the other half runs, and the
crop offsets are on the host, where slicing takes them without a sync.
``apply_*`` applies given parameters, as the JAX functions do after their
draws. The JAX key stream (threefry) is not reproduced. Given JAX's own
draws, the apply halves give JAX's crop, flip, labels and normalize
exactly and its photometric step to a few f32 ulps
(``tests/test_torch_device_pipeline.py``).

The deltas against the host pipeline are the JAX package's:

- ``RandomCrop``'s ``cat_max_ratio`` is not resampled: the crop is
  uniform within each sample's un-padded extent.
- ``PhotoMetricDistortion`` runs in float32 on the BGR image:
  brightness, contrast, saturation (a lerp toward the gray, the mean of
  the three channels) and hue (a rotation about the gray axis by the
  drawn angle in cv2's units, 180 to the circle), each with probability
  0.5, in that order, clipped to [0, 255] once at the end. The host
  draws whether contrast comes first or last, goes through cv2's HSV for
  saturation and hue, and truncates to uint8 after each step.

The image comes out NHWC float32 and the labels int64, as
``DefaultFormatBundle`` gives them to the train step.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# the f32 constants of the JAX program: 1 / sqrt(3) as f32 ops give it, the
# weakly typed 2π/180 rounded to f32, and the f32 reciprocal of 3 by which
# XLA replaces a division by the constant 3
_INV_SQRT3 = float(np.float32(1.0) / np.sqrt(np.float32(3.0)))
_RAD_PER_HUE = float(np.float32(2.0 * math.pi / 180.0))
_THIRD = float(np.float32(1.0) / np.float32(3.0))
PHOTOMETRIC_KEYS = ('brightness', 'do_brightness', 'contrast', 'do_contrast',
                    'saturation', 'do_saturation', 'hue', 'do_hue')


def _uniform(generator, n, low, high):
    return low + (high - low) * torch.rand(n, generator=generator)


def _bernoulli(generator, n, prob):
    return torch.rand(n, generator=generator) < prob


def _to_device(t, device):
    """A CPU tensor on ``device``: through pinned memory and a
    ``non_blocking`` copy for the card, so the host does not wait."""
    if device.type == 'cuda' and t.device.type == 'cpu':
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _upload(columns, device):
    """(B,) CPU tensors as one f32 copy to ``device``: a (len, B, 1, 1, 1)
    tensor."""
    packed = torch.stack([torch.as_tensor(c).to(torch.float32)
                          for c in columns])
    return _to_device(packed, device).view(len(columns), -1, 1, 1, 1)


def _channel_mean(img):
    """The mean of the 3 channels as the compiled JAX program takes it:
    summed in channel order, times the f32 reciprocal of 3."""
    return (img[..., 0:1] + img[..., 1:2] + img[..., 2:3]) * _THIRD


# -- crop ---------------------------------------------------------------------
def draw_crop(generator, batch: int, hw, crop_size, valid_hw=None):
    """The crop offsets ``(y0, x0)``, each int64 (B,) on the CPU: uniform
    in [0, H - h] and [0, W - w], or with ``valid_hw`` (B, 2), the
    un-padded extent of each sample, ``floor(u·(extent - h + 1))`` in f32
    (JAX ``device_pipeline.py:43-46``), so the host's padding does not
    enter the crop's distribution."""
    (h, w), (ch, cw) = hw, crop_size
    if valid_hw is None:
        return (torch.randint(0, max(h - ch, 0) + 1, (batch,),
                              generator=generator),
                torch.randint(0, max(w - cw, 0) + 1, (batch,),
                              generator=generator))
    valid = torch.as_tensor(np.asarray(valid_hw), dtype=torch.int64)
    offsets = []
    for axis, size in ((0, ch), (1, cw)):
        span = (valid[:, axis] - size).clamp(min=0) + 1
        u = torch.rand(batch, generator=generator)
        offsets.append((u * span.to(torch.float32)).to(torch.int64))
    return tuple(offsets)


def apply_crop(img, gt, offsets, crop_size):
    """Crop each sample of ``img`` (B, H, W, C) and ``gt`` (B, H, W) at its
    offsets (CPU tensors or sequences) to ``crop_size``; offsets are
    clamped into the array, as ``lax.dynamic_slice`` clamps them."""
    (ch, cw), (h, w) = crop_size, img.shape[1:3]
    boxes = [(min(max(int(y), 0), max(h - ch, 0)),
              min(max(int(x), 0), max(w - cw, 0)))
             for y, x in zip(*offsets)]
    return (torch.stack([img[i, y:y + ch, x:x + cw]
                         for i, (y, x) in enumerate(boxes)]),
            torch.stack([gt[i, y:y + ch, x:x + cw]
                         for i, (y, x) in enumerate(boxes)]))


# -- flip ---------------------------------------------------------------------
def draw_flip(generator, batch: int, prob: float = 0.5):
    """Each sample's flip flag, bool (B,) on the CPU, true with ``prob``."""
    return _bernoulli(generator, batch, prob)


def apply_flip(img, gt, flip, direction: str = 'horizontal'):
    """Flip the flagged samples of ``img`` (B, H, W, C) and ``gt`` (B, H,
    W) along W (``'horizontal'``) or H (``'vertical'``)."""
    if direction not in ('horizontal', 'vertical'):
        raise ValueError(f'apply_flip: direction {direction!r}')
    flags = [bool(f) for f in flip]
    if not any(flags):
        return img, gt
    dim = 1 if direction == 'horizontal' else 0
    return tuple(torch.stack([s.flip(dim) if f else s
                              for s, f in zip(t, flags)])
                 for t in (img, gt))


# -- photometric ----------------------------------------------------------------
def draw_photometric(generator, batch: int, brightness_delta: float = 32.0,
                     contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                     hue_delta: float = 18.0):
    """Each sample's jitter, (B,) tensors on the CPU under
    ``PHOTOMETRIC_KEYS``: the brightness delta, the contrast and
    saturation factors and the hue angle in cv2's units (180 to the
    circle; no hue draws when ``hue_delta`` is 0), each with its mask
    (true with probability 0.5)."""
    ranges = dict(brightness=(-brightness_delta, brightness_delta),
                  contrast=contrast_range, saturation=saturation_range,
                  hue=(-hue_delta, hue_delta))
    params = {}
    for name, (low, high) in ranges.items():
        if name == 'hue' and not hue_delta:
            break
        params[name] = _uniform(generator, batch, low, high)
        params[f'do_{name}'] = _bernoulli(generator, batch, 0.5)
    return params


def apply_photometric(img, params):
    """Brightness, contrast, saturation and hue jitter on a float32 BGR
    batch (B, H, W, 3) in [0, 255], as the JAX ``photometric`` computes
    it (``device_pipeline.py:78-119``), with the parameters of
    ``draw_photometric``; clipped to [0, 255]."""
    keys = [k for k in PHOTOMETRIC_KEYS if k in params]
    cols = dict(zip(keys, _upload([params[k] for k in keys], img.device)))
    img = torch.where(cols['do_brightness'] > 0,
                      img + cols['brightness'], img)
    img = torch.where(cols['do_contrast'] > 0, img * cols['contrast'], img)
    gray = _channel_mean(img)
    img = torch.where(cols['do_saturation'] > 0,
                      gray + (img - gray) * cols['saturation'], img)
    if 'hue' in cols:
        # Rodrigues' rotation about (1, 1, 1)/sqrt(3): for the centred
        # colour vector the a·aᵀ term vanishes, leaving cos·v + sin·(a × v)
        theta = cols['hue'] * _RAD_PER_HUE
        mean = _channel_mean(img)
        v = img - mean
        vx, vy, vz = v.unbind(-1)
        crossed = torch.stack([vy - vz, vz - vx, vx - vy], -1) * _INV_SQRT3
        rotated = mean + torch.cos(theta) * v + torch.sin(theta) * crossed
        img = torch.where(cols['do_hue'] > 0, rotated, img)
    return img.clamp(0.0, 255.0)


# -- normalize ------------------------------------------------------------------
def _norm_stats(mean, std):
    """``mean`` and the f32 reciprocal of ``std``, a (2, 3) f32 tensor on
    the CPU."""
    return torch.from_numpy(np.stack([
        np.asarray(mean, np.float32),
        np.float32(1.0) / np.asarray(std, np.float32)]))


def _normalize(img, stats, to_rgb):
    """``(img - mean) / std`` in float32, BGR to RGB first with
    ``to_rgb``, as the compiled JAX program computes it: XLA turns the
    division by the constant ``std`` into a product with its f32
    reciprocal, which can differ from a division by an ulp (not for the
    flagship's std of 1)."""
    if to_rgb:
        img = img.flip(-1)
    return (img - stats[0]) * stats[1]


# -- the program ----------------------------------------------------------------
def make_device_train_pipeline(crop_size: Optional[Tuple[int, int]],
                               mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                               to_rgb: bool = True, flip_prob: float = 0.5,
                               flip_direction: str = 'horizontal',
                               photo_metric: bool = True,
                               photo_metric_cfg: Optional[dict] = None):
    """``fn(generator, img_u8, gt_u8, valid_hw=None) -> (img, gt)``.

    ``img_u8`` (B, H, W, 3) uint8 BGR and ``gt_u8`` (B, H, W) uint8 are
    tensors on the device the program runs on; ``valid_hw`` (B, 2) the
    optional un-padded extents, on the host (:func:`draw_crop`). Crop,
    flip, photometric distortion and normalize run in that order; the
    image comes out (B, h, w, 3) float32, the labels int64.
    ``fn.draw(generator, batch, hw, valid_hw=None)`` gives the parameters
    (a dict of CPU tensors) and ``fn.apply(img_u8, gt_u8, params)``
    applies them; ``fn`` is the one after the other.
    """
    pm = dict(photo_metric_cfg or {})
    stats = {}

    def draw(generator, batch, hw, valid_hw=None):
        params = {}
        if crop_size is not None:
            params['crop'] = draw_crop(generator, batch, hw, crop_size,
                                       valid_hw)
        params['flip'] = draw_flip(generator, batch, flip_prob)
        if photo_metric:
            params['photometric'] = draw_photometric(generator, batch, **pm)
        return params

    def apply(img_u8, gt_u8, params):
        img, gt = img_u8, gt_u8
        if crop_size is not None:
            img, gt = apply_crop(img, gt, params['crop'], crop_size)
        img, gt = apply_flip(img, gt, params['flip'], flip_direction)
        img, gt = img.to(torch.float32), gt.to(torch.int64)
        if photo_metric:
            img = apply_photometric(img, params['photometric'])
        if img.device not in stats:
            stats[img.device] = _to_device(_norm_stats(mean, std),
                                           img.device)
        img = _normalize(img, stats[img.device], to_rgb)
        return img, gt

    def pipeline(generator, img_u8, gt_u8, valid_hw=None):
        return apply(img_u8, gt_u8, draw(generator, img_u8.shape[0],
                                         tuple(img_u8.shape[1:3]), valid_hw))

    pipeline.draw, pipeline.apply = draw, apply
    return pipeline


# -----------------------------------------------------------------------------
# Wiring: split a train pipeline's cfg into the host prefix and the device
# program's parameters, and finish a loader's batches on the device
# (``data = dict(..., device_pipeline=True)``).
# -----------------------------------------------------------------------------

_DEVICE_TYPES = ('RandomCrop', 'RandomFlip', 'PhotoMetricDistortion',
                 'Normalize')


def split_train_pipeline(pipeline_cfg: Sequence[dict],
                         host_size: Optional[Tuple[int, int]] = None):
    """Split a train pipeline's cfg list into ``(host_cfg, params)``: the
    host prefix and ``make_device_train_pipeline``'s keyword arguments.

    The device program takes over at the first ``RandomCrop``,
    ``RandomFlip``, ``PhotoMetricDistortion`` or ``Normalize``. A later
    ``Pad`` is absorbed (the host pads to the static size; its pad values
    carry over to ``DeviceFormatBundle``), ``DefaultFormatBundle`` and
    ``Collect`` are dropped (the device batch is ready for the model), and
    anything else raises ValueError: callers train on the host pipeline
    then. ``RandomCrop``'s ``cat_max_ratio`` is not resampled (the crop is
    uniform), the JAX package's documented delta.

    ``host_size`` (H, W) is the static size the host pads to; without it,
    it comes from the prefix's ``Resize.img_scale``, which is (w, h): the
    square of its longest side with ``keep_ratio``, else its largest h and
    w; at least the crop size.
    """
    cfgs = [dict(c) for c in pipeline_cfg]
    first = next((i for i, c in enumerate(cfgs)
                  if c['type'] in _DEVICE_TYPES), None)
    if first is None:
        raise ValueError('no device-expressible transform in pipeline')
    prefix, rest = cfgs[:first], cfgs[first:]

    params = dict(crop_size=None, flip_prob=0.0,
                  flip_direction='horizontal', photo_metric=False,
                  photo_metric_cfg={}, mean=(0., 0., 0.), std=(1., 1., 1.),
                  to_rgb=True)
    pad_vals = dict(pad_val=0, seg_pad_val=255)
    for c in rest:
        t = c['type']
        if t == 'RandomCrop':
            params['crop_size'] = tuple(c['crop_size'])
        elif t == 'RandomFlip':
            params['flip_prob'] = c.get('prob', c.get('flip_ratio',
                                                      0.5)) or 0.0
            params['flip_direction'] = c.get('direction', 'horizontal')
            if params['flip_direction'] not in ('horizontal', 'vertical'):
                raise ValueError('unsupported flip direction')
        elif t == 'PhotoMetricDistortion':
            params['photo_metric'] = True
            params['photo_metric_cfg'] = {
                k: tuple(c[k]) if k.endswith('range') else c[k]
                for k in ('brightness_delta', 'contrast_range',
                          'saturation_range', 'hue_delta') if k in c}
        elif t == 'Normalize':
            params['mean'] = tuple(c['mean'])
            params['std'] = tuple(c['std'])
            params['to_rgb'] = c.get('to_rgb', True)
        elif t == 'Pad':
            size, crop = c.get('size'), params['crop_size']
            if size is not None and crop is not None and \
                    tuple(size) != crop:
                raise ValueError('Pad size != crop size not supported '
                                 'on-device')
            pad_vals['pad_val'] = c.get('pad_val', 0)
            pad_vals['seg_pad_val'] = c.get('seg_pad_val', 255)
        elif t not in ('DefaultFormatBundle', 'Collect'):
            raise ValueError(f'transform {t} not device-expressible')

    if host_size is None:
        host_size = _host_size(prefix)
    if host_size is None:
        raise ValueError('cannot infer a static host size; set '
                         'data.device_pipeline_size')
    crop = params['crop_size']
    if crop is not None:
        host_size = (max(host_size[0], crop[0]), max(host_size[1], crop[1]))
    host_cfg = prefix + [
        dict(type='DeviceFormatBundle', size=tuple(host_size), **pad_vals),
        dict(type='Collect', keys=['img', 'gt_semantic_seg', 'valid_hw'],
             meta_keys=()),
    ]
    return host_cfg, params


def _host_size(prefix):
    """The static (H, W) of the prefix's last ``Resize`` with an
    ``img_scale``, or None."""
    host_size = None
    for c in prefix:
        if c['type'] != 'Resize' or c.get('img_scale') is None:
            continue
        if c.get('ratio_range') is not None:
            raise ValueError('ratio_range Resize needs an explicit '
                             'device_pipeline host_size')
        scale = c['img_scale']
        scales = scale if isinstance(scale[0], (list, tuple)) else [scale]
        if c.get('keep_ratio', True):
            # either side of a rescaled image can reach the longest side
            m = max(max(s) for s in scales)
            host_size = (m, m)
        else:
            host_size = (max(s[1] for s in scales),
                         max(s[0] for s in scales))
    return host_size


def batch_seed(seed: int, pass_: int, index: int) -> int:
    """The seed of one batch's ``torch.Generator``: a 64-bit word hashed
    from ``[seed mod 2^32, pass, index]`` (numpy's ``SeedSequence``), as
    ``datasets/builder.py:sample_seed`` keys a sample's ``RandomState``."""
    words = [int(seed) % 2 ** 32, int(pass_), int(index)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _rows(params, lo: int, hi: int):
    """Rows ``[lo, hi)`` of every (B,) tensor in a ``draw`` result."""
    if torch.is_tensor(params):
        return params[lo:hi]
    if isinstance(params, dict):
        return {k: _rows(v, lo, hi) for k, v in params.items()}
    return tuple(_rows(v, lo, hi) for v in params)


class DeviceBatchLoader:
    """Wrap a host loader whose batches are uint8 (``DeviceFormatBundle``)
    and finish each on ``device`` (default ``'cuda'``) with the program of
    :func:`make_device_train_pipeline`.

    Batch ``i`` of a pass draws from a ``torch.Generator`` seeded by
    :func:`batch_seed` from (seed, pass, i). Under data parallelism that
    batch is one rank's part of a global batch: the generator draws the
    parameters of all ``world × B`` samples, and this rank applies rows
    ``[rank·B, (rank+1)·B)`` to its images, as one JAX program draws every
    sample of the global batch apart. A crop offset scales its sample's
    own uniform draw by that sample's own valid extent, so the rows of the
    other ranks need no extents here. ``rank`` and ``world`` are those of
    the wrapped loader's sampler (``rank``, ``num_replicas``), else one
    process; every rank's batches must hold B samples, as the port's
    loaders give them. The pass is the epoch last
    given to :meth:`set_epoch` (the runner gives it before each epoch, as
    the host loader keys its samples on it), else the count of passes
    begun, taken on the consumer's thread. So the stream does not depend
    on ``prefetch``, on abandoned passes, or, through the epoch, on a
    resume. (The JAX package counts passes even with ``set_epoch``, so
    its resumed run draws from pass 0 again.)

    ``prefetch > 0`` runs the upload (pinned memory, ``non_blocking``) and
    the program of the next ``prefetch`` batches in a feeder thread, on the
    loader's side CUDA stream on the card. The consumer's stream waits on the
    batch's event, and the batch's tensors are recorded on that stream
    for the caching allocator. Host errors re-raise on the consumer's
    side, and an abandoned pass stops the thread.
    """

    THREAD_NAME = 'DeviceBatchLoader-prefetch'

    def __init__(self, loader, device_params: dict, seed: int = 0,
                 prefetch: int = 2, device='cuda'):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("DeviceBatchLoader: CUDA is not available; "
                               "pass device='cpu' to augment on the CPU")
        self.loader = loader
        self.fn = make_device_train_pipeline(**device_params)
        self.seed = int(seed or 0)
        self.prefetch = prefetch
        sampler = getattr(loader, 'sampler', None)
        self.rank = getattr(sampler, 'rank', 0)
        self.world = getattr(sampler, 'num_replicas', 1)
        self._pass = 0
        self._epoch = None
        self._side = None

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        if hasattr(self.loader, 'set_epoch'):
            self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def generator(self, pass_: int, index: int) -> torch.Generator:
        """Batch ``index`` of pass ``pass_``'s generator (CPU)."""
        return torch.Generator().manual_seed(
            batch_seed(self.seed, pass_, index))

    def device_batch(self, batch, pass_: int, index: int):
        """One host batch finished on the device: ``img`` and
        ``gt_semantic_seg`` replaced by the program's output."""
        img, gt = (_to_device(torch.as_tensor(batch[k]), self.device)
                   for k in ('img', 'gt_semantic_seg'))
        b, hw = img.shape[0], tuple(img.shape[1:3])
        lo, valid = self.rank * b, batch.get('valid_hw')
        if valid is not None and self.world > 1:
            rows = np.tile(np.asarray(hw, np.int64), (self.world * b, 1))
            rows[lo:lo + b] = np.asarray(valid)
            valid = rows
        params = self.fn.draw(self.generator(pass_, index), self.world * b,
                              hw, valid)
        img, gt = self.fn.apply(img, gt, _rows(params, lo, lo + b))
        return dict(batch, img=img, gt_semantic_seg=gt)

    def __iter__(self):
        pass_ = self._pass if self._epoch is None else self._epoch
        self._pass += 1
        if self.prefetch <= 0:
            for i, batch in enumerate(self.loader):
                yield self.device_batch(batch, pass_, i)
            return
        yield from self._prefetched(pass_)

    def _prefetched(self, pass_):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        if self.device.type == 'cuda' and self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side = self._side

        def produce(i, batch):
            if side is None:
                return self.device_batch(batch, pass_, i), None
            with torch.cuda.stream(side):
                out = self.device_batch(batch, pass_, i)
                ready = torch.cuda.Event()
                ready.record(side)
            return out, ready

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for i, batch in enumerate(self.loader):
                    if not put(produce(i, batch)):
                        return
                item = done
            except BaseException as e:  # re-raised on the consumer's side
                item = e
            put(item)

        thread = threading.Thread(target=feeder, daemon=True,
                                  name=self.THREAD_NAME)
        thread.start()
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    # the feeder hands over a batch, its end or its
                    # error; if it is gone with none of them queued, the
                    # pass would wait forever
                    if not thread.is_alive() and q.empty():
                        raise RuntimeError(
                            'DeviceBatchLoader: the feeder thread ended '
                            'without its end of pass or an error')
                    continue
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                out, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    out['img'].record_stream(stream)
                    out['gt_semantic_seg'].record_stream(stream)
                yield out
        finally:
            # the consumer left the pass (its end, break or close): the
            # feeder stops instead of blocking on a full queue
            stop.set()


def wrap_loader_with_device_pipeline(loader, dataset, pipeline_cfg,
                                     host_size=None, seed: int = 0,
                                     prefetch: int = 2, device='cuda'):
    """Give ``dataset`` (and the datasets it wraps, through ``dataset``
    and ``datasets``) the host prefix of ``pipeline_cfg`` and wrap
    ``loader`` in a :class:`DeviceBatchLoader` on ``device``. Raises
    ValueError for a pipeline that is not device-expressible."""
    from .pipelines import Compose
    host_cfg, params = split_train_pipeline(pipeline_cfg, host_size)
    stack, found = [dataset], False
    while stack:
        ds = stack.pop()
        if hasattr(ds, 'pipeline'):
            ds.pipeline = Compose(host_cfg)
            found = True
        if hasattr(ds, 'dataset'):
            stack.append(ds.dataset)
        if hasattr(ds, 'datasets'):
            stack.extend(ds.datasets)
    if not found:
        raise ValueError('no pipeline-bearing dataset found')
    return DeviceBatchLoader(loader, params, seed=seed, prefetch=prefetch,
                             device=device)

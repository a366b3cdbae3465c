"""The port's PNG codec (``stc_unet_tpu_torch/utils/png.py``) against cv2
and Pillow, which the JAX package reads and writes with.

A corpus of files written by Pillow (``optimize`` off and on) and by cv2
(compression levels 0, 1, 3 and 9), of every colour type the port reads,
with and without a tRNS chunk, decodes bit for bit as
``np.array(PIL.Image.open(p))`` and as ``cv2.imread(p, IMREAD_COLOR)``.
The writer's files, each filter type on its own and cycling by row, read
back equal through the port, cv2 and Pillow. The C unfilter
(``csrc/png_unfilter.c``, built with ``cc``) equals its plain numpy
version on every file. 16-bit, 1/2/4-bit and interlaced files raise.
"""
import os.path as osp
import struct
import sys
import threading
import tracemalloc
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from stc_unet_tpu_torch.ops import _build
from stc_unet_tpu_torch.utils import image, png
from tests.fixtures.torch_threads import torch_threads  # noqa: F401

H, W = 23, 37


def _content(seed, channels):
    """Smooth gradients with noise, so the encoders pick varied filters."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = (yy * 5 + xx * 3)[..., None] + np.arange(channels) * 40
    noise = rng.randint(0, 24, (H, W, channels))
    return ((base + noise) % 256).astype(np.uint8)


def _pil_files(root, optimize):
    rng = np.random.RandomState(1)
    x = _content(0, 4)
    pal = list(rng.randint(0, 256, 768))
    idx = Image.fromarray(x[..., 0], 'P')   # every index up to 255: 8-bit
    idx.putpalette(pal)
    files = {
        'L': (Image.fromarray(x[..., 0]), {}),
        'L_trns': (Image.fromarray(x[..., 0]), dict(transparency=7)),
        'LA': (Image.fromarray(x[..., :2], 'LA'), {}),
        'RGB': (Image.fromarray(x[..., :3]), {}),
        'RGB_trns': (Image.fromarray(x[..., :3]),
                     dict(transparency=(1, 2, 3))),
        'RGBA': (Image.fromarray(x), {}),
        'P': (idx, {}),
        'P_trns': (idx, dict(transparency=5)),
    }
    out = {}
    for name, (im, kw) in files.items():
        path = osp.join(root, f'pil_{name}_opt{int(optimize)}.png')
        im.save(path, optimize=optimize, **kw)
        out[osp.basename(path)] = path
    return out


def _cv2_files(root):
    out = {}
    for level in (0, 1, 3, 9):
        for name, x in (('gray', _content(2, 1)[..., 0]),
                        ('bgr', _content(3, 3)), ('bgra', _content(4, 4))):
            path = osp.join(root, f'cv2_{name}_z{level}.png')
            cv2.imwrite(path, x, [cv2.IMWRITE_PNG_COMPRESSION, level])
            out[osp.basename(path)] = path
    return out


CORPUS = ([f'pil_{n}_opt{o}.png' for o in (0, 1) for n in
           ('L', 'L_trns', 'LA', 'RGB', 'RGB_trns', 'RGBA', 'P', 'P_trns')] +
          [f'cv2_{n}_z{z}.png' for z in (0, 1, 3, 9)
           for n in ('gray', 'bgr', 'bgra')])


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('png'))
    files = {**_pil_files(root, False), **_pil_files(root, True),
             **_cv2_files(root)}
    assert sorted(files) == sorted(CORPUS)
    return files


def _rows(path):
    with open(path, 'rb') as f:
        raw, height, width, color, _ = png.inflate(f.read(), path)
    return raw, height, width * png.CHANNELS[color], png.CHANNELS[color]


@pytest.mark.parametrize('name', CORPUS)
def test_read_equals_pillow(corpus, name):
    path = corpus[name]
    got, want = png.read(path), np.array(Image.open(path))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('name', CORPUS)
def test_read_color_equals_cv2(corpus, name):
    path = corpus[name]
    got, want = png.read_color(path), cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image.imread(path), want)


@pytest.mark.parametrize('name', CORPUS)
def test_c_unfilter_equals_plain_on_the_corpus(corpus, name):
    args = _rows(corpus[name])
    np.testing.assert_array_equal(png.unfilter(*args),
                                  png.unfilter_reference(*args))


def test_the_corpus_holds_every_filter_type(corpus):
    seen = set()
    for path in corpus.values():
        raw, height, row_bytes, _ = _rows(path)
        seen |= set(raw[y * (row_bytes + 1)] for y in range(height))
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize('filter_type', [0, 1, 2, 3, 4, 'cycle'])
@pytest.mark.parametrize('channels', [1, 3])
def test_writer_round_trips_through_cv2_and_pillow(tmp_path, filter_type,
                                                   channels):
    x = _content(5, channels)
    if channels == 1:
        x = x[..., 0]
    f = np.arange(H) % 5 if filter_type == 'cycle' else filter_type
    path = str(tmp_path / 'w.png')
    png.write(path, x, f)
    np.testing.assert_array_equal(png.read(path), x)
    np.testing.assert_array_equal(np.array(Image.open(path)), x)
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    want = np.repeat(x[..., None], 3, 2) if channels == 1 else x[..., ::-1]
    np.testing.assert_array_equal(bgr, want)
    np.testing.assert_array_equal(png.read_color(path), want)
    raw, height, row_bytes, bpp = _rows(path)
    assert [raw[y * (row_bytes + 1)] for y in range(height)] == \
        list(np.broadcast_to(f, (H,)))
    np.testing.assert_array_equal(png.unfilter_reference(raw, height,
                                                         row_bytes, bpp),
                                  x.reshape(-1))


@pytest.mark.parametrize('shape', [(1, 1), (1, 9), (7, 1, 3), (2, 2, 3),
                                   (5, 64), (64, 5, 3)])
def test_unfilter_edges(shape):
    """One-pixel rows and columns, a single row: the first row's upper
    neighbours and the first pixel's left ones are 0."""
    x = np.random.RandomState(6).randint(0, 256, shape).astype(np.uint8)
    for f in (0, 1, 2, 3, 4, np.arange(shape[0]) % 5):
        got, _, _ = png.decode(png.encode(x, f))
        np.testing.assert_array_equal(got, x)
        bpp = 1 if x.ndim == 2 else 3
        rows = png.filter_rows(x.reshape(shape[0], -1), bpp,
                               np.broadcast_to(f, shape[:1]))
        args = (rows.tobytes(), shape[0], rows.shape[1] - 1, bpp)
        np.testing.assert_array_equal(png.unfilter_reference(*args),
                                      x.reshape(-1))


def _patch_ihdr(data, **fields):
    """``data`` with IHDR fields replaced and its CRC made good."""
    keys = ('width', 'height', 'depth', 'color', 'compression', 'filter',
            'interlace')
    values = dict(zip(keys, struct.unpack('>IIBBBBB', data[16:29])))
    values.update(fields)
    body = struct.pack('>IIBBBBB', *(values[k] for k in keys))
    return (data[:16] + body +
            struct.pack('>I', zlib.crc32(b'IHDR' + body)) + data[33:])


def test_unsupported_kinds_raise_naming_file_and_feature(tmp_path):
    cases = {}
    path = str(tmp_path / 'sixteen.png')
    cv2.imwrite(path, (_content(7, 3).astype(np.uint16) * 257))
    cases[path] = '16-bit'
    path = str(tmp_path / 'one.png')
    Image.fromarray(_content(8, 1)[..., 0] > 100).save(path)   # mode '1'
    cases[path] = '1-bit'
    path = str(tmp_path / 'four.png')
    small = Image.fromarray(_content(9, 1)[..., 0] % 9, 'P')
    small.putpalette(list(range(27)))
    small.save(path)
    cases[path] = '4-bit'
    path = str(tmp_path / 'two.png')
    tiny = Image.fromarray(_content(9, 1)[..., 0] % 3, 'P')
    tiny.putpalette(list(range(9)))
    tiny.save(path)
    cases[path] = '2-bit'
    path = str(tmp_path / 'interlaced.png')
    with open(path, 'wb') as f:
        f.write(_patch_ihdr(png.encode(_content(10, 3)), interlace=1))
    cases[path] = 'interlaced'
    for path, what in cases.items():
        with pytest.raises(ValueError, match=what) as err:
            png.read(path)
        assert path in str(err.value)
        with pytest.raises(ValueError, match=what):
            image.imread(path)


def test_damaged_files_raise(tmp_path):
    good = png.encode(_content(11, 3))
    bad_crc = bytearray(good)
    bad_crc[45] ^= 1                                      # inside the IDAT
    rows = png.filter_rows(_content(11, 3).reshape(H, -1), 3, [0] * H)
    rows[3, 0] = 7                                       # no filter type 7
    with pytest.raises(ValueError, match='CRC'):
        png.decode(bytes(bad_crc), 'x.png')
    with pytest.raises(ValueError, match='not a PNG'):
        png.decode(b'GIF89a' + good[6:], 'x.png')
    with pytest.raises(ValueError, match='no IEND'):
        png.decode(good[:-12], 'x.png')
    with pytest.raises(ValueError, match='truncated'):
        png.decode(_patch_ihdr(good, height=H + 1), 'x.png')
    with pytest.raises(ValueError, match='over the'):
        png.decode(_patch_ihdr(good, width=1 << 16, height=1 << 15), 'x.png')
    # 64 KB that inflate to 64 MB: only the rows' 20 bytes are inflated
    bomb = zlib.compress(bytes(1 << 26), 9)
    data = png.encode(np.zeros((4, 4), np.uint8))
    n, = struct.unpack('>I', data[33:37])
    idat = b'IDAT' + bomb
    data = (data[:33] + struct.pack('>I', len(bomb)) + idat +
            struct.pack('>I', zlib.crc32(idat)) + data[41 + n + 4:])
    tracemalloc.start()
    try:
        got = png.decode(data)[0]
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, np.zeros((4, 4)))
    assert peak < 1 << 20, peak
    for fn in (png.unfilter, png.unfilter_reference):
        with pytest.raises(ValueError, match='filter type 7 in row 3'):
            fn(rows.tobytes(), H, W * 3, 3)
    with pytest.raises(ValueError, match='filter types are 0 to 4'):
        png.encode(_content(11, 3), 5)
    with pytest.raises(ValueError, match='RGB'):
        png.encode(_content(11, 4))


def test_threads_decode_in_parallel_from_a_cold_start(tmp_path):
    """More threads than cores read one file while the unfilter library is
    loaded for the first time in the process: each gets the same image."""
    x = _content(12, 3)
    path = str(tmp_path / 't.png')
    png.write(path, x, np.arange(H) % 5)
    _build._LIBS.pop('png_unfilter', None)
    results, errors = [], []

    def work():
        try:
            for _ in range(20):
                results.append(png.read_color(path))
        except Exception as e:          # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(results) == 32 * 20
    for r in results:
        np.testing.assert_array_equal(r, x[..., ::-1])

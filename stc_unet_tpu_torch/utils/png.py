"""PNG reading and writing with ``zlib``, ``struct`` and numpy.

The port's stand-in for the PNG codecs of cv2 and Pillow, which the JAX
package's host I/O uses (``stc_unet_tpu/utils/image.py``,
``datasets/pipelines/loading.py``) and which the card's machine does not
have.

Reading takes 8-bit, non-interlaced images of every colour type: gray,
gray + alpha, RGB, RGBA and palette, with all five row filters. The
unfilter step is ``csrc/png_unfilter.c``, built with ``cc`` at first use
and called through ctypes (which releases the GIL, as ``zlib`` does, so
the loader's threads decode in parallel); ``unfilter_reference`` is its
plain numpy version, which the tests hold it to. A 16-bit, 1/2/4-bit or
interlaced file raises a ``ValueError`` that names the file and what is
not supported; so does one over cv2's limit of 2^30 pixels. Only the
bytes that the rows need are inflated.

- ``read`` gives the samples as stored, as ``np.array(PIL.Image.open(p))``
  does: (H, W) for gray and palette (the raw indices), (H, W, 2/3/4)
  otherwise.
- ``read_color`` gives what ``cv2.imread(p, cv2.IMREAD_COLOR)`` does: BGR
  uint8 (H, W, 3), gray replicated, alpha dropped, palettes expanded.
- ``write`` takes 8-bit gray (H, W) or RGB (H, W, 3) and a filter type 0-4
  (or one per row); encoding reads raw neighbours, so every filter is a
  numpy expression.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
# samples a pixel of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_CRITICAL = (b'IHDR', b'PLTE', b'IDAT', b'IEND')
MAX_PIXELS = 1 << 30          # cv2's CV_IO_MAX_IMAGE_PIXELS


def _unsupported(name, what):
    return ValueError(f'{name}: {what} PNG is not supported (8-bit '
                      f'non-interlaced gray, gray+alpha, RGB, RGBA and '
                      f'palette images only)')


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk, CRCs of the critical ones checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            break
        body = data[pos + 8:end]
        if kind in _CRITICAL:
            crc, = struct.unpack('>I', data[end:end + 4])
            if zlib.crc32(kind + body) != crc:
                raise ValueError(f'{name}: bad CRC in the {kind.decode()} '
                                 f'chunk')
        elif kind[0] & 0x20 == 0:      # an unknown critical chunk
            raise ValueError(f'{name}: unknown critical chunk {kind!r}')
        yield kind, body
        if kind == b'IEND':
            return
        pos = end + 4
    raise ValueError(f'{name}: truncated PNG (no IEND chunk)')


def inflate(data: bytes, name: str = '<bytes>'
            ) -> Tuple[bytes, int, int, int, Optional[np.ndarray]]:
    """(the inflated filtered rows, height, width, colour type, palette as
    (256, 3) uint8 RGB or None) of a PNG file's bytes. ``name`` goes into
    error messages."""
    if data[:8] != SIGNATURE:
        raise ValueError(f'{name}: not a PNG file')
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.zeros((256, 3), np.uint8)
            pal = np.frombuffer(body, np.uint8)[:768].reshape(-1, 3)
            palette[:len(pal)] = pal
        elif kind == b'IDAT':
            idat.append(body)
    if header is None:
        raise ValueError(f'{name}: no IHDR chunk')
    width, height, depth, color, compression, filter_method, interlace = \
        header
    if color not in CHANNELS:
        raise ValueError(f'{name}: invalid colour type {color}')
    if depth == 16:
        raise _unsupported(name, '16-bit')
    if depth != 8:
        raise _unsupported(name, f'{depth}-bit')
    if interlace != 0:
        raise _unsupported(name, 'interlaced (Adam7)')
    if compression != 0 or filter_method != 0 or width == 0 or height == 0:
        raise ValueError(f'{name}: invalid IHDR {header}')
    if color == 3 and palette is None:
        raise ValueError(f'{name}: palette image without a PLTE chunk')
    if width * height > MAX_PIXELS:
        raise ValueError(f'{name}: {width}x{height} pixels, over the '
                         f'{MAX_PIXELS} that cv2 reads')
    expected = height * (width * CHANNELS[color] + 1)
    # inflate no more than the rows need: a small file cannot claim memory
    raw = zlib.decompressobj().decompress(b''.join(idat), expected)
    if len(raw) < expected:
        raise ValueError(f'{name}: image data truncated ({len(raw)} bytes, '
                         f'{expected} expected)')
    return raw, height, width, color, palette if color == 3 else None


def decode(data: bytes, name: str = '<bytes>'
           ) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    """(samples as stored, colour type, palette as (256, 3) uint8 RGB or
    None) of a PNG file's bytes. ``name`` goes into error messages."""
    raw, height, width, color, palette = inflate(data, name)
    channels = CHANNELS[color]
    pixels = unfilter(raw, height, width * channels, channels)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape), color, palette


def _read(path) -> Tuple[np.ndarray, int, Optional[np.ndarray]]:
    with open(path, 'rb') as f:
        return decode(f.read(), str(path))


def read(path) -> np.ndarray:
    """The samples as stored, as ``np.array(PIL.Image.open(path))`` gives
    them (palette images: the raw indices)."""
    return _read(path)[0]


def to_color(pixels: np.ndarray, color: int,
             palette: Optional[np.ndarray]) -> np.ndarray:
    """``decode``'s output as ``cv2.IMREAD_COLOR`` gives it: BGR uint8
    (H, W, 3)."""
    if color == 3:
        return palette[:, ::-1][pixels]
    if color in (0, 4):
        gray = pixels if color == 0 else pixels[..., 0]
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(pixels[..., 2::-1])


def read_color(path) -> np.ndarray:
    """What ``cv2.imread(path, cv2.IMREAD_COLOR)`` gives: BGR uint8
    (H, W, 3)."""
    return to_color(*_read(path))


# -- unfiltering --------------------------------------------------------------

def _unfilter_fn():
    from stc_unet_tpu_torch.ops._build import load_host_library
    fn = load_host_library('png_unfilter').stc_png_unfilter
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int32]
    fn.restype = ctypes.c_int64
    return fn


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int
             ) -> np.ndarray:
    """The image bytes (height * row_bytes, uint8) of ``height`` filtered
    rows of 1 + row_bytes bytes in ``raw``, by ``csrc/png_unfilter.c``."""
    if not 1 <= bpp <= 4 or row_bytes < 1 or height < 0 or \
            len(raw) < height * (row_bytes + 1):
        raise ValueError(f'unfilter: {len(raw)} bytes cannot hold {height} '
                         f'rows of {row_bytes} bytes, {bpp} a pixel')
    out = np.empty(height * row_bytes, np.uint8)
    bad = _unfilter_fn()(raw, out.ctypes.data, height, row_bytes, bpp)
    if bad:
        y = bad - 1
        raise ValueError(f'invalid PNG filter type '
                         f'{raw[y * (row_bytes + 1)]} in row {y}')
    return out


def unfilter_reference(raw: bytes, height: int, row_bytes: int, bpp: int
                       ) -> np.ndarray:
    """``unfilter``'s plain numpy version. The Average and Paeth filters
    need the decoded byte bpp to the left, so the pixels are decoded one
    anti-diagonal (y + x constant) at a time: each pixel's left, upper
    and upper-left neighbours lie on earlier diagonals."""
    rows = np.frombuffer(raw, np.uint8)[:height * (row_bytes + 1)].reshape(
        height, row_bytes + 1)
    filters = rows[:, 0].astype(np.int32)
    if (filters > 4).any():
        y = int(np.argmax(filters > 4))
        raise ValueError(f'invalid PNG filter type {filters[y]} in row {y}')
    width = row_bytes // bpp
    src = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    # one row and one column of zeros above and left of the image
    out = np.zeros((height + 1, width + 1, bpp), np.int32)
    # (H, 5, 1): 1 where the row has that filter type
    is_type = (filters[:, None] == np.arange(5)).astype(np.int32)[..., None]
    for d in range(height + width - 1):
        y0, y1 = max(0, d - width + 1), min(height, d + 1)
        y = np.arange(y0, y1)
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = is_type[y0:y1]
        pred = (t[:, 1] * a + t[:, 2] * b + t[:, 3] * ((a + b) >> 1) +
                t[:, 4] * paeth)
        out[y + 1, x + 1] = (src[y, x] + pred) & 0xff
    return out[1:, 1:].astype(np.uint8).reshape(-1)


# -- writing ------------------------------------------------------------------

def filter_rows(rows: np.ndarray, bpp: int,
                filters: Sequence[int]) -> np.ndarray:
    """(H, 1 + row_bytes) uint8: each row of ``rows`` (H, row_bytes) behind
    its filter type byte, filtered against its raw neighbours."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    f = np.asarray(filters, np.int64)
    out = np.empty((x.shape[0], x.shape[1] + 1), np.uint8)
    out[:, 0] = f
    pred = np.choose(f[:, None], preds)
    out[:, 1:] = (x - pred) & 0xff
    return out


def encode(img: np.ndarray,
           filter_type: Union[int, Sequence[int]] = 0) -> bytes:
    """PNG bytes of an 8-bit gray (H, W) or RGB (H, W, 3) image, every row
    filtered with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4
    Paeth) or row y with ``filter_type[y]``, deflated at zlib's level 6
    (Pillow's default)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f'write: 8-bit gray (H, W) or RGB (H, W, 3) only, '
                         f'got {img.dtype} {img.shape}')
    height, width = img.shape[:2]
    bpp = 1 if img.ndim == 2 else 3
    filters = np.broadcast_to(np.asarray(filter_type, np.int64), (height,))
    if filters.min() < 0 or filters.max() > 4:
        raise ValueError(f'write: filter types are 0 to 4, got {filter_type}')
    rows = filter_rows(img.reshape(height, width * bpp), bpp, filters)

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body)))

    ihdr = struct.pack('>IIBBBBB', width, height, 8, 0 if bpp == 1 else 2,
                       0, 0, 0)
    return (SIGNATURE + chunk(b'IHDR', ihdr) +
            chunk(b'IDAT', zlib.compress(rows.tobytes(), 6)) +
            chunk(b'IEND', b''))


def write(path, img: np.ndarray,
          filter_type: Union[int, Sequence[int]] = 0) -> None:
    """Write ``encode(img, filter_type)`` to ``path``."""
    data = encode(img, filter_type)
    with open(path, 'wb') as f:
        f.write(data)

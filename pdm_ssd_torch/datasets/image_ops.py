"""Camera images without PIL: 8-bit RGB arrays (H, W, 3) uint8.

The JAX package reads, resizes, crops, flips and rotates its camera images
with PIL. The port does the same operations in numpy, to the same pixels:

- `read_png` / `write_png`: PNG on `zlib` (8-bit grey, RGB or RGBA in, RGB
  out; every row filter on reading, none on writing);
- `resize`: PIL's default `Image.resize` (bicubic, a = -0.5, the support
  widened by the scale when shrinking; a horizontal then a vertical pass,
  each in 22-bit fixed point and rounded to uint8);
- `crop`: PIL's `Image.crop`, zeros outside the image;
- `flip_left_right`: `Image.transpose(FLIP_LEFT_RIGHT)`;
- `rotate`: PIL's `Image.rotate(angle)` (nearest pixel, about (w / 2,
  h / 2), the same size, zeros outside), in its 16.16 fixed point.

JPEG (the real nuScenes camera files) needs a decoder the port does not
carry: `read_image` raises for it.
"""
from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_MAGIC = b'\x89PNG\r\n\x1a\n'
# PIL's resampling precision: 32 bits less 8 of the pixel and 2 of headroom
_PRECISION_BITS = 22


# ---- PNG ----------------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


def write_png(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG, every row with
    filter type 0."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_png takes (H, W, 3) uint8, not {img.shape}')
    H, W, _ = img.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * 3)], axis=1)
    head = struct.pack('>IIBBBBB', W, H, 8, 2, 0, 0, 0)
    Path(path).write_bytes(PNG_MAGIC + _chunk(b'IHDR', head)
                           + _chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
                           + _chunk(b'IEND', b''))


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    """Undo the Paeth filter of one row in place (int arrays)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        c = prior[i - bpp] if i >= bpp else 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xff


def _unfilter(data: bytes, H: int, W: int, bpp: int) -> np.ndarray:
    stride = W * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != H * (stride + 1):
        raise ValueError('PNG image data of the wrong length')
    rows = rows.reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(H):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 1:                       # Sub: a running sum a pixel apart
            line = np.cumsum(line.reshape(W, bpp), axis=0).reshape(-1) & 0xff
        elif kind == 2:                     # Up
            line = (line + prior) & 0xff
        elif kind == 3:                     # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((a + prior[i]) >> 1)) & 0xff
        elif kind == 4:                     # Paeth
            _paeth_row(line, prior, bpp)
        elif kind != 0:
            raise ValueError(f'unknown PNG filter type {kind}')
        out[y] = line
        prior = line
    return out


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced PNG (grey, RGB or RGBA) as (H, W, 3) uint8
    RGB: grey repeated, alpha dropped, as PIL's `convert('RGB')` gives it."""
    buf = Path(path).read_bytes()
    if not buf.startswith(PNG_MAGIC):
        raise ValueError(f'{path} is not a PNG file')
    pos, idat, head = len(PNG_MAGIC), [], None
    while pos < len(buf):
        (n,) = struct.unpack('>I', buf[pos:pos + 4])
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            head = struct.unpack('>IIBBBBB', data)
        elif kind == b'IDAT':
            idat.append(data)
        elif kind == b'IEND':
            break
    W, H, depth, color, _, _, interlace = head
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise NotImplementedError(f'{path}: only 8-bit, non-interlaced grey, RGB or RGBA PNG '
                                  f'is read (bit depth {depth}, colour type {color}, '
                                  f'interlace {interlace})')
    px = _unfilter(zlib.decompress(b''.join(idat)), H, W, channels).reshape(H, W, channels)
    if channels == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_image(path) -> np.ndarray:
    """A camera image as (H, W, 3) uint8 RGB. PNG only: a JPEG file (as the
    nuScenes release ships) raises, since decoding it needs PIL, which the
    port does not depend on; convert such images to PNG first."""
    with open(path, 'rb') as f:
        magic = f.read(8)
    if magic == PNG_MAGIC:
        return read_png(path)
    if magic[:3] == b'\xff\xd8\xff':
        raise NotImplementedError(f'{path} is a JPEG file: the port reads PNG camera images '
                                  'only (JPEG decoding needs PIL, which the port does not '
                                  'depend on); convert the images to PNG')
    raise ValueError(f'{path} is not a PNG file')


# ---- PIL's geometry -----------------------------------------------------------------

def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple:
    """PIL's `precompute_coeffs` for the bicubic filter over the whole axis
    and `normalize_coeffs_8bpc`: (first source index (out,), the fixed-point
    weights (out, ksize)); weights past a row's window are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = _bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = k.sum()
        if ww != 0.0:
            k = k / ww
        k = k * (1 << _PRECISION_BITS)
        weights[xx, :xmax] = np.where(k < 0, np.trunc(k - 0.5), np.trunc(k + 0.5))
        first[xx] = xmin
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resampling along `axis` (0 rows, 1 columns)."""
    first, weights = _coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]), img.shape[axis] - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)      # (..., out, ksize, ...)
    if axis == 0:
        acc = np.einsum('okwc,ok->owc', src, weights)
    else:
        acc = np.einsum('hokc,ok->hoc', src, weights)
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple) -> np.ndarray:
    """PIL's `img.resize((w, h))` with its default filter (bicubic) on an
    (H, W, 3) uint8 image."""
    w, h = (int(v) for v in size)
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.copy()
    out = img
    if w != W:
        out = _resample_axis(out, w, 1)
    if h != H:
        out = _resample_axis(out, h, 0)
    return out


def crop(img: np.ndarray, box: tuple) -> np.ndarray:
    """PIL's `img.crop((left, upper, right, lower))`: the box's pixels, zeros
    where the box leaves the image."""
    x0, y0, x1, y1 = (int(v) for v in box)
    H, W = img.shape[:2]
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:], img.dtype)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, W), min(y1, H)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def flip_left_right(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """PIL's `img.rotate(angle)`: counter-clockwise by `angle` degrees about
    (w / 2, h / 2), nearest pixel, the same size, zeros outside. PIL's fast
    paths (0 and 180 degrees, and 90 and 270 on a square image) are exact
    transposes; any other angle maps each output pixel's centre back through
    PIL's inverse matrix in 16.16 fixed point."""
    angle = angle % 360.0
    H, W = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and W == H:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    cx, cy = W / 2, H / 2
    rad = -math.radians(angle)
    a = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    a[2] = a[0] * -cx + a[1] * -cy + a[2] + cx
    a[5] = a[3] * -cx + a[4] * -cy + a[5] + cy

    def fix(v):
        return math.floor(v * 65536.0 + 0.5)

    for x, y in ((0, 0), (W, H), (0, H), (W, 0)):
        if not (abs(x * a[0] + y * a[1] + a[2]) < 32768.0
                and abs(x * a[3] + y * a[4] + a[5]) < 32768.0):
            raise NotImplementedError('an image too large for PIL\'s fixed-point rotation')
    a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
    a2 = fix(a[2] + a[1] * 0.5 + a[0] * 0.5)
    a5 = fix(a[5] + a[4] * 0.5 + a[3] * 0.5)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int64), np.arange(W, dtype=np.int64),
                         indexing='ij')
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    ok = (xin >= 0) & (xin < W) & (yin >= 0) & (yin < H)
    out = np.zeros_like(img)
    out[ok] = img[yin[ok], xin[ok]]
    return out

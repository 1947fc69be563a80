"""Frame files and frame resizing for the host data path, without OpenCV.

The JAX package decodes frames and resizes them with cv2
(``mscl_tpu/datasets/pipelines/loading.py`` ``_imread_rgb``,
``augmentations.py`` ``imresize``). This module gives the same arrays with
the standard library and numpy:

- ``imread_rgb`` reads 8-bit, non-interlaced PNG (grey, RGB, RGBA; the
  alpha dropped and grey repeated into 3 channels, as ``IMREAD_COLOR``
  does): ``zlib`` inflates it and ``csrc/png_unfilter.c``, built with the
  host C compiler, undoes the row filters outside the GIL (numpy does it
  where there is no C compiler: Sub and Up rows fast, Avg and Paeth one
  anti-diagonal of pixels at a time). At ``reduce=2`` it halves it as
  ``IMREAD_REDUCED_COLOR_2`` does for a file that is not JPEG: a full decode,
  then OpenCV's bit-exact linear resize to ``(w // 2, h // 2)``. JPEG goes to
  ``utils/jpeg.py`` (``csrc/jpeg_decode.c``, libjpeg-turbo's arithmetic; at
  ``reduce=2`` in the DCT domain, to ``ceil(w / 2) x ceil(h / 2)``). Every
  other file goes through cv2, imported at the call.
- ``imread_grey`` is ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (the flow
  frames' x and y planes): a grey JPEG's plane and a YCbCr JPEG's Y plane
  (libjpeg's JCS_GRAYSCALE output), a grey PNG's plane, and an RGB or RGBA
  PNG through libpng's ``png_set_rgb_to_gray`` as OpenCV sets it (weights
  0.299 and 0.587 as 9797, 19234 and 3737 over 2^15, truncated; a grey
  pixel kept as it is).
- ``imresize`` with 'bilinear' is ``cv2.resize(..., INTER_LINEAR)``: for
  uint8 the 11-bit fixed-point taps of OpenCV's row pass and the rounding of
  its vectorised column pass (``(((S0 >> 4) * b0) >> 16) + (((S1 >> 4) * b1)
  >> 16) + 2 >> 2``), bit for bit; for float32 the same taps in float32.
  An exact 2x reduction, which OpenCV hands to its area resize, gives the
  same uint8 values by this formula; in float32 it is the area resize's
  mean of 4. OpenCV hands a one- or three-channel float32
  image whose sides are both at least 2 to Intel IPP (ippicv), which
  interpolates otherwise (``_resize_linear_ipp``); so does the port.
- ``rectangle`` is ``cv2.rectangle`` at thickness 1 and ``LINE_8``, clipped
  to the image.
"""
from __future__ import annotations

import ctypes
import zlib
from typing import Optional, Tuple

import numpy as np

from ..ops import cuda_build
from .jpeg import decode_jpeg, decode_jpeg_grey

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples a pixel


def read_image_shape(path) -> Optional[Tuple[int, int]]:
    """(h, w) from a JPEG/PNG header without decoding, or None if the
    format is unrecognized (lets MoCoDecodePlan sample crop boxes before
    the decode)."""
    try:
        with open(path, 'rb') as f:
            head = f.read(26)
            if head[:8] == _PNG_SIGNATURE:
                return (int.from_bytes(head[20:24], 'big'),
                        int.from_bytes(head[16:20], 'big'))
            if head[:2] != b'\xff\xd8':
                return None
            f.seek(2)
            while True:
                byte = f.read(1)
                if not byte:
                    return None
                if byte != b'\xff':
                    continue
                marker = f.read(1)
                while marker == b'\xff':
                    marker = f.read(1)
                if not marker:
                    return None
                m = marker[0]
                if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
                    continue
                seg = f.read(2)
                if len(seg) < 2:
                    return None
                length = int.from_bytes(seg, 'big')
                # SOF0..SOF15 minus DHT/JPG/DAC carry the frame dims
                if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                    data = f.read(5)
                    if len(data) < 5:
                        return None
                    return (int.from_bytes(data[1:3], 'big'),
                            int.from_bytes(data[3:5], 'big'))
                f.seek(length - 2, 1)
    except OSError:
        return None


def _unfilter_rows(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Rows of None, Sub and Up filters: the Sub rows in one cumulative sum
    along x (None and Sub rows need no other row), then the Up rows in
    order, each on the row above it."""
    out = filt.copy()
    sub = types == 1
    if sub.any():
        out[sub] = np.cumsum(filt[sub], axis=1, dtype=np.uint8)
    for r in np.flatnonzero(types == 2):
        if r:
            np.add(filt[r], out[r - 1], out=out[r])
    return out


def _unfilter_wavefront(filt: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Any mix of the five filters, one anti-diagonal of pixels at a time:
    a pixel needs only its left, upper and upper-left neighbours, which
    lie on the two diagonals before it."""
    h, w, bpp = filt.shape
    rec = np.zeros((h + 1, w + 1, bpp), np.int16)   # zero top row, left col
    f16 = filt.astype(np.int16)
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1):min(h, d + 1)]
        x = d - r
        left, up, upleft = rec[r + 1, x], rec[r, x + 1], rec[r, x]
        kind = types[r][:, None]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, upleft))
        pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                         [left, up, (left + up) >> 1, paeth], 0)
        rec[r + 1, x + 1] = (f16[r, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def _unfilter_lib():
    """``csrc/png_unfilter.c`` loaded, or None without a C compiler."""
    lib = cuda_build.load_host('png_unfilter')
    if lib is not None and lib.png_unfilter.argtypes is None:
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int64]
    return lib


def _png_pixels(buf: bytes) -> Optional[np.ndarray]:
    """An 8-bit, non-interlaced grey, RGB or RGBA PNG -> its samples, uint8
    (h, w, 1, 3 or 4); None for any other file."""
    if buf[:8] != _PNG_SIGNATURE:
        return None
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        length = int.from_bytes(buf[pos:pos + 4], 'big')
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b'IHDR':
            header = data
        elif kind == b'IDAT':
            idat.append(data)
        elif kind == b'IEND':
            break
    if header is None or len(header) < 13:
        return None
    w = int.from_bytes(header[0:4], 'big')
    h = int.from_bytes(header[4:8], 'big')
    depth, colour, interlace = header[8], header[9], header[12]
    if depth != 8 or interlace != 0 or colour not in _PNG_CHANNELS:
        return None
    bpp = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b''.join(idat)), np.uint8)
    stride = w * bpp + 1
    if raw.size < h * stride:
        raise ValueError('truncated PNG image data')
    lines = raw[:h * stride].reshape(h, stride)
    types = lines[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f'unknown PNG filter type {types.max()}')
    lib = _unfilter_lib()
    if lib is not None:
        img = np.empty((h, w, bpp), np.uint8)
        err = lib.png_unfilter(lines.ctypes.data, img.ctypes.data, h,
                               w * bpp, bpp)
        if err:
            raise RuntimeError(f'png_unfilter failed ({err})')
    else:
        filt = lines[:, 1:].reshape(h, w, bpp)
        img = (_unfilter_rows(filt, types) if types.max(initial=0) <= 2
               else _unfilter_wavefront(filt, types))
    return img


def decode_png(buf: bytes) -> Optional[np.ndarray]:
    """An 8-bit, non-interlaced grey, RGB or RGBA PNG -> RGB uint8 (h, w, 3);
    None for any other file (the caller hands it to cv2)."""
    img = _png_pixels(buf)
    if img is None:
        return None
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def png_grey(buf: bytes) -> Optional[np.ndarray]:
    """An 8-bit, non-interlaced grey, RGB or RGBA PNG -> grey uint8 (h, w),
    as libpng's ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)`` makes it;
    None for any other file."""
    img = _png_pixels(buf)
    if img is None:
        return None
    if img.shape[2] == 1:
        return img[..., 0]
    r, g, b = (img[..., c].astype(np.int32) for c in range(3))
    grey = (r * 9797 + g * 19234 + b * 3737) >> 15
    return np.where((r == g) & (g == b), r, grey).astype(np.uint8)


def _exact_taps(ssize: int, dsize: int):
    """The bit-exact linear resize's source index and 8.8 fixed-point
    weights (OpenCV ``interpolationLinear``): out-of-range positions take
    the edge pixel at weight 256."""
    scale = 1.0 / (dsize / ssize)
    f = (np.arange(dsize) + 0.5) * scale - 0.5
    i = np.floor(f).astype(np.int64)
    inside = (i >= 0) & (i < ssize - 1) & (ssize > 1)
    w1 = np.where(inside, np.round((f - i) * 256), 0).astype(np.int64)
    i = np.where(inside, i, np.where(i < 0, 0, ssize - 1))
    return i, np.minimum(i + 1, ssize - 1), 256 - w1, w1


def reduce_half(img: np.ndarray) -> np.ndarray:
    """What ``IMREAD_REDUCED_COLOR_2`` makes of a decoded uint8 image that
    is not JPEG: OpenCV's bit-exact linear resize (``INTER_LINEAR_EXACT``)
    to (w // 2, h // 2)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _exact_taps(w, w // 2)
    y0, y1, b0, b1 = _exact_taps(h, h // 2)
    src = img.astype(np.int64)

    def row_pass(rows):
        return rows[:, x0] * a0[:, None] + rows[:, x1] * a1[:, None]

    out = (row_pass(src[y0]) * b0[:, None, None] +
           row_pass(src[y1]) * b1[:, None, None] + (1 << 15)) >> 16
    return np.clip(out, 0, 255).astype(np.uint8)


def _cv2(what):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f'{what} needs OpenCV (cv2): without it the port decodes only '
            f'8-bit non-interlaced grey, RGB and RGBA PNG and resizes only '
            f'uint8 and float32 images bilinearly') from e
    return cv2


def _cv2_imread_rgb(buf: np.ndarray, path, reduce: int) -> np.ndarray:
    """The JAX package's decode (``loading.py`` ``_imread_rgb``)."""
    cv2 = _cv2(path)
    if reduce == 2:
        img = cv2.imdecode(buf, cv2.IMREAD_REDUCED_COLOR_2)
        if img is None:
            raise FileNotFoundError(f'failed to decode image: {path}')
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if hasattr(cv2, 'IMREAD_COLOR_RGB'):
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR_RGB)
        if img is None:
            raise FileNotFoundError(f'failed to decode image: {path}')
        return img
    img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f'failed to decode image: {path}')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def imread_rgb(path, reduce: int = 1) -> np.ndarray:
    """Decode an image file to RGB uint8 (h, w, 3); ``reduce=2`` halves
    it as ``cv2.IMREAD_REDUCED_COLOR_2`` does."""
    buf = np.fromfile(path, np.uint8)
    if buf.size == 0:
        raise FileNotFoundError(f'failed to read image: {path}')
    if buf[:2].tobytes() == b'\xff\xd8':
        return decode_jpeg(buf, reduce, path)
    img = decode_png(buf.tobytes()) if buf[:8].tobytes() == \
        _PNG_SIGNATURE else None
    if img is None:
        return _cv2_imread_rgb(buf, path, reduce)
    return reduce_half(img) if reduce == 2 else img


def imread_grey(path) -> np.ndarray:
    """Decode an image file to grey uint8 (h, w), as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` does."""
    buf = np.fromfile(path, np.uint8)
    if buf.size == 0:
        raise FileNotFoundError(f'failed to read image: {path}')
    if buf[:2].tobytes() == b'\xff\xd8':
        return decode_jpeg_grey(buf, path)
    img = png_grey(buf.tobytes()) if buf[:8].tobytes() == \
        _PNG_SIGNATURE else None
    if img is None:
        cv2 = _cv2(path)
        img = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(f'failed to decode image: {path}')
    return img


def _linear_taps(ssize: int, dsize: int):
    """``cv2.resize`` INTER_LINEAR's source position of each destination
    index: (index, fraction), computed in float32 as OpenCV does."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    return i, (f - i.astype(np.float32)).astype(np.float32)


def _resize_linear(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    if img.dtype != np.uint8 and (h, w) == (2 * new_h, 2 * new_w):
        # OpenCV's fast area resize, which takes an exact 2x reduction
        s = img.reshape((new_h, 2, new_w, 2) + img.shape[2:])
        return (s[:, 0, :, 0] + s[:, 0, :, 1] + s[:, 1, :, 0] +
                s[:, 1, :, 1]) * np.float32(0.25)
    ch = int(np.prod(img.shape[2:], dtype=np.int64))
    xi, fx = _linear_taps(w, new_w)
    edge = (xi < 0) | (xi >= w - 1)                 # the row pass clamps x
    fx = np.where(edge, np.float32(0), fx)
    xi = np.clip(xi, 0, w - 1)
    yi, fy = _linear_taps(h, new_h)                 # the column pass does not
    ys = np.concatenate([np.clip(yi, 0, h - 1), np.clip(yi + 1, 0, h - 1)])
    # one gather of both source rows and both source columns of every tap,
    # on the image as (rows, columns x channels)
    cols = (np.concatenate([xi, np.minimum(xi + 1, w - 1)])[:, None] * ch +
            np.arange(ch)).ravel()
    taps = img.reshape(h, w * ch).take(ys, axis=0).take(cols, axis=1)
    a = np.repeat(np.stack([np.float32(1) - fx, fx]), ch, axis=1)
    b = np.stack([np.float32(1) - fy, fy])[:, :, None]
    n = new_w * ch
    if img.dtype == np.uint8:
        # 11-bit taps; the row pass is exact in int32, the column pass
        # rounds as OpenCV's vectorised code does
        a, b = (np.rint(v * np.float32(2048)).astype(np.int32) for v in (a, b))
        taps = taps.astype(np.int32)
        rows = (taps[:, :n] * a[0] + taps[:, n:] * a[1]) >> 4
        out = (((rows[:new_h] * b[0]) >> 16) +
               ((rows[new_h:] * b[1]) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        rows = taps[:, :n] * a[0] + taps[:, n:] * a[1]
        out = rows[:new_h] * b[0] + rows[new_h:] * b[1]
    return out.reshape((new_h, new_w) + img.shape[2:])


def _resize_linear_ipp(img: np.ndarray, new_w: int, new_h: int
                       ) -> np.ndarray:
    """``cv2.resize(INTER_LINEAR)`` of a one- or three-channel float32 image
    as OpenCV runs it through IPP: the source positions in float64, their
    fractions rounded to float32, rows then columns, each channel's ``a +
    (b - a) * t`` with one rounding (a fused multiply-add; exact in
    float64, then rounded to float32)."""
    def taps(ssize, dsize):
        f = (np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5
        i = np.floor(f).astype(np.int64)
        t = np.where((i < 0) | (i >= ssize - 1), 0.0,
                     (f - i).astype(np.float32).astype(np.float64))
        i = np.clip(i, 0, ssize - 1)
        return i, np.minimum(i + 1, ssize - 1), t

    def lerp(a, b, t):
        return (a + (b - a).astype(np.float32) * t).astype(np.float32)

    x0, x1, fx = taps(img.shape[1], new_w)
    y0, y1, fy = taps(img.shape[0], new_h)
    src = img.reshape(img.shape[:2] + (-1,))
    rows = lerp(src[:, x0], src[:, x1], fx[:, None])
    out = lerp(rows[y0], rows[y1], fy[:, None, None])
    return out.reshape((new_h, new_w) + img.shape[2:])


def imresize(img: np.ndarray, size_wh, interpolation: str = 'bilinear'
             ) -> np.ndarray:
    """``cv2.resize`` to (w, h) (mmcv.imresize semantics). 'bilinear' on
    uint8 or float32 is the port's own; anything else goes through cv2."""
    new_w, new_h = int(size_wh[0]), int(size_wh[1])
    if interpolation == 'bilinear' and img.dtype == np.float32 and \
            img.shape[2:] in ((), (1,), (3,)) and min(img.shape[:2]) >= 2:
        return _resize_linear_ipp(img, new_w, new_h)
    if interpolation == 'bilinear' and img.dtype in (np.uint8, np.float32):
        return _resize_linear(img, new_w, new_h)
    cv2 = _cv2(f'imresize({img.dtype}, {interpolation!r})')
    flags = {'nearest': cv2.INTER_NEAREST, 'bilinear': cv2.INTER_LINEAR,
             'bicubic': cv2.INTER_CUBIC, 'area': cv2.INTER_AREA,
             'lanczos': cv2.INTER_LANCZOS4}
    return cv2.resize(img, (new_w, new_h), interpolation=flags[interpolation])


def rectangle(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, 1, cv2.LINE_8)`` in place: the
    four edges from corner to corner inclusive, clipped to the image."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = (tuple(int(v) for v in p) for p in (pt1, pt2))
    color = np.asarray(color, img.dtype)
    color = color[:img.shape[2]] if img.ndim == 3 else color[0]
    xs = slice(max(min(x1, x2), 0), min(max(x1, x2), w - 1) + 1)
    ys = slice(max(min(y1, y2), 0), min(max(y1, y2), h - 1) + 1)
    for y in {y1, y2}:
        if 0 <= y < h and xs.start < xs.stop:
            img[y, xs] = color
    for x in {x1, x2}:
        if 0 <= x < w and ys.start < ys.stop:
            img[ys, x] = color
    return img

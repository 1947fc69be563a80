"""Baseline JPEG decoding and encoding without OpenCV: ``csrc/jpeg_decode.c``
and ``csrc/jpeg_encode.c``, built with the host C compiler at first use and
called through ctypes (which releases the GIL, so the loader's decode
threads decode side by side).

``decode_jpeg(buf)`` equals ``cv2.imdecode(buf, cv2.IMREAD_COLOR_RGB)``,
``decode_jpeg(buf, reduce=2)`` equals ``cv2.imdecode(buf,
cv2.IMREAD_REDUCED_COLOR_2)`` turned to RGB and ``decode_jpeg_grey(buf)``
equals ``cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE)``, bit for bit, for the files
the decoder takes (sequential Huffman, 8-bit, grey or YCbCr, one scan; the
C file lists them). ``reduce=2`` decodes in the DCT domain, as libjpeg does,
to ``ceil(w / 2) x ceil(h / 2)``. Any other file raises ``ValueError``
naming the file and the reason; there is no decoder in Python.

``encode_jpeg(img, quality)`` writes the bytes of ``cv2.imencode('.jpg',
img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])`` for an RGB uint8
image, and of ``cv2.imencode('.jpg', img)`` for a grey one (baseline, JFIF,
4:2:0, the standard Huffman tables; the C file lists the steps);
``imwrite(path, img)`` takes a BGR image, as ``cv2.imwrite`` does. Without
a C compiler both raise; there is no encoder in Python.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import cuda_build

_ERR = 256


def _lib():
    """``csrc/jpeg_decode.c`` loaded, or None without a C compiler."""
    lib = cuda_build.load_host('jpeg_decode')
    if lib is not None and lib.jpeg_decode.argtypes is None:
        lib.jpeg_dims.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_char_p, ctypes.c_int64]
        lib.jpeg_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_char_p, ctypes.c_int64]
        lib.jpeg_decode_grey.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_char_p,
                                         ctypes.c_int64]
        lib.jpeg_dims.restype = lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode_grey.restype = ctypes.c_int
    return lib


def _encoder():
    """``csrc/jpeg_encode.c`` loaded; raises without a C compiler."""
    lib = cuda_build.load_host('jpeg_encode')
    if lib is None:
        raise RuntimeError(
            'encoding JPEG needs a host C compiler to build '
            'mscl_torch/csrc/jpeg_encode.c (set $CC), and none was found')
    if lib.jpeg_encode.argtypes is None:
        lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_void_p]
        lib.jpeg_encode.restype = ctypes.c_int
    return lib


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """RGB (h, w, 3) or grey (h, w) / (h, w, 1) uint8 -> a JPEG file's
    bytes."""
    lib = _encoder()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f'encode_jpeg takes uint8 grey or RGB images, got '
                         f'{img.dtype} {img.shape}')
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    # room for any block's codes with every byte stuffed, and the markers
    cap = 2048 + 8 * (h + 16) * (w + 16) * channels
    out = np.empty(cap, np.uint8)
    n = ctypes.c_int64(0)
    err = lib.jpeg_encode(img.ctypes.data, h, w, channels, int(quality),
                          out.ctypes.data, cap, ctypes.byref(n))
    if err:
        raise ValueError(f'jpeg_encode failed ({err}) for {img.shape}')
    return out[:n.value].tobytes()


def imwrite(path, img: np.ndarray, quality: int = 95) -> bool:
    """``cv2.imwrite(path, img)`` for a .jpg: a BGR (or grey) uint8 image."""
    img = np.asarray(img)
    rgb = img[..., ::-1] if img.ndim == 3 and img.shape[2] == 3 else img
    with open(path, 'wb') as f:
        f.write(encode_jpeg(rgb, quality))
    return True


def _decode(buf: np.ndarray, reduce: int, name, grey: bool) -> np.ndarray:
    lib = _lib()
    if lib is None:
        raise RuntimeError(
            f'{name}: decoding JPEG needs a host C compiler to build '
            f'mscl_torch/csrc/jpeg_decode.c (set $CC), and none was found')
    buf = np.ascontiguousarray(buf, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    dims = np.zeros(2, np.int32)
    if lib.jpeg_dims(buf.ctypes.data, buf.size, reduce, dims.ctypes.data,
                     err, _ERR):
        raise ValueError(f'{name}: {err.value.decode()}')
    h, w = int(dims[0]), int(dims[1])
    if grey:
        out = np.empty((h, w), np.uint8)
        rc = lib.jpeg_decode_grey(buf.ctypes.data, buf.size, out.ctypes.data,
                                  h, w, err, _ERR)
    else:
        out = np.empty((h, w, 3), np.uint8)
        rc = lib.jpeg_decode(buf.ctypes.data, buf.size, reduce,
                             out.ctypes.data, h, w, err, _ERR)
    if rc:
        raise ValueError(f'{name}: {err.value.decode()}')
    return out


def decode_jpeg(buf: np.ndarray, reduce: int = 1, name='<buffer>'
                ) -> np.ndarray:
    """A JPEG file's bytes (uint8 array) -> RGB uint8 (h, w, 3)."""
    return _decode(buf, reduce, name, grey=False)


def decode_jpeg_grey(buf: np.ndarray, name='<buffer>') -> np.ndarray:
    """A JPEG file's bytes (uint8 array) -> grey uint8 (h, w): a grey
    file's plane, a YCbCr file's Y plane."""
    return _decode(buf, 1, name, grey=True)

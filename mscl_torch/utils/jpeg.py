"""Baseline JPEG decoding without OpenCV: ``csrc/jpeg_decode.c``, built
with the host C compiler at first use and called through ctypes (which
releases the GIL, so the loader's decode threads decode side by side).

``decode_jpeg(buf)`` equals ``cv2.imdecode(buf, cv2.IMREAD_COLOR_RGB)``
and ``decode_jpeg(buf, reduce=2)`` equals ``cv2.imdecode(buf,
cv2.IMREAD_REDUCED_COLOR_2)`` turned to RGB, bit for bit, for the files
the decoder takes (sequential Huffman, 8-bit, grey or YCbCr, one scan; the
C file lists them). ``reduce=2`` decodes in the DCT domain, as libjpeg does,
to ``ceil(w / 2) x ceil(h / 2)``. Any other file raises ``ValueError``
naming the file and the reason; there is no decoder in Python.
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
        lib.jpeg_dims.restype = lib.jpeg_decode.restype = ctypes.c_int
    return lib


def decode_jpeg(buf: np.ndarray, reduce: int = 1, name='<buffer>'
                ) -> np.ndarray:
    """A JPEG file's bytes (uint8 array) -> RGB uint8 (h, w, 3)."""
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
    out = np.empty((h, w, 3), np.uint8)
    if lib.jpeg_decode(buf.ctypes.data, buf.size, reduce, out.ctypes.data,
                       h, w, err, _ERR):
        raise ValueError(f'{name}: {err.value.decode()}')
    return out

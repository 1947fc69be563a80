"""OpenCV's uint8 RGB <-> HSV conversions, without cv2 (``ColorJitter``'s
hue step, which the JAX package runs through ``cv2.cvtColor``).

- ``rgb_to_hsv`` is ``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)``: OpenCV's
  ``RGB2HSV_b``, fixed point with ``hsv_shift`` 12 and its division tables
  (``sdiv`` = round(255 * 2^12 / i), ``hdiv`` = round(180 * 2^12 / (6 i))),
  H in [0, 180).
- ``hsv_to_rgb`` is ``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)``: OpenCV's
  ``HSV2RGB_b``, in float32 on S and V scaled by 1/255, the sector's
  ``1 - s * f`` terms as one fused multiply-add, then x 255. OpenCV takes
  each row 32 pixels at a time in its vector code, which truncates, and
  the rest of the row (its last ``w % 32`` pixels) one at a time, which
  rounds; so does this function, along the second-to-last axis.

Both equal OpenCV 5.0.0's (AVX2 dispatch) on every uint8 input, at every
position in a row.
"""
from __future__ import annotations

import numpy as np

_HSV_SHIFT = 12
_DIV = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIV)]
                       ).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6 * _DIV))]
                       ).astype(np.int32)
# pixels a step of HSV2RGB_b's vector loop (4 vectors of 8 float32 lanes)
_VECTOR = 32
# the tab entries that make B, G and R in each of the six sectors
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> uint8 HSV, H in [0, 180)."""
    rgb = img.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma(a, b, c):
    """float32 a * b + c with one rounding (the product is exact in
    float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (..., 3), H in [0, 180) -> uint8 RGB."""
    one = np.float32(1)
    h = hsv[..., 0].astype(np.float32) * np.float32(6.0 / 180)
    s = hsv[..., 1].astype(np.float32) * np.float32(1 / 255.)
    v = hsv[..., 2].astype(np.float32) * np.float32(1 / 255.)
    h = np.fmod(h, np.float32(6))
    sector = np.floor(h).astype(np.int64)
    f = h - sector.astype(np.float32)
    tab = np.stack([v, v * (one - s), v * _fma(-s, f, one),
                    v * _fma(-s, one - f, one)], axis=-1)
    rgb = np.take_along_axis(tab, _SECTORS[sector], axis=-1)[..., ::-1] * \
        np.float32(255)
    width = hsv.shape[-2] if hsv.ndim > 1 else 1
    vector = np.arange(width) < width // _VECTOR * _VECTOR
    out = np.where(vector[:, None], np.floor(rgb), np.rint(rgb))
    return np.clip(out, 0, 255).astype(np.uint8)

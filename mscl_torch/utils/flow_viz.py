"""Optical-flow colour-wheel visualisation (numpy, host side).

A copy of ``mscl_tpu/utils/flow_viz.py`` ``make_colorwheel``,
``flow_uv_to_colors`` and ``flow_to_image`` (the MDS tool's ``rgb_map``
weight reads it): the Middlebury / Baker et al. flow colour coding of
RAFT's ``flow_viz``. The device version is
``mscl_torch.models.common.ssl_aug.flow_uv_to_colors``; both read this wheel.
"""
from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """55-colour wheel: RY=15, YG=6, GC=4, CB=11, BM=13, MR=6 segments.

    Returns a (55, 3) float array with values in [0, 255].
    """
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[col:col + RY, 0] = 255                                  # red
    wheel[col:col + RY, 1] = np.floor(255 * np.arange(RY) / RY)   # -> yellow
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255                                  # -> green
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)   # -> cyan
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255                                  # -> blue
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)   # -> magenta
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255                                  # -> red
    return wheel


_COLORWHEEL = make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Normalised flow components (|uv| <= 1 expected), (H, W) each ->
    (H, W, 3) uint8. The angle picks a hue on the wheel; the radius scales
    saturation (rad <= 1: white to colour; rad > 1: the colour darkened)."""
    flow_image = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    ncols = _COLORWHEEL.shape[0]
    rad = np.sqrt(np.square(u) + np.square(v))
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0
    for i in range(3):
        tmp = _COLORWHEEL[:, i]
        col0 = tmp[k0] / 255.0
        col1 = tmp[k1] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        ch_idx = 2 - i if convert_to_bgr else i
        flow_image[:, :, ch_idx] = np.floor(255 * col)
    return flow_image


def flow_to_image(flow_uv: np.ndarray, clip_flow=None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """Full flow->image: normalize by max radius, then colorize.

    Args:
        flow_uv: (H, W, 2) float flow.
    Returns:
        (H, W, 3) uint8 image.
    """
    assert flow_uv.ndim == 3 and flow_uv.shape[2] == 2
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u = flow_uv[:, :, 0]
    v = flow_uv[:, :, 1]
    rad = np.sqrt(np.square(u) + np.square(v))
    rad_max = np.max(rad)
    epsilon = 1e-5
    u = u / (rad_max + epsilon)
    v = v / (rad_max + epsilon)
    return flow_uv_to_colors(u, v, convert_to_bgr)

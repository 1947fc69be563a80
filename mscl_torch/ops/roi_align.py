"""RoIAlign with average pooling over a fixed sampling grid.

Port of ``mscl_tpu/ops/roi_align.py`` (plain ``jnp`` there, no Pallas
kernel; plain PyTorch here, gathers and a bilinear blend, on any device).
Each RoI's ``output_size``^2 bins take ``sampling_ratio``^2 points each,
at bin-relative positions (i + 0.5) / sampling_ratio: a fixed grid, not
mmcv's adaptive ceil(roi / output) one. A point's value is the bilinear
blend of its four neighbouring pixels, a pixel outside the map counting
as zero (mmcv clamps to the border instead). With ``aligned`` the box is
shifted by half a pixel and its sides kept at least 1e-6, else at least
1.0.

Layout: features channels-last (N, H, W, C), as the JAX op takes them
(the detector transposes its pooled map once); RoIs (R, 5) as
(batch index, x1, y1, x2, y2) in input pixels. Output (R, output_size,
output_size, C).

Memory: each corner is one gather of R * (output_size * sampling_ratio)^2
rows of C from the flattened map, blended into one accumulator in place
(``addcmul_``), so a call holds the accumulator and one corner's gather
at a time (at AVA's full width, 256 RoIs x 256 points x 2304 channels:
0.6 GB each in float32). The backward is ``index_select``'s: an
``index_add`` of the blended gradients into the map.
"""
from __future__ import annotations

import torch


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    n, h, w, c = features.shape
    s = max(sampling_ratio, 1)
    offset = 0.5 if aligned else 0.0
    r = rois.shape[0]
    batch = rois[:, 0].to(torch.int64)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    low = 1e-6 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=low) / output_size
    bin_h = torch.clamp(y2 - y1, min=low) / output_size
    grid = torch.arange(output_size * s, dtype=rois.dtype,
                        device=rois.device) + 0.5
    gx = x1[:, None] + grid[None] * (bin_w / s)[:, None]       # (R, P)
    gy = y1[:, None] + grid[None] * (bin_h / s)[:, None]
    p = grid.shape[0]
    xs = gx[:, None, :].expand(r, p, p)                        # (R, Py, Px)
    ys = gy[:, :, None].expand(r, p, p)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    wx, wy = xs - x0, ys - y0
    flat = features.reshape(n * h * w, c)
    base = (batch * (h * w))[:, None, None]
    acc = None
    for dx, dy, wgt in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                        (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        ix, iy = x0 + dx, y0 + dy
        valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        idx = base + iy.clamp(0, h - 1).to(torch.int64) * w + \
            ix.clamp(0, w - 1).to(torch.int64)
        wgt = (wgt * valid).to(features.dtype).reshape(-1, 1)
        rows = flat.index_select(0, idx.reshape(-1))
        if acc is None:
            acc = rows * wgt
        else:
            acc = acc.addcmul_(rows, wgt)
        del rows
    return acc.reshape(r, output_size, s, output_size, s, c).mean(dim=(2, 4))

"""MotionMapCalculator: motion-edge maps of a raw flow, on the device.

Port of ``mscl_tpu/models/common/motion_map.py``: Sobel x and y on u and v,
the gradient magnitude, a (7, 7) max or average pool with 'SAME' padding
(as ``lax.reduce_window`` pads: the odd pixel after, -inf for max, zeros
for the average, which always divides by k*k), a nearest upsample back to
the input size (source row (i*ph)//h), normalised by each map's max plus
eps. NCTHW: (B, 2, T, H, W) flow -> (B, 1, T, H, W) map. float32 flows
only, as in the JAX package (its float32 Sobel kernels refuse another
dtype in ``lax.conv``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _sobel(device):
    """Sobel x and y kernels, (3, 3) each, built on the device (no host
    copy): x = [1, 2, 1]^T [-1, 0, 1]."""
    ramp = torch.arange(3, device=device, dtype=torch.float32) - 1
    smooth = 2 - ramp.abs()                                     # 1, 2, 1
    sx = smooth[:, None] * ramp[None, :]
    return sx, sx.T


def _same_pad(size, k):
    """'SAME' padding of a window k, stride k: (before, after)."""
    out = -(-size // k)
    total = max((out - 1) * k + k - size, 0)
    return total // 2, total - total // 2


class MotionMapCalculator:

    def __init__(self, pool='max', kernel_size=7, eps=1e-6):
        assert pool in ('max', 'avg')
        self.pool = pool
        self.kernel_size = kernel_size
        self.eps = eps

    def __call__(self, flows: torch.Tensor) -> torch.Tensor:
        if flows.dtype != torch.float32:
            raise TypeError(f'MotionMapCalculator: float32 flows only, got '
                            f'{flows.dtype}')
        b, c, t, h, w = flows.shape
        x = flows.transpose(1, 2).reshape(b * t, c, h, w)
        sx, sy = _sobel(flows.device)
        gx = F.conv2d(x, sx.expand(c, 1, 3, 3).contiguous(), padding=1,
                      groups=c)
        gy = F.conv2d(x, sy.expand(c, 1, 3, 3).contiguous(), padding=1,
                      groups=c)
        mag = torch.sqrt((gx ** 2 + gy ** 2).sum(1, keepdim=True))
        k = self.kernel_size
        (top, bottom), (left, right) = _same_pad(h, k), _same_pad(w, k)
        pad = (left, right, top, bottom)
        if self.pool == 'max':
            pooled = F.max_pool2d(F.pad(mag, pad, value=-float('inf')), k)
        else:
            pooled = F.avg_pool2d(F.pad(mag, pad), k)
        ph, pw = pooled.shape[2:]
        ih = torch.clamp(torch.arange(h, device=flows.device) * ph // h,
                         0, ph - 1)
        iw = torch.clamp(torch.arange(w, device=flows.device) * pw // w,
                         0, pw - 1)
        up = pooled.index_select(2, ih).index_select(3, iw)
        up = up / (up.amax(dim=(1, 2, 3), keepdim=True) + self.eps)
        return up.reshape(b, t, 1, h, w).transpose(1, 2)

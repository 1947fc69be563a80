"""PWC-Lite (ARFlow), the lightweight unsupervised flow network (port of
``mscl_tpu/flow/pwclite.py``), as NCHW nn.Modules.

- ``FeatureExtractor``: 6 stride-2 levels of 16/32/64/96/128/192 channels,
  returned coarsest first.
- ``cost_volume``: the 81 (2r + 1)^2 shifted channel-mean products of a
  +-r window, dy-major, f2 zero-padded by r.
- ``flow_warp``: a bilinear gather at the clamped sample position (border
  padding, align_corners), with the JAX formula: clamp, floor, four taps
  whose indices are clipped. ``F.grid_sample`` rounds the border another
  way, so it is not used.
- ``FlowEstimatorDense`` / ``FlowEstimatorReduce``, ``ContextNetwork``
  (dilations 1, 2, 4, 8, 16, 1), coarse to fine over 5 levels with x2
  align-corners upsampling of the flow.
- 2-frame (``with_bk`` adds the backward pass) and 3-frame (forward and
  backward fused) modes; ``n_frames`` at construction sizes the flow
  estimator's input.

Modules carry the flax names (``extractor.level{i}_conv{1,2}.conv``,
``flow_estimator.conv{k}`` / ``predict_flow`` / ``conv_last``,
``context_net.conv{k}`` / ``conv_out``, ``conv_1x1_{i}``), so
``convert.pwclite_jax_to_state_dict`` carries JAX variables over. Flows come
out NCHW, (N, 2, H, W) as (u, v). Every op is a cuDNN convolution or plain
torch: the JAX package runs no Pallas kernel here either.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


class ConvLReLU(nn.Module):
    """Conv with symmetric padding ((k - 1) * d) // 2, bias, LeakyReLU 0.1."""

    def __init__(self, cin, cout, kernel=3, stride=1, dilation=1, relu=True):
        super().__init__()
        pad = ((kernel - 1) * dilation) // 2
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, dilation)
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        return F.leaky_relu(x, 0.1) if self.relu else x


class FeatureExtractor(nn.Module):

    def __init__(self, num_chs: Sequence[int] = (3, 16, 32, 64, 96, 128,
                                                 192)):
        super().__init__()
        self.num_levels = len(num_chs) - 1
        for i, (cin, ch) in enumerate(zip(num_chs[:-1], num_chs[1:])):
            setattr(self, f'level{i}_conv1', ConvLReLU(cin, ch, stride=2))
            setattr(self, f'level{i}_conv2', ConvLReLU(ch, ch))

    def forward(self, x):
        pyramid = []
        for i in range(self.num_levels):
            x = getattr(self, f'level{i}_conv1')(x)
            x = getattr(self, f'level{i}_conv2')(x)
            pyramid.append(x)
        return pyramid[::-1]


def cost_volume(x1: torch.Tensor, x2: torch.Tensor, radius: int = 4
                ) -> torch.Tensor:
    """(N, C, H, W) x2 -> (N, (2r+1)^2, H, W) channel-mean correlation,
    row-major (dy, dx) order."""
    h, w = x1.shape[2:]
    r = radius
    x2p = F.pad(x2, (r, r, r, r))
    return torch.stack([(x1 * x2p[:, :, dy:dy + h, dx:dx + w]).mean(1)
                        for dy in range(2 * r + 1)
                        for dx in range(2 * r + 1)], dim=1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x (N, C, H, W) by flow (N, 2, H, W) as (u, v), border padding."""
    n, c, h, w = x.shape
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)[None]
    cx = torch.clamp(xs + flow[:, 0], 0, w - 1)
    cy = torch.clamp(ys + flow[:, 1], 0, h - 1)
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = (cx - x0)[:, None]
    fy = (cy - y0)[:, None]
    flat = x.reshape(n, c, h * w)

    def gather(ix, iy):
        ix = torch.clamp(ix, 0, w - 1).long()
        iy = torch.clamp(iy, 0, h - 1).long()
        idx = (iy * w + ix).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(x.shape)

    return (gather(x0, y0) * (1 - fx) * (1 - fy) +
            gather(x0 + 1, y0) * fx * (1 - fy) +
            gather(x0, y0 + 1) * (1 - fx) * fy +
            gather(x0 + 1, y0 + 1) * fx * fy)


def _resize_align(x: torch.Tensor, ho: int, wo: int) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with align_corners=True semantics;
    the source positions in float32, as the JAX function computes them."""
    h, w = x.shape[2:]
    sy = np.float32((h - 1) / max(ho - 1, 1))
    sx = np.float32((w - 1) / max(wo - 1, 1))
    ys = torch.arange(ho, dtype=torch.float32, device=x.device) * float(sy)
    xs = torch.arange(wo, dtype=torch.float32, device=x.device) * float(sx)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None]
    top, bottom = x[:, :, y0], x[:, :, y1]
    return (top[..., x0] * (1 - fy) * (1 - fx) +
            top[..., x1] * (1 - fy) * fx +
            bottom[..., x0] * fy * (1 - fx) + bottom[..., x1] * fy * fx)


def upsample2x_align(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample with align_corners=True semantics."""
    return _resize_align(x, 2 * x.shape[2], 2 * x.shape[3])


class FlowEstimatorDense(nn.Module):
    """DenseNet-style: each conv's output is put in front of its input;
    returns (ch_in + 448 features, flow)."""

    def __init__(self, ch_in):
        super().__init__()
        for i, ch in enumerate((128, 128, 96, 64, 32)):
            setattr(self, f'conv{i + 1}', ConvLReLU(ch_in, ch))
            ch_in += ch
        self.conv_last = ConvLReLU(ch_in, 2, relu=False)
        self.feat_dim = ch_in

    def forward(self, x):
        for i in range(5):
            x = torch.cat([getattr(self, f'conv{i + 1}')(x), x], dim=1)
        return x, self.conv_last(x)


class FlowEstimatorReduce(nn.Module):
    """Each conv sees the two before it; returns (32 features, flow)."""

    def __init__(self, ch_in):
        super().__init__()
        self.conv1 = ConvLReLU(ch_in, 128)
        self.conv2 = ConvLReLU(128, 128)
        self.conv3 = ConvLReLU(128 + 128, 96)
        self.conv4 = ConvLReLU(128 + 96, 64)
        self.conv5 = ConvLReLU(96 + 64, 32)
        self.predict_flow = ConvLReLU(64 + 32, 2, relu=False)
        self.feat_dim = 32

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(torch.cat([x1, x2], dim=1))
        x4 = self.conv4(torch.cat([x2, x3], dim=1))
        x5 = self.conv5(torch.cat([x3, x4], dim=1))
        return x5, self.predict_flow(torch.cat([x4, x5], dim=1))


class ContextNetwork(nn.Module):

    def __init__(self, ch_in):
        super().__init__()
        for i, (ch, dil) in enumerate(((128, 1), (128, 2), (128, 4),
                                       (96, 8), (64, 16), (32, 1))):
            setattr(self, f'conv{i + 1}', ConvLReLU(ch_in, ch, dilation=dil))
            ch_in = ch
        self.conv_out = ConvLReLU(ch_in, 2, relu=False)

    def forward(self, x):
        for i in range(6):
            x = getattr(self, f'conv{i + 1}')(x)
        return self.conv_out(x)


class PWCLite(nn.Module):
    """Input (N, n_frames * 3, H, W) NCHW or (N, n_frames, H, W, 3); H and W
    multiples of 64. Returns ``flows_fw`` (and ``flows_bw`` with ``with_bk``
    or 3 frames): a list of (N, 2, h, w) flows, finest first."""

    def __init__(self, n_frames: int = 2, reduce_dense: bool = True,
                 upsample: bool = True, search_range: int = 4,
                 output_level: int = 4):
        super().__init__()
        if n_frames not in (2, 3):
            raise NotImplementedError(f'n_frames={n_frames}')
        self.n_frames = n_frames
        self.upsample = upsample
        self.search_range = search_range
        self.output_level = output_level
        self.extractor = FeatureExtractor()
        corr = (2 * search_range + 1) ** 2
        ch_in = 32 + corr + 2 if n_frames == 2 else 32 + 2 * corr + 4
        est = FlowEstimatorReduce if reduce_dense else FlowEstimatorDense
        self.flow_estimator = est(ch_in)
        feat = self.flow_estimator.feat_dim
        self.context_net = ContextNetwork(
            feat + 2 if n_frames == 2 else 2 * feat + 4)
        chs = (192, 128, 96, 64, 32)
        for i in range(5):
            setattr(self, f'conv_1x1_{i}', ConvLReLU(chs[i], 32, kernel=1))

    def init_weights(self, gen: torch.Generator):
        """The JAX init, drawn from ``gen``: variance-scaling (2, fan_out,
        normal) kernels, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                     generator=gen)
                    m.bias.zero_()

    def _upsampled(self, flows):
        if self.upsample:
            flows = [_resize_align(f * 4.0, f.shape[2] * 4, f.shape[3] * 4)
                     for f in flows]
        return flows[::-1]

    def _two_frames(self, p1, p2):
        flows = []
        x = p1[0]
        flow = x.new_zeros((x.shape[0], 2) + x.shape[2:])
        for level, (x1, x2) in enumerate(zip(p1, p2)):
            if level > 0:
                flow = upsample2x_align(flow * 2.0)
                x2 = flow_warp(x2, flow)
            corr = F.leaky_relu(cost_volume(x1, x2, self.search_range), 0.1)
            x1_1by1 = getattr(self, f'conv_1x1_{level}')(x1)
            x_intm, flow_res = self.flow_estimator(
                torch.cat([corr, x1_1by1, flow], dim=1))
            flow = flow + flow_res
            flow = flow + self.context_net(torch.cat([x_intm, flow], dim=1))
            flows.append(flow)
            if level == self.output_level:
                break
        return self._upsampled(flows)

    def _three_frames(self, p0, p1, p2):
        flows = []
        x = p1[0]
        flow = x.new_zeros((x.shape[0], 4) + x.shape[2:])
        for level, (x0, x1, x2) in enumerate(zip(p0, p1, p2)):
            if level > 0:
                flow = upsample2x_align(flow * 2.0)
                x0 = flow_warp(x0, flow[:, :2])
                x2 = flow_warp(x2, flow[:, 2:])
            c10 = F.leaky_relu(cost_volume(x1, x0, self.search_range), 0.1)
            c12 = F.leaky_relu(cost_volume(x1, x2, self.search_range), 0.1)
            x1_1by1 = getattr(self, f'conv_1x1_{level}')(x1)
            fw, bw = flow[:, :2], flow[:, 2:]
            i10, r10 = self.flow_estimator(
                torch.cat([x1_1by1, c10, c12, fw, -bw], dim=1))
            i12, r12 = self.flow_estimator(
                torch.cat([x1_1by1, c12, c10, bw, -fw], dim=1))
            flow = flow + torch.cat([r10, r12], dim=1)
            fw, bw = flow[:, :2], flow[:, 2:]
            g10 = self.context_net(torch.cat([i10, i12, fw, -bw], dim=1))
            g12 = self.context_net(torch.cat([i12, i10, bw, -fw], dim=1))
            flow = flow + torch.cat([g10, g12], dim=1)
            flows.append(flow)
            if level == self.output_level:
                break
        flows = self._upsampled(flows)
        return [f[:, :2] for f in flows], [f[:, 2:] for f in flows]

    def forward(self, x, with_bk: bool = False):
        if x.dim() == 4:      # (N, n * 3, H, W) NCHW, the reference layout
            imgs = list(x.split(3, dim=1))
        else:                 # (N, n, H, W, 3)
            imgs = [x[:, i].permute(0, 3, 1, 2) for i in range(x.shape[1])]
        pyramids = [self.extractor(im) for im in imgs]
        if len(imgs) == 2:
            res = dict(flows_fw=self._two_frames(*pyramids))
            if with_bk:
                res['flows_bw'] = self._two_frames(pyramids[1], pyramids[0])
            return res
        if len(imgs) == 3:
            flows_10, flows_12 = self._three_frames(*pyramids)
            return dict(flows_fw=flows_12, flows_bw=flows_10)
        raise NotImplementedError(f'n_frames={len(imgs)}')


def build_pwclite(device=None, seed: int = 0, **kwargs) -> PWCLite:
    """PWC-Lite on ``device`` (None: the card), eval mode, float32 with TF32
    off for cuDNN convolutions, from the JAX init drawn with ``seed``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = PWCLite(**kwargs)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

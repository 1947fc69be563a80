"""TANet: ResNet with a Temporal Adaptive Module in every block (NCHW
frames).

Port of ``mscl_tpu/models/backbones/tanet.py`` (reference mmaction
tanet.py and its TAM). Each block's conv1 output goes through a TAM before
conv2; the identity is the block's input.

``TAM`` over (N * T, C, H, W), from the spatial mean theta (N, T, C):

- global branch: each (video, channel)'s T means through ``g_fc1`` (T ->
  alpha T, no bias), BN ``g_bn``, ReLU, ``g_fc2`` (-> the kernel size K, no
  bias) and a softmax: a K-tap temporal kernel per video and channel;
- local branch: ``l_conv1`` (conv1d C -> C / beta, 3 wide, no bias), BN
  ``l_bn``, ReLU, ``l_conv2`` (1 wide, -> C, no bias), a sigmoid: a weight
  per frame and channel, which scales the input;
- the scaled input convolved over T with each channel's own kernel, zero
  padded.

The JAX TANet accepts ``tam_cfg`` and builds every TAM with its defaults
(alpha 2, K 3, beta 4); so does the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import BACKBONES
from .resnet2d import BasicBlock2d, Bottleneck2d, ResNet
from .resnet_tin import _flax_default_init
from .video_resnet import make_bn


class TAM(nn.Module):

    def __init__(self, channels: int, num_segments: int = 8, alpha: int = 2,
                 adaptive_kernel_size: int = 3, beta: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        t, self.k, self.dtype = num_segments, adaptive_kernel_size, dtype
        self.num_segments = num_segments
        self.g_fc1 = nn.Linear(t, t * alpha, bias=False)
        self.g_bn = make_bn(t * alpha, dtype)
        self.g_fc2 = nn.Linear(t * alpha, adaptive_kernel_size, bias=False)
        self.l_conv1 = nn.Conv1d(channels, channels // beta, 3, padding=1,
                                 bias=False)
        self.l_bn = make_bn(channels // beta, dtype)
        self.l_conv2 = nn.Conv1d(channels // beta, channels, 1, bias=False)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        _flax_default_init(self, gen)

    def forward(self, x):
        nt, c, h, w = x.shape
        t = self.num_segments
        n = nt // t
        xt = x.reshape(n, t, c, h, w)
        theta = xt.mean(dim=(3, 4)).transpose(1, 2)                # (N, C, T)

        g = compute_dtype.linear(self.g_fc1, theta.reshape(n * c, t),
                                 self.dtype)
        g = compute_dtype.linear(self.g_fc2, F.relu(self.g_bn(g)),
                                 self.dtype)
        kernel = g.softmax(dim=-1)                                 # (N*C, K)

        l = F.relu(self.l_bn(compute_dtype.conv(self.l_conv1, theta,
                                                self.dtype)))
        attn = torch.sigmoid(compute_dtype.conv(self.l_conv2, l,
                                                self.dtype))       # (N, C, T)
        xt = xt * attn.transpose(1, 2)[..., None, None]

        pad = self.k // 2
        seq = xt.transpose(1, 2).reshape(n * c, t, h * w)
        seq = F.pad(seq, (0, 0, pad, pad))
        out = 0
        for i in range(self.k):
            out = out + kernel[:, i, None, None] * seq[:, i:i + t]
        return out.reshape(n, c, t, h, w).transpose(1, 2).reshape(nt, c, h, w)


class _Adaptive:
    """A residual block with a TAM between conv1 and conv2."""

    def residual(self, x):
        y = self.conv2(self.tam(self.conv1(x)))
        return self.conv3(y) if hasattr(self, 'conv3') else y


class TABasicBlock(_Adaptive, BasicBlock2d):
    pass


class TABottleneck(_Adaptive, Bottleneck2d):
    pass


@BACKBONES.register_module()
class TANet(ResNet):

    def __init__(self, depth: int = 50, num_segments: int = 8,
                 pretrained=None, tam_cfg=None, dtype=None):
        super().__init__(depth=depth, num_segments=num_segments, dtype=dtype)

    @staticmethod
    def block_maker(block_type, shift, shift_div, dtype):
        block_cls = TABasicBlock if block_type == 'basic' else TABottleneck

        def make(cin, planes, stride, downsample, segs):
            block = block_cls(cin, planes, stride, downsample, dtype=dtype)
            block.tam = TAM(planes, segs, dtype=dtype)
            return block
        return make

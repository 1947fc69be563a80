"""RAFT optical flow (port of ``mscl_tpu/flow/raft.py``) as NCHW nn.Modules.

Modules and parameters carry the names of the official RAFT state_dict
(``fnet.layer1.0.conv1``, ``cnet.layer2.0.downsample.0``/``.1`` beside
``norm3``, ``update_block.encoder.convc1``, ``update_block.gru.convz1``,
``update_block.flow_head.conv1``, ``update_block.mask.0``/``.2``), so
``load_raft_pth`` loads ``raft-things.pth`` strictly and
``convert.raft_jax_to_state_dict`` carries the JAX variables over.

Inference only, as the flow extraction uses it: the model is built in eval
mode, so cnet's batch norm uses its running statistics (JAX ``train=False``).

The correlation lookup is ``ops.corr_lookup``, the hand-written kernel on
the card: the pooled f2 pyramid is built once per forward and looked up every
iteration, and the all-pairs volume is never materialised.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.corr_lookup import corr_lookup, corr_pyramid
from ..utils.device import resolve_device


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d(affine=False) over NCHW: biased variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    """No parameters, as the official ``nn.InstanceNorm2d(planes)``."""

    def forward(self, x):
        return instance_norm(x)


def make_norm(norm_fn: str, planes: int, num_groups: int = 8) -> nn.Module:
    """The norm choice of the JAX ``_Norm`` (flax's epsilons)."""
    if norm_fn == 'instance':
        return InstanceNorm()
    if norm_fn == 'batch':
        return nn.BatchNorm2d(planes, eps=1e-5)
    if norm_fn == 'group':
        return nn.GroupNorm(num_groups, planes, eps=1e-6)
    if norm_fn == 'none':
        return nn.Identity()
    raise ValueError(norm_fn)


class ResidualBlock(nn.Module):

    def __init__(self, in_planes, planes, norm_fn='instance', stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # one module under both names, as in the official state_dict
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7x7 stride-2 stem, three stages of two residual blocks (64, 96, 128;
    stride 1, 2, 2), 1x1 output conv: features at 1/8 resolution."""

    def __init__(self, output_dim=128, norm_fn='batch'):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3)
        self.norm1 = make_norm(norm_fn, 64)
        self.layer1 = self._stage(64, 64, norm_fn, 1)
        self.layer2 = self._stage(64, 96, norm_fn, 2)
        self.layer3 = self._stage(96, 128, norm_fn, 2)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    @staticmethod
    def _stage(cin, dim, norm_fn, stride):
        return nn.Sequential(ResidualBlock(cin, dim, norm_fn, stride),
                             ResidualBlock(dim, dim, norm_fn, 1))

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


# ---------------------------------------------------------- update block
class FlowHead(nn.Module):

    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """A horizontal (1x5) then a vertical (5x1) convolutional GRU."""

    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, kernel, pad in (('1', (1, 5), (0, 2)),
                                    ('2', (5, 1), (2, 0))):
            for gate in 'zrq':
                setattr(self, f'conv{gate}{suffix}',
                        nn.Conv2d(cin, hidden_dim, kernel, padding=pad))

    def _gru(self, h, x, suffix):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f'convz{suffix}')(hx))
        r = torch.sigmoid(getattr(self, f'convr{suffix}')(hx))
        q = torch.tanh(getattr(self, f'convq{suffix}')(
            torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._gru(self._gru(h, x, '1'), x, '2')


class BasicMotionEncoder(nn.Module):

    def __init__(self, corr_levels=4, corr_radius=4):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):

    def __init__(self, hidden_dim=128, corr_levels=4, corr_radius=4):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def coords_grid(n: int, h: int, w: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """(n, 2, h, w) pixel coords, channel 0 = x, 1 = y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing='ij')
    return torch.stack([xs, ys])[None].repeat(n, 1, 1, 1)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor
                         ) -> torch.Tensor:
    """Convex 8x upsampling: flow (N, 2, H, W), mask (N, 64*9, H, W) ->
    (N, 2, 8H, 8W); each fine pixel is a softmax-weighted mix of the 3x3
    coarse neighbourhood of 8*flow."""
    n, _, h, w = flow.shape
    mask = mask.view(n, 1, 9, 8, 8, h, w).softmax(dim=2)
    neigh = F.unfold(8 * flow, [3, 3], padding=1).view(n, 2, 9, 1, 1, h, w)
    up = (mask * neigh).sum(dim=2)                  # (N, 2, 8, 8, H, W)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """RAFT (large): images (N, 3, H, W) in [0, 255], H and W multiples of
    8 -> (flow_low (N, 2, H/8, W/8), flow_up (N, 2, H, W))."""

    def __init__(self, hidden_dim=128, context_dim=128, corr_levels=4,
                 corr_radius=4, iters=12):
        super().__init__()
        self.hidden_dim, self.context_dim = hidden_dim, context_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.iters = iters
        self.fnet = BasicEncoder(256, 'instance')
        self.cnet = BasicEncoder(hidden_dim + context_dim, 'batch')
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels,
                                             corr_radius)
        self.eval()

    def init_weights(self, gen: torch.Generator):
        """The JAX init, drawn from ``gen``: encoder convs variance-scaling
        (2, fan_out, normal), the update block's lecun-normal (truncated),
        biases 0, BN 1/0 with statistics 0/1."""
        with torch.no_grad():
            for enc in (self.fnet, self.cnet):
                for m in enc.modules():
                    if isinstance(m, nn.Conv2d):
                        nn.init.kaiming_normal_(m.weight, mode='fan_out',
                                                nonlinearity='relu',
                                                generator=gen)
                    elif isinstance(m, nn.BatchNorm2d):
                        m.reset_parameters()
            for m in self.update_block.modules():
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / .87962566103423978
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                          b=2 * std, generator=gen)
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.bias.zero_()

    def forward(self, image1, image2, iters: Optional[int] = None):
        iters = iters or self.iters
        image1 = 2 * (image1 / 255.0) - 1.0
        image2 = 2 * (image2 / 255.0) - 1.0
        n = image1.shape[0]
        both = self.fnet(torch.cat([image1, image2], dim=0))
        fmap1 = both[:n].permute(0, 2, 3, 1).contiguous()      # NHWC
        fmap2 = both[n:].permute(0, 2, 3, 1).contiguous()
        pyramid = corr_pyramid(fmap2, self.corr_levels)
        cnet = self.cnet(image1)
        net, inp = torch.split(cnet, [self.hidden_dim, self.context_dim],
                               dim=1)
        net, inp = torch.tanh(net), F.relu(inp)

        h8, w8 = fmap1.shape[1], fmap1.shape[2]
        coords0 = coords_grid(n, h8, w8, fmap1.device, fmap1.dtype)
        coords1 = coords0.clone()
        up_mask = None
        for _ in range(iters):
            coords1 = coords1.detach()
            corr = corr_lookup(fmap1, pyramid,
                               coords1.permute(0, 2, 3, 1).contiguous(),
                               self.corr_levels, self.corr_radius)
            corr = corr.permute(0, 3, 1, 2).contiguous()
            net, up_mask, delta_flow = self.update_block(
                net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta_flow
        flow = coords1 - coords0
        return flow, upsample_flow_convex(flow, up_mask)


def load_raft_pth(model: RAFT, path: str) -> RAFT:
    """Load an official RAFT checkpoint (``raft-things.pth`` etc.): strip
    the ``module.`` of DataParallel and load strictly."""
    sd = torch.load(path, map_location='cpu')
    model.load_state_dict({k.removeprefix('module.'): v
                           for k, v in sd.items()}, strict=True)
    return model


def build_raft(weights: Optional[str] = None, device=None, seed: int = 0,
               **kwargs) -> RAFT:
    """RAFT on ``device`` (None: the card), eval mode, float32 with TF32
    off for matmuls and cuDNN convolutions; from ``weights`` (an official
    .pth) or, without them, from the JAX init drawn with ``seed``."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = RAFT(**kwargs)
    if weights:
        load_raft_pth(model, weights)
    else:
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

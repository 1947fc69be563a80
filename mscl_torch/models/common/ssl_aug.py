"""Device augmentation of the SSL step, in plain PyTorch tensor ops.

Port of ``mscl_tpu/models/common/ssl_aug.py``: the colour-wheel flow
visualiser, colour jitter, grayscale, gaussian blur, normalize and flip of
whole clips, and the augmentation classes built from them
(``SyncMoCoAugmentV5`` is the flagship's). The formulas are the JAX
package's, not torchvision's or kornia's. Clips are NCTHW, so the channel
axis is 1 (the JAX package's is -1 of NTHWC).

Each stochastic op is split in two: ``draw_*(gen, ...)`` draws its
parameters from a ``torch.Generator`` with the shapes, ranges and
probabilities of the JAX draws, and a deterministic apply takes them. An
augmentation class does the same with ``draw(gen, ...)`` and ``apply(...,
params)``; calling it does both. Draws are float32 and stay on the clip's
device, and nothing here reads a value back to the host, so an augmentation
never synchronises the host with the card.

dtype follows the JAX code: the jitter factors, the blur kernel and the
normalize constants are cast to the clip's dtype before use, the contrast
mean accumulates in float32, and the colour wheel computes in float32 and
writes the flow's dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..builder import SSL_AUGS
from ...utils.flow_viz import make_colorwheel
from .motion_map import MotionMapCalculator

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)

NCOLS = make_colorwheel().shape[0]           # 55
# wheel segment boundaries: RY=15, YG=6, GC=4, CB=11, BM=13, MR=6
_SEG_STARTS = (0, 15, 21, 25, 36, 49, 55)


@functools.lru_cache(maxsize=None)
def _channel_const(values: Tuple[float, ...], dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """(1, C, 1, 1, 1) constant, each value rounded to float32 and then to
    dtype as the JAX package's numpy constants are. It is made by fills on
    the device: a copy from the host would synchronise it. Made outside
    inference mode, so that autograd may save it later."""
    with torch.inference_mode(False), torch.no_grad():
        vals = [torch.full((), float(np.float32(v)), dtype=dtype,
                           device=device) for v in values]
        return torch.stack(vals).reshape(1, len(values), 1, 1, 1)


def _per_clip(x: torch.Tensor, ndim: int = 5) -> torch.Tensor:
    """(B,) -> (B, 1, ...) broadcastable over an ndim-D tensor."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


# ------------------------------------------------------------- flow viz
def _wheel_channels(k: torch.Tensor):
    """The 55-entry wheel at integer index k, as (r, g, b) in [0, 255]:
    floor-quantized ramps by a branchless select cascade, in float32."""
    k = k.float()

    def ramp(start, length):
        return torch.floor(255.0 * (k - start) / length)

    s = _SEG_STARTS
    r = torch.where(k < s[1], 255.0,
        torch.where(k < s[2], 255.0 - ramp(s[1], 6),
        torch.where(k < s[4], 0.0,
        torch.where(k < s[5], ramp(s[4], 13), 255.0))))
    g = torch.where(k < s[1], ramp(s[0], 15),
        torch.where(k < s[3], 255.0,
        torch.where(k < s[4], 255.0 - ramp(s[3], 11), 0.0)))
    b = torch.where(k < s[2], 0.0,
        torch.where(k < s[3], ramp(s[2], 4),
        torch.where(k < s[5], 255.0, 255.0 - ramp(s[5], 6))))
    return r, g, b


def flow_uv_to_colors(u: torch.Tensor, v: torch.Tensor,
                      convert_to_bgr: bool = False, div255: bool = True,
                      out_dtype: Optional[torch.dtype] = None,
                      dim: int = -1) -> torch.Tensor:
    """Flow components of one shape -> colour image with its 3 channels
    stacked at ``dim``; the host wheel's (``utils/flow_viz.py``) values."""
    rad = torch.sqrt(torch.square(u) + torch.square(v))
    # pi rounded to the flow's dtype first, as JAX rounds a python scalar
    pi = float(torch.tensor(math.pi, dtype=u.dtype))
    a = torch.atan2(-v, -u) / pi
    fk = (a + 1) / 2 * (NCOLS - 1)
    k0 = torch.floor(fk)
    k1 = torch.where(k0 + 1 == NCOLS, 0, k0 + 1)
    f = fk - k0
    inside = rad <= 1
    chans = []
    for c0, c1 in zip(_wheel_channels(k0), _wheel_channels(k1)):
        col = (1 - f) * (c0 / 255.0) + f * (c1 / 255.0)
        col = torch.where(inside, 1 - rad * (1 - col), col * 0.75)
        ch = torch.floor(255 * col)
        if div255:
            ch = ch / 255.0
        if out_dtype is not None:
            ch = ch.to(out_dtype)
        chans.append(ch)
    if convert_to_bgr:
        chans = chans[::-1]
    return torch.stack(chans, dim=dim)


class FlowVisualizer:
    """(B, 2, T, H, W) raw flow -> (B, 3, T, H, W) colour in [0, 1], in the
    flow's dtype (the wheel itself computes in float32)."""

    def __call__(self, flows: torch.Tensor) -> torch.Tensor:
        return flow_uv_to_colors(flows[:, 0], flows[:, 1], div255=True,
                                 out_dtype=flows.dtype, dim=1)


# ------------------------------------------------------------ colour math
def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(N, 3, ...) -> (N, 1, ...), weights in img's dtype."""
    w = _channel_const(GRAY_WEIGHTS, img.dtype, img.device)
    w = w.reshape((1, 3) + (1,) * (img.dim() - 2))
    return (img * w).sum(1, keepdim=True)


def _rgb_to_hsv_channels(img: torch.Tensor):
    """(N, 3, ...) RGB -> (h, s, v), each (N, ...). Ties pick r before g;
    the hue wraps by % 1.0."""
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = img.amax(dim=1)
    minc = img.amin(dim=1)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe_delta = torch.clamp(delta, min=1e-12)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    return torch.stack(_rgb_to_hsv_channels(img), dim=1)


def _hsv_to_rgb_channels(h, s, v) -> torch.Tensor:
    """Branchless HSV -> RGB: f(n) = v - v s clip(min(k, 4 - k), 0, 1) with
    k = (n + 6h) mod 6; the channels stacked at axis 1."""

    def channel(n):
        k = (n + h * 6.0) % 6.0
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=1)


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    return _hsv_to_rgb_channels(img[:, 0], img[:, 1], img[:, 2])


# ------------------------------------------------------------------ draws
def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return lo + (hi - lo) * u


def _bernoulli(gen, p, n, device) -> torch.Tensor:
    return torch.rand((n,), generator=gen, device=device) < p


def _per(gen, b, t, per_frame, lo, hi, device) -> torch.Tensor:
    """(B, T) uniform factors: one a frame, or one a clip broadcast over T."""
    if per_frame:
        return _uniform(gen, (b, t), lo, hi, device)
    return _uniform(gen, (b, 1), lo, hi, device).expand(b, t)


def draw_color_jitter(gen, b, t, brightness=0.4, contrast=0.4,
                      saturation=0.4, hue=0.1, p=0.8, per_frame_params=True,
                      device=None) -> Dict:
    """One apply decision a clip, (B, T) factors; no hue draw when hue=0."""
    apply = _bernoulli(gen, p, b, device)
    out = dict(apply=apply)
    for name, amount in (('brightness', brightness), ('contrast', contrast),
                         ('saturation', saturation)):
        out[name] = _per(gen, b, t, per_frame_params, max(0., 1 - amount),
                         1 + amount, device)
    out['hue'] = (_per(gen, b, t, per_frame_params, -hue, hue, device)
                  if hue else None)
    return out


def draw_random_grayscale(gen, b, p=0.2, device=None) -> Dict:
    return dict(apply=_bernoulli(gen, p, b, device))


def draw_gaussian_blur(gen, b, sigma_range=(0.1, 2.0), p=0.5,
                       device=None) -> Dict:
    """One apply decision a clip; one sigma a call, a 0-d tensor."""
    apply = _bernoulli(gen, p, b, device)
    sigma = _uniform(gen, (), sigma_range[0], sigma_range[1], device)
    return dict(apply=apply, sigma=sigma)


def draw_strong_aug(gen, b, t, per_frame_params=True, device=None) -> Dict:
    return dict(
        jitter=draw_color_jitter(gen, b, t, 0.4, 0.4, 0.4, 0.1, p=0.8,
                                 per_frame_params=per_frame_params,
                                 device=device),
        gray=draw_random_grayscale(gen, b, 0.2, device),
        blur=draw_gaussian_blur(gen, b, p=0.5, device=device))


# ------------------------------------------------------------------ applies
def color_jitter_video(imgs: torch.Tensor, params: Dict) -> torch.Tensor:
    """(B, 3, T, H, W) in [0, 1]: brightness, contrast, saturation, hue in
    that order, clipped after each. The contrast mean is a frame's, over H,
    W and its gray channel, accumulated in float32."""
    dt = imgs.dtype

    def factor(name):                                   # (B, 1, T, 1, 1)
        return params[name].to(dt)[:, None, :, None, None]

    out = torch.clamp(imgs * factor('brightness'), 0., 1.)
    mean = rgb_to_gray(out).mean(dim=(1, 3, 4), keepdim=True,
                                 dtype=torch.float32).to(dt)
    out = torch.clamp((out - mean) * factor('contrast') + mean, 0., 1.)
    gray = rgb_to_gray(out)
    out = torch.clamp((out - gray) * factor('saturation') + gray, 0., 1.)
    if params['hue'] is not None:
        h, s, v = _rgb_to_hsv_channels(out)
        h = (h + params['hue'].to(dt)[:, :, None, None]) % 1.0
        out = torch.clamp(_hsv_to_rgb_channels(h, s, v), 0., 1.)
    return torch.where(_per_clip(params['apply']), out, imgs)


def random_grayscale_video(imgs: torch.Tensor, params: Dict) -> torch.Tensor:
    return torch.where(_per_clip(params['apply']), rgb_to_gray(imgs), imgs)


def blur_radius(img_size: int) -> int:
    return int(0.1 * img_size) // 2 * 2 + 1


def gaussian_blur_video(imgs: torch.Tensor, params: Dict,
                        img_size=112) -> torch.Tensor:
    """Separable gaussian blur, H pass then W pass, reflect borders; the
    kernel is normalised in float32 and then cast to the clip's dtype."""
    b, c, t, h, w = imgs.shape
    radius = blur_radius(img_size)
    half = radius // 2
    xs = torch.arange(-half, half + 1, dtype=torch.float32,
                      device=imgs.device)
    kern = torch.exp(-0.5 * (xs / params['sigma']) ** 2)
    kern = (kern / kern.sum()).to(imgs.dtype)
    planes = c * t                      # one (H, W) plane a channel-frame
    flat = imgs.reshape(b, planes, h, w)
    blurred = F.conv2d(F.pad(flat, (0, 0, half, half), mode='reflect'),
                       kern.reshape(1, 1, radius, 1).expand(
                           planes, 1, radius, 1).contiguous(),
                       groups=planes)
    blurred = F.conv2d(F.pad(blurred, (half, half, 0, 0), mode='reflect'),
                       kern.reshape(1, 1, 1, radius).expand(
                           planes, 1, 1, radius).contiguous(),
                       groups=planes)
    return torch.where(_per_clip(params['apply']),
                       blurred.reshape(b, c, t, h, w), imgs)


def normalize_video(imgs: torch.Tensor, mean=IMAGENET_MEAN,
                    std=IMAGENET_STD) -> torch.Tensor:
    """ImageNet normalize over axis 1, constants in the clip's dtype."""
    return ((imgs - _channel_const(tuple(mean), imgs.dtype, imgs.device)) /
            _channel_const(tuple(std), imgs.dtype, imgs.device))


def hflip_video(imgs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Flip the W axis of the clips where mask (B,) is True."""
    return torch.where(_per_clip(mask, imgs.dim()), imgs.flip(-1), imgs)


def hflip_boxes(boxes: torch.Tensor, mask: torch.Tensor,
                img_width) -> torch.Tensor:
    """x1' = W - x2, x2' = W - x1 over the last axis's groups of 4, where
    mask (B,) is True."""
    flipped = boxes.clone()
    flipped[..., 0::4] = img_width - boxes[..., 2::4]
    flipped[..., 2::4] = img_width - boxes[..., 0::4]
    return torch.where(_per_clip(mask, boxes.dim()), flipped, boxes)


def strong_aug(clips: torch.Tensor, params: Dict, crop_size) -> torch.Tensor:
    """Jitter, grayscale, blur, normalize (``draw_strong_aug``'s params)."""
    clips = color_jitter_video(clips, params['jitter'])
    clips = random_grayscale_video(clips, params['gray'])
    clips = gaussian_blur_video(clips, params['blur'], img_size=crop_size)
    return normalize_video(clips)


# ---------------------------------------------------------- aug classes
class _DrawApply:
    """Calling an augmentation draws its params from ``gen`` and applies
    them. Tests hand ``apply`` params drawn elsewhere (JAX's)."""
    visualize = False

    def __call__(self, gen, im_q, im_k=None, aux_info=None):
        return self.apply(im_q, im_k, aux_info,
                          self.draw(gen, im_q, im_k, aux_info))


@SSL_AUGS.register_module()
class IdentityAug(_DrawApply):

    def draw(self, gen, im_q, im_k=None, aux_info=None):
        return {}

    def apply(self, im_q, im_k, aux_info, params):
        if im_k is None:
            return im_q
        return im_q, im_k, aux_info


def _frames_as_clips(clips: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B*T, C, 1, H, W): each frame its own clip."""
    b, c, t, h, w = clips.shape
    return clips.transpose(1, 2).reshape(b * t, c, 1, h, w)


def _clips_from_frames(flat: torch.Tensor, shape) -> torch.Tensor:
    b, c, t, h, w = shape
    return flat.reshape(b, t, c, h, w).transpose(1, 2).contiguous()


@SSL_AUGS.register_module()
class MoCoAugment(_DrawApply):
    """Per-frame grayscale, jitter, flip and normalize: every frame its own
    draw (the frames become the clip axis)."""

    def __init__(self, crop_size):
        self.crop_size = crop_size

    def draw_clips(self, gen, clips) -> Dict:
        n = clips.shape[0] * clips.shape[2]
        dev = clips.device
        return dict(gray=draw_random_grayscale(gen, n, 0.2, dev),
                    jitter=draw_color_jitter(gen, n, 1, 0.4, 0.4, 0.4, 0.4,
                                             p=1.0, device=dev),
                    flip=_bernoulli(gen, 0.5, n, dev))

    def augment(self, clips, params):
        flat = _frames_as_clips(clips)
        flat = random_grayscale_video(flat, params['gray'])
        flat = color_jitter_video(flat, params['jitter'])
        flat = hflip_video(flat, params['flip'])
        flat = normalize_video(flat)
        return _clips_from_frames(flat, clips.shape)

    def draw(self, gen, im_q, im_k=None, aux_info=None):
        out = dict(q=self.draw_clips(gen, im_q))
        if im_k is not None:
            out['k'] = self.draw_clips(gen, im_k)
        return out

    def apply(self, im_q, im_k, aux_info, params):
        if im_k is None:
            return self.augment(im_q, params['q'])
        return (self.augment(im_q, params['q']),
                self.augment(im_k, params['k']), aux_info)


@SSL_AUGS.register_module()
class MoCoAugmentV2(MoCoAugment):
    """Per-frame jitter (hue 0.1, p=0.8), grayscale, blur p=0.5, flip and
    normalize."""

    def draw_clips(self, gen, clips) -> Dict:
        n = clips.shape[0] * clips.shape[2]
        dev = clips.device
        return dict(jitter=draw_color_jitter(gen, n, 1, 0.4, 0.4, 0.4, 0.1,
                                             p=0.8, device=dev),
                    gray=draw_random_grayscale(gen, n, 0.2, dev),
                    blur=draw_gaussian_blur(gen, n, p=0.5, device=dev),
                    flip=_bernoulli(gen, 0.5, n, dev))

    def augment(self, clips, params):
        flat = _frames_as_clips(clips)
        flat = color_jitter_video(flat, params['jitter'])
        flat = random_grayscale_video(flat, params['gray'])
        flat = gaussian_blur_video(flat, params['blur'],
                                   img_size=self.crop_size)
        flat = hflip_video(flat, params['flip'])
        flat = normalize_video(flat)
        return _clips_from_frames(flat, clips.shape)


@SSL_AUGS.register_module()
class SyncMoCoAugmentV5(_DrawApply):
    """The flagship's aug. Per branch: a flip mask (B,), applied to the
    clip, to every ``*<flow_suffix>_q/_k`` entry after it is visualised
    (and normalised with ``normalize_flow``), and to ``gt_bboxes_q/_k``;
    then the strong aug, or only normalize on a weak branch."""

    def __init__(self, crop_size, flip_transform=dict(p=0.5,
                                                      same_on_batch=False),
                 sync_level='batch', t=None, flow_suffix='flow_imgs',
                 img_width=112, visualize=True, weak_aug=(False, False),
                 normalize_flow=False):
        if isinstance(crop_size, (tuple, list)):
            crop_size = crop_size[0]
        self.crop_size = crop_size
        if isinstance(sync_level, str):
            sync_level = (sync_level, sync_level)
        assert all(v in ('batch', 'params') for v in sync_level)
        self.sync_level = tuple(sync_level)
        self.flip_p = (flip_transform or {}).get('p', 0.5)
        self.flip_enabled = bool(flip_transform)
        self.flow_suffix = flow_suffix
        self.img_width = img_width
        self.visualize = visualize
        self.weak_aug = tuple(weak_aug)
        self.normalize_flow = normalize_flow
        self.visualizer = FlowVisualizer() if visualize else None

    def _draw_branch(self, gen, clips, weak, sync) -> Dict:
        b, dev = clips.shape[0], clips.device
        if self.flip_enabled:
            flip = _bernoulli(gen, self.flip_p, b, dev)
        else:
            flip = torch.zeros((b,), dtype=torch.bool, device=dev)
        strong = None if weak else draw_strong_aug(
            gen, b, clips.shape[2], per_frame_params=(sync == 'batch'),
            device=dev)
        return dict(flip=flip, strong=strong)

    def draw(self, gen, im_q, im_k, aux_info=None):
        return dict(q=self._draw_branch(gen, im_q, self.weak_aug[0],
                                        self.sync_level[0]),
                    k=self._draw_branch(gen, im_k, self.weak_aug[1],
                                        self.sync_level[1]))

    def _apply_branch(self, clips, aux_info, suffix, params):
        mask = params['flip']
        clips = hflip_video(clips, mask)
        if self.flow_suffix:
            full_suffix = self.flow_suffix + suffix
            for k in list(aux_info):
                if k.endswith(full_suffix):
                    flow = aux_info[k]
                    if self.visualizer is not None:
                        flow = self.visualizer(flow)
                    if self.normalize_flow:
                        flow = normalize_video(flow)
                    aux_info[k] = hflip_video(flow, mask)
        if 'gt_bboxes' + suffix in aux_info:
            aux_info['gt_bboxes' + suffix] = hflip_boxes(
                aux_info['gt_bboxes' + suffix], mask, self.img_width)
        if params['strong'] is None:
            clips = normalize_video(clips)
        else:
            clips = strong_aug(clips, params['strong'], self.crop_size)
        return clips, aux_info

    def apply(self, im_q, im_k, aux_info, params):
        aux_info = dict(aux_info or {})
        im_q, aux_info = self._apply_branch(im_q, aux_info, '_q', params['q'])
        im_k, aux_info = self._apply_branch(im_k, aux_info, '_k', params['k'])
        return im_q, im_k, aux_info


@SSL_AUGS.register_module()
class SyncMoCoAugmentV3(SyncMoCoAugmentV5):
    """V5 with the strong aug on both branches and the flow visualised."""

    def __init__(self, crop_size, flip_transform=dict(p=0.5),
                 sync_level='batch', t=None, flow_suffix='flow_imgs',
                 img_width=112):
        super().__init__(crop_size, flip_transform, sync_level, t,
                         flow_suffix, img_width, visualize=True,
                         weak_aug=(False, False))


@SSL_AUGS.register_module()
class SyncMoCoAugmentV2(SyncMoCoAugmentV5):
    """V5 that flips the raw flow without visualising it."""

    def __init__(self, crop_size, flip_transform=dict(p=0.5),
                 sync_level='batch', t=None, flow_suffix='flow_imgs',
                 img_width=112):
        super().__init__(crop_size, flip_transform, sync_level, t,
                         flow_suffix, img_width, visualize=False,
                         weak_aug=(False, False))


@SSL_AUGS.register_module()
class SyncMoCoAugmentV4(SyncMoCoAugmentV5):
    """V3 plus motion maps of the raw flow, flipped with the clip and kept
    as ``motion_maps_q/_k``."""

    def __init__(self, crop_size, flip_transform=dict(p=0.5),
                 sync_level='batch', t=None, flow_suffix='flow_imgs',
                 img_width=112, motion_pool='max'):
        super().__init__(crop_size, flip_transform, sync_level, t,
                         flow_suffix, img_width, visualize=True,
                         weak_aug=(False, False))
        self.motion_calc = MotionMapCalculator(pool=motion_pool)

    def _apply_branch(self, clips, aux_info, suffix, params):
        full_suffix = (self.flow_suffix or '') + suffix
        raw_flow = None
        for k in list(aux_info):
            if self.flow_suffix and k.endswith(full_suffix):
                raw_flow = aux_info[k]
        if raw_flow is not None and raw_flow.shape[1] == 2:
            aux_info['motion_maps' + suffix] = hflip_video(
                self.motion_calc(raw_flow), params['flip'])
        return super()._apply_branch(clips, aux_info, suffix, params)

"""Per-sample crops, resizes, jitter and normalisation over the ``results``
dict.

Port of ``mscl_tpu/datasets/pipelines/augmentations.py``: ``rescale_size``,
the crop-quadruple and box helpers, ``get_random_resized_crop_bbox``
(reference mmaction augmentations.py:800-849) and the transforms
``RandomCrop``, ``RandomResizedCrop``, ``MultiScaleCrop``, ``Resize``,
``RandomRescale``, ``Normalize``, ``CenterCrop``, ``ThreeCrop``,
``TenCrop``, ``MultiGroupCrop``, ``RandomScale``, ``ColorJitter``,
``Flip``, ``Fuse`` and ``GPUNormalize``. Every draw comes from the global
``np.random`` or the global Python ``random``, with the JAX package's calls
in its order, so a seeded run gives its crops, flips and jitters. Resizing
is ``utils.image_io.imresize`` (OpenCV's INTER_LINEAR without cv2), and
``ColorJitter``'s hue step ``utils.color`` (OpenCV's uint8 HSV
conversions). With ``lazy=True`` the crops, ``Resize`` and
``Flip`` only record their geometry in ``results['lazy']`` (reference
augmentations.py:24-55) and ``Fuse`` applies one combined crop, resize and
flip to the original frames (:511-549), as the JAX package does.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..builder import PIPELINES
from ...utils.color import hsv_to_rgb, rgb_to_hsv
from ...utils.image_io import imresize


def rescale_size(old_size_wh, scale):
    """mmcv.rescale_size: fit (w, h) inside ``scale`` keeping aspect ratio."""
    w, h = old_size_wh
    if isinstance(scale, (float, int)):
        scale_factor = scale
    elif isinstance(scale, tuple):
        max_long_edge = max(scale)
        max_short_edge = min(scale)
        scale_factor = min(max_long_edge / max(h, w),
                           max_short_edge / min(h, w))
    else:
        raise TypeError(f'Scale must be a number or tuple, got {type(scale)}')
    return int(w * scale_factor + 0.5), int(h * scale_factor + 0.5)


def _update_crop_quadruple(results, x_offset, y_offset, new_w, new_h,
                           img_w, img_h, key='crop_quadruple'):
    if key not in results:
        results[key] = np.array([0, 0, 1, 1], dtype=np.float32)
    x_ratio, y_ratio = x_offset / img_w, y_offset / img_h
    w_ratio, h_ratio = new_w / img_w, new_h / img_h
    old = results[key]
    results[key] = np.array([
        old[0] + x_ratio * old[2],
        old[1] + y_ratio * old[3],
        w_ratio * old[2],
        h_ratio * old[3],
    ], dtype=np.float32)


def _crop_imgs(imgs, crop_bbox):
    x1, y1, x2, y2 = crop_bbox
    return [img[y1:y2, x1:x2] for img in imgs]


def _box_crop(box, crop_bbox):
    x1, y1, x2, y2 = crop_bbox
    img_w, img_h = x2 - x1, y2 - y1
    box_ = box.copy()
    box_[..., 0::2] = np.clip(box[..., 0::2] - x1, 0, img_w - 1)
    box_[..., 1::2] = np.clip(box[..., 1::2] - y1, 0, img_h - 1)
    return box_


def _all_box_crop(results, crop_bbox):
    results['gt_bboxes'] = _box_crop(results['gt_bboxes'], crop_bbox)
    if 'proposals' in results and results['proposals'] is not None:
        assert results['proposals'].shape[1] == 4
        results['proposals'] = _box_crop(results['proposals'], crop_bbox)
    return results


def _box_resize(box, scale_factor):
    assert len(scale_factor) == 2
    return box * np.concatenate([scale_factor, scale_factor])


def get_random_resized_crop_bbox(img_shape, area_range, aspect_ratio_range,
                                 max_attempts=10):
    """Sample a crop bbox in the given area/aspect-ratio range; fall back to
    the largest center square (augmentations.py:800-849 math)."""
    assert 0 < area_range[0] <= area_range[1] <= 1
    assert 0 < aspect_ratio_range[0] <= aspect_ratio_range[1]
    img_h, img_w = img_shape
    area = img_h * img_w
    min_ar, max_ar = aspect_ratio_range
    aspect_ratios = np.exp(np.random.uniform(
        np.log(min_ar), np.log(max_ar), size=max_attempts))
    target_areas = np.random.uniform(*area_range, size=max_attempts) * area
    candidate_crop_w = np.round(
        np.sqrt(target_areas * aspect_ratios)).astype(np.int32)
    candidate_crop_h = np.round(
        np.sqrt(target_areas / aspect_ratios)).astype(np.int32)
    for i in range(max_attempts):
        crop_w = int(candidate_crop_w[i])
        crop_h = int(candidate_crop_h[i])
        if crop_h <= img_h and crop_w <= img_w:
            x_offset = _pyrandom.randint(0, img_w - crop_w)
            y_offset = _pyrandom.randint(0, img_h - crop_h)
            return x_offset, y_offset, x_offset + crop_w, y_offset + crop_h
    crop_size = min(img_h, img_w)
    x_offset = (img_w - crop_size) // 2
    y_offset = (img_h - crop_size) // 2
    return x_offset, y_offset, x_offset + crop_size, y_offset + crop_size


def _init_lazy_if_proper(results, lazy):
    """Reference augmentations.py:24-55: initialize the ``lazy`` record
    (original_shape, cumulative crop_bbox in original coords, flip state,
    interpolation) or assert no stale one leaks into a non-lazy op."""
    if 'img_shape' not in results:
        results['img_shape'] = results['imgs'][0].shape[:2]
    if lazy:
        if 'lazy' not in results:
            img_h, img_w = results['img_shape']
            results['lazy'] = dict(
                original_shape=results['img_shape'],
                crop_bbox=np.array([0, 0, img_w, img_h],
                                   dtype=np.float32),
                flip=False, flip_direction=None, interpolation=None)
    else:
        assert 'lazy' not in results, 'Use Fuse after lazy operations'


def _lazy_crop(results, crop_bbox, img_w, img_h):
    """Compose a crop (in current virtual coords) into the lazy record
    (reference RandomCrop lazy branch, augmentations.py:739-755)."""
    lazyop = results['lazy']
    if lazyop['flip']:
        raise NotImplementedError('Put Flip at last for now')
    x1, y1, x2, y2 = crop_bbox
    lazy_left, lazy_top, lazy_right, lazy_bottom = lazyop['crop_bbox']
    left = x1 * (lazy_right - lazy_left) / img_w
    right = x2 * (lazy_right - lazy_left) / img_w
    top = y1 * (lazy_bottom - lazy_top) / img_h
    bottom = y2 * (lazy_bottom - lazy_top) / img_h
    lazyop['crop_bbox'] = np.array(
        [lazy_left + left, lazy_top + top,
         lazy_left + right, lazy_top + bottom], dtype=np.float32)


def _box_flip(box, img_width):
    box_ = box.copy()
    box_[..., 0::4] = img_width - box[..., 2::4]
    box_[..., 2::4] = img_width - box[..., 0::4]
    return box_


def _finish_crop(results, crop_bbox, new_h, new_w, lazy=False):
    results['crop_bbox'] = crop_bbox
    img_h, img_w = results['img_shape']
    results['img_shape'] = (new_h, new_w)
    if lazy:
        _lazy_crop(results, crop_bbox, img_w, img_h)
    elif 'imgs' in results:
        results['imgs'] = _crop_imgs(results['imgs'], crop_bbox)
    if 'gt_bboxes' in results:
        assert not lazy
        results = _all_box_crop(results, crop_bbox)
    return results


@PIPELINES.register_module()
class RandomCrop:
    """Square random crop (augmentations.py:623-766); the base of the other
    crops, as in the JAX package."""

    def __init__(self, size, lazy=False):
        if not isinstance(size, int):
            raise TypeError(f'Size must be an int, got {type(size)}')
        self.size = size
        self.lazy = lazy

    def __call__(self, results):
        _init_lazy_if_proper(results, self.lazy)
        img_h, img_w = results['img_shape']
        assert self.size <= img_h and self.size <= img_w
        y_offset = int(np.random.randint(0, img_h - self.size)) \
            if img_h > self.size else 0
        x_offset = int(np.random.randint(0, img_w - self.size)) \
            if img_w > self.size else 0
        _update_crop_quadruple(results, x_offset, y_offset,
                               self.size, self.size, img_w, img_h)
        crop_bbox = np.array([x_offset, y_offset,
                              x_offset + self.size, y_offset + self.size])
        return _finish_crop(results, crop_bbox, self.size, self.size,
                            self.lazy)

    def __repr__(self):
        return f'{self.__class__.__name__}(size={self.size})'


@PIPELINES.register_module()
class RandomResizedCrop(RandomCrop):
    """Area + aspect-ratio ranged random crop (augmentations.py:769-927)."""

    def __init__(self, area_range=(0.08, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3), lazy=False):
        self.area_range = tuple(area_range)
        self.aspect_ratio_range = tuple(aspect_ratio_range)
        self.lazy = lazy

    def __call__(self, results):
        _init_lazy_if_proper(results, self.lazy)
        img_h, img_w = results['img_shape']
        left, top, right, bottom = get_random_resized_crop_bbox(
            (img_h, img_w), self.area_range, self.aspect_ratio_range)
        new_h, new_w = bottom - top, right - left
        _update_crop_quadruple(results, left, top, new_w, new_h, img_w, img_h)
        crop_bbox = np.array([left, top, right, bottom])
        return _finish_crop(results, crop_bbox, new_h, new_w, self.lazy)

    def __repr__(self):
        return (f'{self.__class__.__name__}(area_range={self.area_range}, '
                f'aspect_ratio_range={self.aspect_ratio_range})')


@PIPELINES.register_module()
class MultiScaleCrop(RandomCrop):
    """TSN's multi-scale crop (augmentations.py:929-1105): a (w, h) pair of
    ``scales`` x the short edge, at most ``max_wh_scale_gap`` scales apart,
    snapped to ``input_size`` within 3 pixels, at a random offset or one of
    5 or 13 fixed ones."""

    def __init__(self, input_size, scales=(1,), max_wh_scale_gap=1,
                 random_crop=False, num_fixed_crops=5, lazy=False):
        if isinstance(input_size, int):
            input_size = (input_size, input_size)
        self.input_size = tuple(input_size)
        if not isinstance(scales, tuple):
            raise TypeError(f'Scales must be tuple, got {type(scales)}')
        if num_fixed_crops not in (5, 13):
            raise ValueError('num_fixed_crops must be 5 or 13')
        self.scales = scales
        self.max_wh_scale_gap = max_wh_scale_gap
        self.random_crop = random_crop
        self.num_fixed_crops = num_fixed_crops
        self.lazy = lazy

    def __call__(self, results):
        _init_lazy_if_proper(results, self.lazy)
        img_h, img_w = results['img_shape']
        base_size = min(img_h, img_w)
        crop_sizes = [int(base_size * s) for s in self.scales]
        candidate_sizes = []
        for i, h in enumerate(crop_sizes):
            for j, w in enumerate(crop_sizes):
                if abs(i - j) <= self.max_wh_scale_gap:
                    candidate_sizes.append([w, h])
        crop_size = list(_pyrandom.choice(candidate_sizes))
        for i in range(2):
            if abs(crop_size[i] - self.input_size[i]) < 3:
                crop_size[i] = self.input_size[i]
        crop_w, crop_h = crop_size
        if self.random_crop:
            x_offset = _pyrandom.randint(0, img_w - crop_w)
            y_offset = _pyrandom.randint(0, img_h - crop_h)
        else:
            w_step = (img_w - crop_w) // 4
            h_step = (img_h - crop_h) // 4
            candidate_offsets = [
                (0, 0), (4 * w_step, 0), (0, 4 * h_step),
                (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step),
            ]
            if self.num_fixed_crops == 13:
                candidate_offsets += [
                    (0, 2 * h_step), (4 * w_step, 2 * h_step),
                    (2 * w_step, 4 * h_step), (2 * w_step, 0),
                    (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                    (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step),
                ]
            x_offset, y_offset = _pyrandom.choice(candidate_offsets)
        _update_crop_quadruple(results, x_offset, y_offset,
                               crop_w, crop_h, img_w, img_h)
        crop_bbox = np.array([x_offset, y_offset,
                              x_offset + crop_w, y_offset + crop_h])
        results['scales'] = self.scales
        return _finish_crop(results, crop_bbox, crop_h, crop_w, self.lazy)

    def __repr__(self):
        return (f'{self.__class__.__name__}(input_size={self.input_size}, '
                f'scales={self.scales})')


@PIPELINES.register_module()
class CenterCrop(RandomCrop):
    """Center crop (augmentations.py:1621-1718)."""

    def __init__(self, crop_size, lazy=False):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_size = tuple(crop_size)
        self.lazy = lazy

    def __call__(self, results):
        _init_lazy_if_proper(results, self.lazy)
        img_h, img_w = results['img_shape']
        crop_w, crop_h = self.crop_size
        left = (img_w - crop_w) // 2
        top = (img_h - crop_h) // 2
        right, bottom = left + crop_w, top + crop_h
        new_h, new_w = bottom - top, right - left
        _update_crop_quadruple(results, left, top, new_w, new_h, img_w, img_h)
        crop_bbox = np.array([left, top, right, bottom])
        return _finish_crop(results, crop_bbox, new_h, new_w, self.lazy)

    def __repr__(self):
        return f'{self.__class__.__name__}(crop_size={self.crop_size})'


@PIPELINES.register_module()
class Resize:
    """Resize to a fixed size or rescale keeping ratio
    (augmentations.py:1108-1236)."""

    def __init__(self, scale, keep_ratio=True, interpolation='bilinear',
                 lazy=False):
        if isinstance(scale, float):
            if scale <= 0:
                raise ValueError(f'Invalid scale {scale}')
        elif isinstance(scale, (tuple, list)):
            scale = tuple(scale)
            max_long_edge = max(scale)
            max_short_edge = min(scale)
            if max_short_edge == -1:
                scale = (np.inf, max_long_edge)
        else:
            raise TypeError(f'Scale must be float or tuple, got {type(scale)}')
        self.scale = scale
        self.keep_ratio = keep_ratio
        self.interpolation = interpolation
        self.lazy = lazy

    def __call__(self, results):
        _init_lazy_if_proper(results, self.lazy)
        if 'scale_factor' not in results:
            results['scale_factor'] = np.array([1, 1], dtype=np.float32)
        img_h, img_w = results['img_shape']
        if self.keep_ratio:
            new_w, new_h = rescale_size((img_w, img_h), self.scale)
        else:
            new_w, new_h = self.scale
        scale_factor = np.array([new_w / img_w, new_h / img_h],
                                dtype=np.float32)
        results['img_shape'] = (new_h, new_w)
        results['keep_ratio'] = self.keep_ratio
        results['scale_factor'] = results['scale_factor'] * scale_factor
        if self.lazy:
            lazyop = results['lazy']
            if lazyop['flip']:
                raise NotImplementedError('Put Flip at last for now')
            lazyop['interpolation'] = self.interpolation
        elif 'imgs' in results:
            results['imgs'] = [
                imresize(img, (new_w, new_h), self.interpolation)
                for img in results['imgs']
            ]
        if 'gt_bboxes' in results:
            assert not self.lazy
            results['gt_bboxes'] = _box_resize(results['gt_bboxes'],
                                               scale_factor)
            if 'proposals' in results and results['proposals'] is not None:
                results['proposals'] = _box_resize(results['proposals'],
                                                   scale_factor)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(scale={self.scale}, '
                f'keep_ratio={self.keep_ratio})')


@PIPELINES.register_module()
class RandomRescale:
    """Resize the short edge to a random size in ``scale_range``
    (augmentations.py:1238-1289)."""

    def __init__(self, scale_range, interpolation='bilinear'):
        self.scale_range = scale_range
        assert len(scale_range) == 2
        assert scale_range[0] < scale_range[1]
        assert np.all([x > 0 for x in scale_range])
        self.interpolation = interpolation

    def __call__(self, results):
        short_edge = np.random.randint(self.scale_range[0],
                                       self.scale_range[1] + 1)
        resize = Resize((-1, short_edge), keep_ratio=True,
                        interpolation=self.interpolation)
        results = resize(results)
        results['short_edge'] = short_edge
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(scale_range={self.scale_range})'


@PIPELINES.register_module()
class RandomScale:
    """A random scale, then ``Resize`` to it (reference augmentations.py
    RandomScale): with two scales a long and a short edge drawn in their
    ranges ('range') or one of them ('value'); more scales only by
    'value'."""

    def __init__(self, scales, mode='range', **kwargs):
        if mode not in ('range', 'value'):
            raise ValueError(f"mode must be 'range' or 'value': {mode}")
        self.scales = scales
        self.mode = mode
        self.kwargs = kwargs

    def select_scale(self, scales):
        num_scales = len(scales)
        if num_scales == 1:
            return scales[0]
        if num_scales == 2:
            if self.mode == 'value':
                return scales[int(np.random.randint(2))]
            scale_long = [max(s) for s in scales]
            scale_short = [min(s) for s in scales]
            long_edge = np.random.randint(min(scale_long),
                                          max(scale_long) + 1)
            short_edge = np.random.randint(min(scale_short),
                                           max(scale_short) + 1)
            return (long_edge, short_edge)
        if self.mode != 'value':
            raise ValueError(
                "only 'value' mode supports more than 2 scales")
        return scales[int(np.random.randint(num_scales))]

    def __call__(self, results):
        scale = self.select_scale(self.scales)
        results['scale'] = scale
        return Resize(scale, **self.kwargs)(results)

    def __repr__(self):
        return (f'{self.__class__.__name__}(scales={self.scales}, '
                f'mode={self.mode})')


@PIPELINES.register_module()
class Flip:
    """Flip all frames with a probability (augmentations.py:1291-1436).

    For 'Flow' modality the x-flow frames (even indices) are inverted
    (255 - img) after a horizontal flip.
    """
    _directions = ('horizontal', 'vertical')

    def __init__(self, flip_ratio=0.5, direction='horizontal',
                 flip_label_map=None, lazy=False, left_kp=None,
                 right_kp=None):
        if left_kp is not None or right_kp is not None:
            # mmaction2's Flip swaps the left and right keypoints; the JAX
            # package's Flip takes no such arguments (its limb pipeline does
            # not build), so there is nothing to hold the port's to
            raise TypeError(
                'Flip does not flip keypoints (left_kp, right_kp): '
                'mscl_tpu\'s Flip has no such arguments either')
        if direction not in self._directions:
            raise ValueError(f'Direction {direction} not supported')
        self.flip_ratio = flip_ratio
        self.direction = direction
        self.flip_label_map = flip_label_map
        self.lazy = lazy

    def _flip_imgs(self, imgs, modality):
        axis = 1 if self.direction == 'horizontal' else 0
        imgs = [np.flip(img, axis=axis).copy() for img in imgs]
        if modality == 'Flow':
            for i in range(0, len(imgs), 2):
                imgs[i] = 255 - imgs[i]
        return imgs

    def __call__(self, results):
        _init_lazy_if_proper(results, self.lazy)
        modality = results.get('modality', 'RGB')
        if modality == 'Flow':
            assert self.direction == 'horizontal'
        flip = np.random.rand() < self.flip_ratio
        results['flip'] = flip
        results['flip_direction'] = self.direction
        if self.flip_label_map is not None and flip:
            results['label'] = self.flip_label_map.get(
                results['label'], results['label'])
        if self.lazy:
            lazyop = results['lazy']
            if lazyop['flip']:
                raise NotImplementedError('Use one Flip please')
            lazyop['flip'] = flip
            lazyop['flip_direction'] = self.direction
            return results
        if flip:
            if 'imgs' in results:
                results['imgs'] = self._flip_imgs(results['imgs'], modality)
            if 'gt_bboxes' in results:
                width = results['img_shape'][1]
                results['gt_bboxes'] = _box_flip(results['gt_bboxes'], width)
                if 'proposals' in results and results['proposals'] is not None:
                    results['proposals'] = _box_flip(results['proposals'],
                                                     width)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(flip_ratio={self.flip_ratio}, '
                f'direction={self.direction})')


@PIPELINES.register_module()
class Fuse:
    """Apply the accumulated lazy crop + resize + flip in one pass
    (reference augmentations.py:511-549): crop the ORIGINAL frames by the
    composed crop_bbox, resize to the final virtual img_shape, then flip.
    Like the reference, the fused flip does not invert x-flow frames: lazy
    mode is for RGB pipelines."""

    def __call__(self, results):
        if 'lazy' not in results:
            raise ValueError('No lazy operation detected')
        lazyop = results['lazy']
        imgs = results['imgs']
        left, top, right, bottom = \
            np.round(lazyop['crop_bbox']).astype(int)
        imgs = [img[top:bottom, left:right] for img in imgs]
        img_h, img_w = results['img_shape']
        interpolation = lazyop['interpolation'] or 'bilinear'
        imgs = [imresize(img, (img_w, img_h), interpolation)
                for img in imgs]
        if lazyop['flip']:
            axis = 1 if lazyop['flip_direction'] == 'horizontal' else 0
            imgs = [np.flip(img, axis=axis).copy() for img in imgs]
        results['imgs'] = imgs
        del results['lazy']
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'


@PIPELINES.register_module()
class Normalize:
    """(img - mean) / std, stacking frames (augmentations.py:1438-1521)."""

    def __init__(self, mean, std, to_bgr=False, adjust_magnitude=False):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.to_bgr = to_bgr
        self.adjust_magnitude = adjust_magnitude

    def __call__(self, results):
        modality = results.get('modality', 'RGB')
        if modality == 'RGB':
            n = len(results['imgs'])
            h, w, c = results['imgs'][0].shape
            imgs = np.empty((n, h, w, c), dtype=np.float32)
            for i, img in enumerate(results['imgs']):
                imgs[i] = img
            if self.to_bgr:
                imgs = imgs[..., ::-1]
            imgs = (imgs - self.mean) / self.std
            results['imgs'] = imgs
            results['img_norm_cfg'] = dict(
                mean=self.mean, std=self.std, to_bgr=self.to_bgr)
            return results
        if modality == 'Flow':
            num_imgs = len(results['imgs'])
            assert num_imgs % 2 == 0
            assert self.mean.shape[0] == 2 and self.std.shape[0] == 2
            n = num_imgs // 2
            x_flow = np.stack([results['imgs'][2 * i] for i in range(n)]
                              ).astype(np.float32)
            y_flow = np.stack([results['imgs'][2 * i + 1] for i in range(n)]
                              ).astype(np.float32)
            x_flow = (x_flow - self.mean[0]) / self.std[0]
            y_flow = (y_flow - self.mean[1]) / self.std[1]
            if self.adjust_magnitude:
                x_flow = x_flow * results['scale_factor'][0]
                y_flow = y_flow * results['scale_factor'][1]
            results['imgs'] = np.stack([x_flow, y_flow], axis=-1)
            results['img_norm_cfg'] = dict(
                mean=self.mean, std=self.std, to_bgr=self.to_bgr,
                adjust_magnitude=self.adjust_magnitude)
            return results
        raise NotImplementedError(f'modality {modality}')

    def __repr__(self):
        return (f'{self.__class__.__name__}(mean={self.mean}, '
                f'std={self.std}, to_bgr={self.to_bgr})')



def _crop_at(imgs, offsets, crop_w, crop_h):
    """Each offset's crop of every frame, offset after offset, and the
    crop boxes, one a frame."""
    crops, boxes = [], []
    for x_offset, y_offset in offsets:
        crops.extend(img[y_offset:y_offset + crop_h,
                         x_offset:x_offset + crop_w] for img in imgs)
        boxes.extend([[x_offset, y_offset, x_offset + crop_w,
                       y_offset + crop_h]] * len(imgs))
    return crops, boxes


@PIPELINES.register_module()
class ThreeCrop:
    """Three crops along the long edge (its two ends and its middle), for
    testing (augmentations.py:1721-1800)."""

    def __init__(self, crop_size):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_size = tuple(crop_size)

    def __call__(self, results):
        imgs = results['imgs']
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size
        assert crop_h == img_h or crop_w == img_w
        if crop_h == img_h:
            w_step = (img_w - crop_w) // 2
            offsets = [(0, 0), (2 * w_step, 0), (w_step, 0)]
        else:
            h_step = (img_h - crop_h) // 2
            offsets = [(0, 0), (0, 2 * h_step), (0, h_step)]
        crops, boxes = _crop_at(imgs, offsets, crop_w, crop_h)
        results['imgs'] = crops
        results['crop_bbox'] = np.array(boxes)
        results['img_shape'] = crops[0].shape[:2]
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(crop_size={self.crop_size})'


@PIPELINES.register_module()
class TenCrop:
    """The four corners and the centre, each also flipped, for testing
    (mmaction TenCrop)."""

    def __init__(self, crop_size):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_size = tuple(crop_size)

    def __call__(self, results):
        imgs = results['imgs']
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size
        w_step = (img_w - crop_w) // 4
        h_step = (img_h - crop_h) // 4
        offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
                   (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
        img_crops, boxes = [], []
        for offset in offsets:
            crop, box = _crop_at(imgs, [offset], crop_w, crop_h)
            img_crops.extend(crop)
            img_crops.extend(np.flip(c, axis=1).copy() for c in crop)
            boxes.extend(box * 2)
        results['imgs'] = img_crops
        results['crop_bbox'] = np.array(boxes)
        results['img_shape'] = img_crops[0].shape[:2]
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(crop_size={self.crop_size})'


@PIPELINES.register_module()
class MultiGroupCrop:
    """``groups`` random crops of every frame, one after the other
    (reference augmentations.py MultiGroupCrop)."""

    def __init__(self, crop_size, groups):
        if isinstance(crop_size, int):
            crop_size = (crop_size, crop_size)
        self.crop_size = tuple(crop_size)
        if not isinstance(groups, int) or groups <= 0:
            raise ValueError(f'groups must be a positive int: {groups}')
        self.groups = groups

    def __call__(self, results):
        imgs = results['imgs']
        img_h, img_w = imgs[0].shape[:2]
        crop_w, crop_h = self.crop_size
        offsets = []
        for _ in range(self.groups):
            x_offset = _pyrandom.randint(0, img_w - crop_w)
            offsets.append((x_offset, _pyrandom.randint(0, img_h - crop_h)))
        crops, boxes = _crop_at(imgs, offsets, crop_w, crop_h)
        results['imgs'] = crops
        results['crop_bbox'] = np.array(boxes)
        results['img_shape'] = (crop_h, crop_w)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(crop_size={self.crop_size}, '
                f'groups={self.groups})')


@PIPELINES.register_module()
class ColorJitter:
    """Brightness, contrast, saturation and hue jitter, one draw of each a
    clip (augmentations.py:1524-1618): float32 arithmetic on the frames,
    the hue shifted in OpenCV's uint8 HSV (H in [0, 180)); float32 frames
    in [0, 255] out."""

    def __init__(self, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1):
        self.brightness = self._range(brightness, base=1)
        self.contrast = self._range(contrast, base=1)
        self.saturation = self._range(saturation, base=1)
        self.hue = self._range(hue, base=0)

    @staticmethod
    def _range(val, base):
        if isinstance(val, (tuple, list)):
            return tuple(val)
        return (max(0.0, base - val), base + val)

    @staticmethod
    def _rgb_to_gray(img):
        return (img @ np.array([0.299, 0.587, 0.114],
                               dtype=np.float32))[..., None]

    def __call__(self, results):
        imgs = [np.asarray(img, dtype=np.float32)
                for img in results['imgs']]
        b = np.random.uniform(*self.brightness)
        c = np.random.uniform(*self.contrast)
        s = np.random.uniform(*self.saturation)
        h = np.random.uniform(-self.hue[1], self.hue[1])
        out = []
        for img in imgs:
            img = img * b
            mean = self._rgb_to_gray(img).mean()
            img = (img - mean) * c + mean
            gray = self._rgb_to_gray(img)
            img = (img - gray) * s + gray
            if h != 0:
                hsv = rgb_to_hsv(np.clip(img, 0, 255).astype(np.uint8))
                hsv = hsv.astype(np.int32)
                hsv[..., 0] = (hsv[..., 0] + int(h * 180)) % 180
                img = hsv_to_rgb(hsv.astype(np.uint8)).astype(np.float32)
            out.append(np.clip(img, 0, 255))
        results['imgs'] = out
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(brightness={self.brightness}, '
                f'contrast={self.contrast}, saturation={self.saturation}, '
                f'hue={self.hue})')


@PIPELINES.register_module()
class GPUNormalize:
    """The reference prepares mean and std tensors here and normalises on
    the card; the port's models take the pipeline's arrays, so this only
    records the config (reference augmentations.py GPUNormalize)."""

    def __init__(self, input_format, mean, std):
        self.input_format = input_format
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)

    def __call__(self, results):
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std)
        return results

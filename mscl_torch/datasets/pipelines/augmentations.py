"""Per-sample crops, resizes and normalisation over the ``results`` dict.

Port of the parts of ``mscl_tpu/datasets/pipelines/augmentations.py`` that
the flagship and fine-tune configs' pipelines run: ``rescale_size``, the
crop-quadruple and box helpers, ``get_random_resized_crop_bbox`` (reference
mmaction augmentations.py:800-849), which draws its aspect ratios and areas
from the global ``np.random`` and its offsets from the global Python
``random``, in the JAX package's order, and the transforms
``RandomResizedCrop``, ``Resize``, ``Normalize``, ``CenterCrop``, ``Flip``
and ``Fuse``. Resizing is ``utils.image_io.imresize`` (OpenCV's
INTER_LINEAR without cv2). With ``lazy=True`` the crops, ``Resize`` and
``Flip`` only record their geometry in ``results['lazy']`` (reference
augmentations.py:24-55) and ``Fuse`` applies one combined crop, resize and
flip to the original frames (:511-549), as the JAX package does.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..builder import PIPELINES
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
class RandomResizedCrop:
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
class CenterCrop:
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
class Flip:
    """Flip all frames with a probability (augmentations.py:1291-1436).

    For 'Flow' modality the x-flow frames (even indices) are inverted
    (255 - img) after a horizontal flip.
    """
    _directions = ('horizontal', 'vertical')

    def __init__(self, flip_ratio=0.5, direction='horizontal',
                 flip_label_map=None, lazy=False):
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


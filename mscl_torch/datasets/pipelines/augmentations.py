"""The crop helpers of the MoCo transforms.

Port of the part of ``mscl_tpu/datasets/pipelines/augmentations.py`` that
the flagship config's pipelines run: ``rescale_size``, the crop-quadruple
and box helpers and ``get_random_resized_crop_bbox`` (reference mmaction
augmentations.py:800-849), which draws its aspect ratios and areas from the
global ``np.random`` and its offsets from the global Python ``random``, in
the JAX package's order.
"""
from __future__ import annotations

import random as _pyrandom

import numpy as np


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


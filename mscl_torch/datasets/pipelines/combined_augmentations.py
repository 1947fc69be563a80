"""MoCoTransform: two independent random-resized crops of one clip, as the
[q, k] pair of CTHW float clips the plain-MoCo configs train on.

Port of ``mscl_tpu/datasets/pipelines/combined_augmentations.py``: each
view draws its box with ``get_random_resized_crop_bbox`` (numpy's and
Python's global generators, as the JAX pipeline's), crops every frame,
resizes it with ``utils.image_io.imresize`` (cv2's bilinear, without cv2),
then stacks the frames, divides by 255 and goes THWC -> CTHW (torchvision's
ToTensorVideo).
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES
from ...utils.image_io import imresize
from .augmentations import get_random_resized_crop_bbox


@PIPELINES.register_module()
class MoCoTransform:

    def __init__(self, transform=(), crop_transform=None,
                 ending_transform=(), size=112, scale=(0.2, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3)):
        crop_transform = crop_transform or {}
        size = crop_transform.get('size', size)
        scale = crop_transform.get('scale', scale)
        if isinstance(size, int):
            size = (size, size)
        self.size = tuple(size)
        self.area_range = tuple(float(s) for s in scale)
        self.aspect_ratio_range = tuple(aspect_ratio_range)
        # transform and ending_transform are the reference config's
        # surface; the stack, /255 and CTHW always run, as in the JAX package

    def _one_view(self, imgs, img_shape):
        left, top, right, bottom = get_random_resized_crop_bbox(
            img_shape, self.area_range, self.aspect_ratio_range)
        clip = np.stack([imresize(img[top:bottom, left:right], self.size)
                         for img in imgs]).astype(np.float32) / 255.0
        return clip.transpose(3, 0, 1, 2)

    def __call__(self, results):
        imgs, img_shape = results['imgs'], results['img_shape']
        results['imgs'] = [self._one_view(imgs, img_shape),
                           self._one_view(imgs, img_shape)]
        results['img_shape'] = (self.size[1], self.size[0])
        return results

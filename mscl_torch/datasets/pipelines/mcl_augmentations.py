"""Motion-guided cropping (MCL ablation), port of
``mscl_tpu/datasets/pipelines/mcl_augmentations.py``.

Reference mmaction/datasets/pipelines/mcl_augmentations.py —
MCLRandomResizedCrop (:114-180): compute a Sobel motion map (scipy's, as
the JAX module calls it) from a random flow frame, rejection-sample crop
boxes until the crop's top-20% motion mass exceeds a decaying threshold
(:54-99), then crop imgs and flow. The frame and the boxes are drawn from
the global ``np.random`` and Python ``random`` in the JAX module's order,
so the boxes are its boxes bit for bit.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..builder import PIPELINES
from .augmentations import (_crop_imgs, _update_crop_quadruple,
                            get_random_resized_crop_bbox)


def motion_map_from_flow(flow):
    """Sobel gradient magnitude over u and v (reference
    mcl_augmentations.py:54-66)."""
    u, v = flow[..., 0], flow[..., 1]
    grads = [ndimage.sobel(u, -1), ndimage.sobel(u, 0),
             ndimage.sobel(v, -1), ndimage.sobel(v, 0)]
    return np.sqrt(sum(np.square(g) for g in grads))


@PIPELINES.register_module()
class MCLRandomResizedCrop:
    """Motion-guided random resized crop (reference
    mcl_augmentations.py:102-230)."""

    def __init__(self, area_range=(0.2, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3), flow_key='flow_imgs',
                 top_rate=0.2, decay=0.9, max_attempts=10):
        self.area_range = tuple(area_range)
        self.aspect_ratio_range = tuple(aspect_ratio_range)
        self.flow_key = flow_key
        self.top_rate = top_rate
        self.decay = decay
        self.max_attempts = max_attempts

    def _motion_mass(self, mmap, bbox, thresh):
        l, t, r, b = bbox
        crop = mmap[t:b, l:r]
        if crop.size == 0:
            return 0.0
        k = max(int(crop.size * self.top_rate), 1)
        top = np.partition(crop.reshape(-1), -k)[-k:]
        return float(top.sum())

    def __call__(self, results):
        img_h, img_w = results['img_shape']
        flows = results.get('flows') or results.get(self.flow_key)
        frame = flows[np.random.randint(len(flows))]
        mmap = motion_map_from_flow(frame) if frame.shape[-1] == 2 \
            else np.linalg.norm(frame.astype(np.float32), axis=-1)
        fh, fw = mmap.shape
        k = max(int(mmap.size * self.top_rate), 1)
        total_top = np.partition(mmap.reshape(-1), -k)[-k:].sum()
        thresh = total_top * self.area_range[0]

        bbox = None
        for attempt in range(self.max_attempts):
            cand = get_random_resized_crop_bbox(
                (img_h, img_w), self.area_range, self.aspect_ratio_range)
            # evaluate mass at flow resolution
            l, t, r, b = cand
            fl = int(round(l * fw / img_w))
            ft = int(round(t * fh / img_h))
            fr = int(round(r * fw / img_w))
            fb = int(round(b * fh / img_h))
            if self._motion_mass(mmap, (fl, ft, fr, fb),
                                 thresh) >= thresh:
                bbox = cand
                break
            thresh *= self.decay
        if bbox is None:
            bbox = get_random_resized_crop_bbox(
                (img_h, img_w), self.area_range, self.aspect_ratio_range)

        left, top, right, bottom = bbox
        new_h, new_w = bottom - top, right - left
        _update_crop_quadruple(results, left, top, new_w, new_h,
                               img_w, img_h)
        results['crop_bbox'] = np.array(bbox)
        results['img_shape'] = (new_h, new_w)
        if 'imgs' in results:
            results['imgs'] = _crop_imgs(results['imgs'],
                                         np.array(bbox))
        fkey = 'flows' if 'flows' in results else self.flow_key
        if fkey in results:
            h_rate = fh / img_h
            w_rate = fw / img_w
            fbox = np.array([int(round(left * w_rate)),
                             int(round(top * h_rate)),
                             int(round(right * w_rate)),
                             int(round(bottom * h_rate))])
            results[fkey] = _crop_imgs(results[fkey], fbox)
        return results

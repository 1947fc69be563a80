"""MoCo paired-view crops, resize and normalize.

Port of ``mscl_tpu/datasets/pipelines/moco_augmentations.py`` (reference
mmaction moco_augmentations.py): ``MoCoDecodePlan`` (the JAX package's
decode plan: the q/k crop boxes drawn from the frame header, so LocalDecode
may decode a half at half scale), ``MoCoRandomResizedCrop`` (:11-211, two
independent crops replayed onto the flow at its resolution), ``MoCoResize``
(:214-360, the '_k' pass merges the branches) and ``MoCoNormalize``
(:363-393, /255 and HWC->CTHW). numpy out; the batch becomes tensors on the
device in ``apis.to_torch``.
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES
from ...utils.image_io import imresize, read_image_shape
from .augmentations import (_all_box_crop, _box_resize, _crop_imgs,
                            _update_crop_quadruple,
                            get_random_resized_crop_bbox, rescale_size)


@PIPELINES.register_module()
class MoCoDecodePlan:
    """Pre-sample the q/k random-resized-crop boxes from the image
    HEADER (no decode) so LocalDecode can use libjpeg's half-scale
    decode whenever a half's crop still strictly downsamples to the
    pipeline's target size (crop_dim/2 >= target_dim => no quality
    loss; ~1.4x faster per reduced frame, measured on 256x340 recipe
    JPEGs). Host-decode optimization only — no reference counterpart;
    the crop DISTRIBUTION is byte-identical (same sampler,
    get_random_resized_crop_bbox, as MoCoRandomResizedCrop, which
    consumes the pre-sampled boxes instead of resampling).

    Place after the frame sampler, before LocalDecode, mirroring the
    crop op's area/aspect params:

        dict(type='MoCoDecodePlan', target=image_shape,
             area_range=(0.2, 1.0)),
        dict(type='LocalDecode'),
        ...
        dict(type='MoCoRandomResizedCrop', area_range=(0.2, 1.0), ...)

    No-ops (leaving baseline full-res behavior) when the header is
    unreadable or the sample carries gt_bboxes.
    """

    def __init__(self, target, area_range=(0.08, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3)):
        if isinstance(target, (int, float)):
            target = (int(target), int(target))
        self.target = (int(target[0]), int(target[1]))  # (h, w)
        self.area_range = tuple(area_range)
        self.aspect_ratio_range = tuple(aspect_ratio_range)

    def _reduce_factor(self, bbox):
        left, top, right, bottom = bbox
        th, tw = self.target
        return 2 if ((right - left) // 2 >= tw and
                     (bottom - top) // 2 >= th) else 1

    def __call__(self, results):
        if 'img_paths' not in results or 'gt_bboxes' in results:
            return results
        inds = results['frame_inds']
        first = int(np.asarray(inds).reshape(-1)[0]) + \
            results.get('offset', 0)
        shape = read_image_shape(results['img_paths'][first])
        if shape is None:
            return results
        crop_q = get_random_resized_crop_bbox(
            shape, self.area_range, self.aspect_ratio_range)
        crop_k = get_random_resized_crop_bbox(
            shape, self.area_range, self.aspect_ratio_range)
        results['moco_plan'] = dict(
            crop_q=crop_q, crop_k=crop_k,
            reduce_q=self._reduce_factor(crop_q),
            reduce_k=self._reduce_factor(crop_k),
            full_shape=shape)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(target={self.target}, '
                f'area_range={self.area_range})')


@PIPELINES.register_module()
class MoCoRandomResizedCrop:
    """Two independent random resized crops over the q/k halves of the frame
    list; crops replayed onto the flow frames at flow resolution."""

    def __init__(self, area_range=(0.08, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3), lazy=False,
                 flow_key=None):
        assert not lazy
        self.area_range = tuple(area_range)
        self.aspect_ratio_range = tuple(aspect_ratio_range)
        self.flow_key = flow_key

    def single_cal(self, imgs, results, flows=None, suffix='_q',
                   plan=None):
        if plan is not None:
            # crop pre-sampled by MoCoDecodePlan in FULL-res coords;
            # map to this half's (possibly half-scale-decoded) coords
            full_h, full_w = plan['full_shape']
            img_h, img_w = results['img_shape_dec' + suffix]
            fl, ft, fr, fb = plan['crop' + suffix]
            sw, sh = img_w / full_w, img_h / full_h
            left, top = int(round(fl * sw)), int(round(ft * sh))
            right = min(int(round(fr * sw)), img_w)
            bottom = min(int(round(fb * sh)), img_h)
        else:
            img_h, img_w = results['img_shape']
            left, top, right, bottom = get_random_resized_crop_bbox(
                (img_h, img_w), self.area_range, self.aspect_ratio_range)
        new_h, new_w = bottom - top, right - left

        if 'crop_quadruple' in results:
            results['crop_quadruple' + suffix] = results['crop_quadruple']
        _update_crop_quadruple(results, left, top, new_w, new_h,
                               img_w, img_h, key='crop_quadruple' + suffix)

        crop_bbox = np.array([left, top, right, bottom])
        results['crop_bbox' + suffix] = crop_bbox
        results['img_shape' + suffix] = (new_h, new_w)
        results['imgs' + suffix] = _crop_imgs(imgs, crop_bbox)

        if 'gt_bboxes' in results:
            boxed = dict(gt_bboxes=results['gt_bboxes'])
            if 'proposals' in results:
                boxed['proposals'] = results['proposals']
            boxed = _all_box_crop(boxed, crop_bbox)
            results['gt_bboxes' + suffix] = boxed['gt_bboxes']
            if 'proposals' in boxed:
                results['proposals' + suffix] = boxed['proposals']

        if flows is not None:
            # replay the crop at the flow resolution (reference
            # moco_augmentations.py:152-162); under a decode plan the
            # replay uses the FULL-res bbox and dims so the flow crop is
            # byte-identical to the no-plan pipeline
            rl, rt, rr, rb = (plan['crop' + suffix] if plan is not None
                              else (left, top, right, bottom))
            if 'flow_im_rate' in results:
                h_rate, w_rate = results['flow_im_rate']
            else:
                base_h, base_w = (plan['full_shape'] if plan is not None
                                  else (img_h, img_w))
                flow_h, flow_w = flows[0].shape[0], flows[0].shape[1]
                h_rate, w_rate = flow_h / base_h, flow_w / base_w
            crop_bbox_flow = np.array([
                int(round(rl * w_rate)), int(round(rt * h_rate)),
                int(round(rr * w_rate)), int(round(rb * h_rate))])
            results[self.flow_key + suffix] = _crop_imgs(flows,
                                                         crop_bbox_flow)
        return results

    def __call__(self, results):
        clip_len = results['clip_len']
        imgs = results['imgs']
        imgs_len = len(imgs)
        # q/k split: when the sampler emitted 2 clips the list holds both
        if clip_len == imgs_len:
            imgs_q, imgs_k = imgs, imgs
        else:
            imgs_q, imgs_k = imgs[:imgs_len // 2], imgs[imgs_len // 2:]
        flows_q = flows_k = None
        if self.flow_key:
            flows = results[self.flow_key]
            if clip_len == imgs_len:
                flows_q, flows_k = flows, flows
            else:
                flows_len = len(flows)
                flows_q = flows[:flows_len // 2]
                flows_k = flows[flows_len // 2:]
        plan = results.pop('moco_plan', None)
        results = self.single_cal(imgs_q, results, flows_q, suffix='_q',
                                  plan=plan)
        results = self.single_cal(imgs_k, results, flows_k, suffix='_k',
                                  plan=plan)
        results['img_shape'] = results['img_shape_q']
        del results['imgs']
        if self.flow_key:
            del results[self.flow_key]
        if 'gt_bboxes' in results:
            del results['gt_bboxes']
            results.pop('proposals', None)
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(area_range={self.area_range}, '
                f'aspect_ratio_range={self.aspect_ratio_range})')


@PIPELINES.register_module()
class MoCoResize:
    """Suffix-aware resize; on the '_k' pass merges the q/k branches into
    paired lists (reference moco_augmentations.py:214-360)."""

    def __init__(self, scale, keep_ratio=False, interpolation='bilinear',
                 lazy=False, suffix='', flow_key='flow_imgs'):
        assert not lazy
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
        self.suffix = suffix
        self.flow_key = flow_key

    def _fn(self, name):
        return name + self.suffix

    def _resize_imgs(self, imgs, new_w, new_h):
        return [imresize(img, (new_w, new_h), self.interpolation)
                for img in imgs]

    def __call__(self, results):
        if self._fn('scale_factor') not in results:
            results[self._fn('scale_factor')] = np.array([1, 1],
                                                         dtype=np.float32)
        img_h, img_w = results[self._fn('img_shape')]
        if self.keep_ratio:
            new_w, new_h = rescale_size((img_w, img_h), self.scale)
        else:
            new_w, new_h = self.scale
        scale_factor = np.array([new_w / img_w, new_h / img_h],
                                dtype=np.float32)
        results[self._fn('img_shape')] = (new_h, new_w)
        results[self._fn('keep_ratio')] = self.keep_ratio
        results[self._fn('scale_factor')] = (
            results[self._fn('scale_factor')] * scale_factor)
        if self._fn('imgs') in results:
            results[self._fn('imgs')] = self._resize_imgs(
                results[self._fn('imgs')], new_w, new_h)
        if self.flow_key:
            results[self._fn(self.flow_key)] = self._resize_imgs(
                results[self._fn(self.flow_key)], new_w, new_h)
        if self._fn('gt_bboxes') in results:
            results[self._fn('gt_bboxes')] = _box_resize(
                results[self._fn('gt_bboxes')], scale_factor)
            if self._fn('proposals') in results and \
                    results[self._fn('proposals')] is not None:
                results[self._fn('proposals')] = _box_resize(
                    results[self._fn('proposals')], scale_factor)
        # merge the two branches after the second (_k) pass
        if self.suffix == '_k':
            results['imgs'] = [results['imgs_q'], results['imgs_k']]
            if self.flow_key:
                results[self.flow_key] = [results[self.flow_key + '_q'],
                                          results[self.flow_key + '_k']]
            results['img_shape'] = results['img_shape_q']
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(scale={self.scale}, '
                f'suffix={self.suffix!r})')


@PIPELINES.register_module()
class MoCoNormalize:
    """/255 + HWC->CTHW for both branches of imgs and flow_imgs
    (reference moco_augmentations.py:363-393). ``ori_flow=True`` skips /255
    for already-normalized flow."""

    def __init__(self, ori_flow=False):
        self.ori_flow = ori_flow

    def __call__(self, results):
        for idx in range(2):
            # one fused uint8->f32 divide (bit-identical to
            # astype(f32)/255.0, two fewer full-tensor copies), writing
            # THROUGH the CTHW transpose view so the output is already
            # C-contiguous in CTHW — ToTensor's ascontiguousarray then
            # becomes a no-op (one full f32 copy saved per branch)
            imgs = np.divide(
                np.stack(results['imgs'][idx]).transpose((3, 0, 1, 2)),
                255.0, dtype=np.float32)
            results['imgs'][idx] = imgs
            if 'flow_imgs' in results:
                # stack CHW views along axis=1 -> the single stack copy
                # lands directly CTHW-contiguous (see imgs note above)
                flows = np.stack([f.transpose((2, 0, 1))
                                  for f in results['flow_imgs'][idx]],
                                 axis=1)
                if not self.ori_flow:
                    flows = np.divide(flows, 255.0, dtype=np.float32)
                elif flows.dtype != np.float32:
                    flows = flows.astype(np.float32)
                results['flow_imgs'][idx] = flows
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(ori_flow={self.ori_flow})'


@PIPELINES.register_module()
class MoCoNormalizeV2(MoCoNormalize):
    """MoCoNormalize, and raw 'flows' of both branches stacked and
    transposed to CTHW in float32 (reference moco_augmentations.py:396-423)."""

    def __call__(self, results):
        results = super().__call__(results)
        if 'flows' in results:
            for idx in range(2):
                flows = np.stack(results['flows'][idx])
                if flows.dtype != np.float32:
                    flows = flows.astype(np.float32)
                results['flows'][idx] = flows.transpose((3, 0, 1, 2))
        return results


"""The skeleton pipeline of PoseC3D: frame sampling, pose gathering, pseudo
heatmaps.

Port of ``mscl_tpu/datasets/pipelines/pose_loading.py`` (reference mmaction
pipelines/pose_loading.py:14-631), numpy throughout:

- ``UniformSampleFrames``: one frame a segment, in the reference's three
  regimes (fewer frames than ``clip_len``, fewer than twice, more); in test
  mode it reseeds the global ``np.random`` with ``seed`` (255), as the JAX
  package does, so a video's test clips are the same every time;
- ``PoseDecode``: the keypoints and scores of the sampled frames;
- ``GeneratePoseTarget``: a Gaussian pseudo-heatmap a joint and/or a
  segment-distance heatmap a limb (COCO's 17 keypoints by default), the
  maximum over persons, with the flipped copy (``double``) after it;
- ``LoadKineticsPose``: Kinetics-Pose detections regrouped into persons,
  ranked by their weighted confidences beyond ``max_person``;
- ``PoseCompact``: the coordinate frame cropped to a padded box around the
  keypoints.

The draws come from the global ``np.random`` in the JAX package's order.
Consumed by ``PoseDataset`` (``datasets/misc_datasets.py``).
"""
from __future__ import annotations

import copy as cp

import numpy as np

from ..builder import PIPELINES

_COCO_SKELETONS = ((0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (5, 7),
                   (7, 9), (0, 6), (6, 8), (8, 10), (5, 11), (11, 13),
                   (13, 15), (6, 12), (12, 14), (14, 16), (11, 12))
_COCO_LEFT = (1, 3, 5, 7, 9, 11, 13, 15)
_COCO_RIGHT = (2, 4, 6, 8, 10, 12, 14, 16)


@PIPELINES.register_module()
class UniformSampleFrames:
    """reference pose_loading.py:14-140."""

    def __init__(self, clip_len, num_clips=1, test_mode=False, seed=255):
        self.clip_len = clip_len
        self.num_clips = num_clips
        self.test_mode = test_mode
        self.seed = seed

    def _one_clip(self, num_frames, clip_len, rng):
        if num_frames < clip_len:
            start = rng.randint(0, num_frames)
            return np.arange(start, start + clip_len)
        if num_frames < 2 * clip_len:
            basic = np.arange(clip_len)
            picks = rng.choice(clip_len + 1, num_frames - clip_len,
                               replace=False)
            offset = np.zeros(clip_len + 1, np.int64)
            offset[picks] = 1
            return basic + np.cumsum(offset)[:-1]
        bids = np.array([i * num_frames // clip_len
                         for i in range(clip_len + 1)])
        bsize = np.diff(bids)
        return bids[:clip_len] + rng.randint(bsize)

    def __call__(self, results):
        num_frames = results['total_frames']
        if self.test_mode:
            np.random.seed(self.seed)
            if num_frames < self.clip_len:
                if num_frames < self.num_clips:
                    starts = list(range(self.num_clips))
                else:
                    starts = [i * num_frames // self.num_clips
                              for i in range(self.num_clips)]
                inds = np.concatenate(
                    [np.arange(s, s + self.clip_len) for s in starts])
            else:
                inds = np.concatenate(
                    [self._one_clip(num_frames, self.clip_len, np.random)
                     for _ in range(self.num_clips)])
        else:
            assert self.num_clips == 1
            inds = self._one_clip(num_frames, self.clip_len, np.random)
        inds = np.mod(inds, num_frames) + results['start_index']
        results['frame_inds'] = inds.astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = None
        results['num_clips'] = self.num_clips
        return results


@PIPELINES.register_module()
class PoseDecode:
    """reference pose_loading.py:142-196 — keypoints arrive as
    (num_persons, total_frames, K, 2) / scores (num_persons,
    total_frames, K); gather the sampled frames."""

    def __call__(self, results):
        if 'frame_inds' not in results:
            results['frame_inds'] = np.arange(results['total_frames'])
        if results['frame_inds'].ndim != 1:
            results['frame_inds'] = np.squeeze(results['frame_inds'])
        inds = results['frame_inds'] + results.get('offset', 0)
        for key, src in (('keypoint_score', 'kpscore'),
                         ('keypoint', 'kp')):
            if key not in results and src in results:
                results[key] = results.pop(src)
        if 'keypoint_score' in results:
            results['keypoint_score'] = \
                results['keypoint_score'][:, inds].astype(np.float32)
        if 'keypoint' in results:
            results['keypoint'] = \
                results['keypoint'][:, inds].astype(np.float32)
        return results


@PIPELINES.register_module()
class GeneratePoseTarget:
    """reference pose_loading.py:349-631."""

    def __init__(self, sigma=0.6, use_score=True, with_kp=True,
                 with_limb=False, skeletons=_COCO_SKELETONS,
                 double=False, left_kp=_COCO_LEFT,
                 right_kp=_COCO_RIGHT):
        assert with_kp or with_limb
        self.sigma = sigma
        self.use_score = use_score
        self.with_kp = with_kp
        self.with_limb = with_limb
        self.skeletons = skeletons
        self.double = double
        self.left_kp = left_kp
        self.right_kp = right_kp
        self.eps = 1e-4

    def _kp_heatmap(self, img_h, img_w, centers, sigma, max_values):
        heatmap = np.zeros((img_h, img_w), np.float32)
        for center, max_value in zip(centers, max_values):
            if max_value < self.eps:
                continue
            mu_x, mu_y = center
            st_x = max(int(mu_x - 3 * sigma), 0)
            ed_x = min(int(mu_x + 3 * sigma) + 1, img_w)
            st_y = max(int(mu_y - 3 * sigma), 0)
            ed_y = min(int(mu_y + 3 * sigma) + 1, img_h)
            x = np.arange(st_x, ed_x, 1, np.float32)
            y = np.arange(st_y, ed_y, 1, np.float32)[:, None]
            if not (x.size and y.size):
                continue
            patch = np.exp(-((x - mu_x) ** 2 + (y - mu_y) ** 2) /
                           (2 * sigma ** 2)) * max_value
            heatmap[st_y:ed_y, st_x:ed_x] = np.maximum(
                heatmap[st_y:ed_y, st_x:ed_x], patch)
        return heatmap

    def _limb_heatmap(self, img_h, img_w, starts, ends, sigma,
                      start_values, end_values):
        heatmap = np.zeros((img_h, img_w), np.float32)
        for start, end, sv, ev in zip(starts, ends, start_values,
                                      end_values):
            value = min(sv, ev)
            if value < self.eps:
                continue
            min_x = max(int(min(start[0], end[0]) - 3 * sigma), 0)
            max_x = min(int(max(start[0], end[0]) + 3 * sigma) + 1,
                        img_w)
            min_y = max(int(min(start[1], end[1]) - 3 * sigma), 0)
            max_y = min(int(max(start[1], end[1]) + 3 * sigma) + 1,
                        img_h)
            x = np.arange(min_x, max_x, 1, np.float32)
            y = np.arange(min_y, max_y, 1, np.float32)[:, None]
            if not (x.size and y.size):
                continue
            d2_start = (x - start[0]) ** 2 + (y - start[1]) ** 2
            d2_end = (x - end[0]) ** 2 + (y - end[1]) ** 2
            d2_ab = ((start[0] - end[0]) ** 2 +
                     (start[1] - end[1]) ** 2)
            if d2_ab < 1:
                heatmap = np.maximum(
                    heatmap, self._kp_heatmap(img_h, img_w, [start],
                                              sigma, [sv]))
                continue
            coeff = (d2_start - d2_end + d2_ab) / 2.0 / d2_ab
            a_dom = coeff <= 0
            b_dom = coeff >= 1
            seg_dom = 1 - a_dom - b_dom
            px = x + np.zeros_like(y)
            py = y + np.zeros_like(x)
            proj_x = start[0] + coeff * (end[0] - start[0])
            proj_y = start[1] + coeff * (end[1] - start[1])
            d2_line = (px - proj_x) ** 2 + (py - proj_y) ** 2
            d2_seg = a_dom * d2_start + b_dom * d2_end + seg_dom * d2_line
            patch = np.exp(-d2_seg / (2 * sigma ** 2)) * value
            heatmap[min_y:max_y, min_x:max_x] = np.maximum(
                heatmap[min_y:max_y, min_x:max_x], patch)
        return heatmap

    def _frame_heatmaps(self, img_h, img_w, kps, max_values):
        maps = []
        if self.with_kp:
            for i in range(kps.shape[1]):
                maps.append(self._kp_heatmap(
                    img_h, img_w, kps[:, i], self.sigma,
                    max_values[:, i]))
        if self.with_limb:
            for s_idx, e_idx in self.skeletons:
                maps.append(self._limb_heatmap(
                    img_h, img_w, kps[:, s_idx], kps[:, e_idx],
                    self.sigma, max_values[:, s_idx],
                    max_values[:, e_idx]))
        return np.stack(maps, axis=-1)

    def _gen(self, results):
        all_kps = results['keypoint']
        all_scores = results.get(
            'keypoint_score',
            np.ones(all_kps.shape[:-1], np.float32))
        img_h, img_w = results['img_shape']
        out = []
        for t in range(all_kps.shape[1]):
            max_values = all_scores[:, t] if self.use_score else \
                np.ones(all_scores[:, t].shape, np.float32)
            out.append(self._frame_heatmaps(img_h, img_w,
                                            all_kps[:, t], max_values))
        return out

    def _flip(self, results):
        """Horizontal flip of keypoints + left/right swap."""
        r = cp.deepcopy(results)
        img_w = r['img_shape'][1]
        kp = r['keypoint'].copy()
        kp[..., 0] = img_w - 1 - kp[..., 0]
        order = list(range(kp.shape[2]))
        for l, rk in zip(self.left_kp, self.right_kp):
            order[l], order[rk] = order[rk], order[l]
        r['keypoint'] = kp[:, :, order]
        if 'keypoint_score' in r:
            r['keypoint_score'] = r['keypoint_score'][:, :, order]
        return r

    def __call__(self, results):
        if not self.double:
            results['imgs'] = np.stack(self._gen(results))
        else:
            results['imgs'] = np.concatenate(
                [np.stack(self._gen(results)),
                 np.stack(self._gen(self._flip(results)))])
        return results


@PIPELINES.register_module()
class LoadKineticsPose:
    """Load Kinetics-Pose pickles: per-detection (K, 3) keypoint rows
    with their frame indices are regrouped into dense
    (num_person, T, K, 2) + score arrays; when persons exceed
    max_person, per-frame detections are ranked by the weighted sum of
    face/torso/limb confidences (reference pose_loading.py:198-346)."""

    _SUBSETS = {
        'openpose': dict(face=[0, 14, 15, 16, 17],
                         torso=[1, 2, 8, 5, 11],
                         limb=[3, 4, 6, 7, 9, 10, 12, 13]),
        'mmpose': dict(face=[0, 1, 2, 3, 4],
                       torso=[5, 6, 11, 12],
                       limb=[7, 8, 9, 10, 13, 14, 15, 16]),
    }

    def __init__(self, io_backend='disk', squeeze=True, max_person=100,
                 keypoint_weight=dict(face=1, torso=2, limb=3),
                 source='mmpose', **kwargs):
        assert source in self._SUBSETS, source
        self.squeeze = squeeze
        self.max_person = max_person
        self.keypoint_weight = dict(keypoint_weight)
        self.source = source
        self.kpsubset = self._SUBSETS[source]

    def __call__(self, results):
        import pickle
        filename = results.pop('filename')
        anno_inds = results.pop('anno_inds', None)
        results.pop('box_score', None)
        with open(filename, 'rb') as f:
            kps = pickle.load(f)
        kps = np.asarray(kps, np.float32)
        total_frames = results['total_frames']
        frame_inds = np.asarray(results.pop('frame_inds'))
        if anno_inds is not None:
            assert self.source == 'mmpose'
            kps = kps[anno_inds]
            frame_inds = frame_inds[anno_inds]

        if self.squeeze:
            uni = np.unique(frame_inds)
            remap = {int(x): i for i, x in enumerate(uni)}
            frame_inds = np.array([remap[int(x)] for x in frame_inds],
                                  np.int64)
            total_frames = int(frame_inds.max()) + 1
        results['total_frames'] = total_frames

        h, w = results['img_shape']
        if self.source == 'openpose':
            kps[:, :, 0] *= w
            kps[:, :, 1] *= h

        num_kp = kps.shape[1]
        counts = np.bincount(frame_inds, minlength=total_frames)
        num_person = int(counts.max())
        new_kp = np.zeros((num_person, total_frames, num_kp, 2),
                          np.float16)
        new_score = np.zeros((num_person, total_frames, num_kp),
                             np.float16)
        slot = np.zeros(total_frames, np.int64)
        for fi, kp in zip(frame_inds, kps):
            new_kp[slot[fi], fi] = kp[:, :2]
            new_score[slot[fi], fi] = kp[:, 2]
            slot[fi] += 1

        results['num_person'] = num_person
        if num_person > self.max_person:
            grp, wgt = self.kpsubset, self.keypoint_weight
            for i in range(total_frames):
                n = slot[i]
                val = new_score[:n, i]
                score = (val[:, grp['face']].sum(1) * wgt['face'] +
                         val[:, grp['torso']].sum(1) * wgt['torso'] +
                         val[:, grp['limb']].sum(1) * wgt['limb'])
                order = np.argsort(-score)
                new_score[:n, i] = new_score[order, i]
                new_kp[:n, i] = new_kp[order, i]
            results['num_person'] = self.max_person
        results['keypoint'] = new_kp[:self.max_person]
        results['keypoint_score'] = new_score[:self.max_person]
        return results


@PIPELINES.register_module()
class PoseCompact:
    """Crop the coordinate frame to a padded tight box around all
    keypoints (reference augmentations.py PoseCompact: tight box over
    nonzero joints, expanded by ``padding``, optional hw_ratio clamp,
    optionally allowed to pad outside the image)."""

    def __init__(self, padding=0.25, threshold=10, hw_ratio=None,
                 allow_imgpad=True):
        assert padding >= 0
        self.padding = padding
        self.threshold = threshold
        if hw_ratio is not None and not isinstance(hw_ratio,
                                                   (tuple, list)):
            hw_ratio = (hw_ratio, hw_ratio)
        self.hw_ratio = hw_ratio
        self.allow_imgpad = allow_imgpad

    def __call__(self, results):
        h, w = results['img_shape']
        kp = results['keypoint']
        kp[np.isnan(kp)] = 0.0
        kp_x, kp_y = kp[..., 0], kp[..., 1]
        min_x = np.min(kp_x[kp_x != 0], initial=np.inf)
        min_y = np.min(kp_y[kp_y != 0], initial=np.inf)
        max_x = np.max(kp_x[kp_x != 0], initial=-np.inf)
        max_y = np.max(kp_y[kp_y != 0], initial=-np.inf)
        if max_x - min_x < self.threshold or \
                max_y - min_y < self.threshold:
            return results

        center = ((max_x + min_x) / 2, (max_y + min_y) / 2)
        half_width = (max_x - min_x) / 2 * (1 + self.padding)
        half_height = (max_y - min_y) / 2 * (1 + self.padding)
        if self.hw_ratio is not None:
            half_height = max(self.hw_ratio[0] * half_width, half_height)
            half_width = max(1 / self.hw_ratio[1] * half_height,
                             half_width)
        min_x, max_x = center[0] - half_width, center[0] + half_width
        min_y, max_y = center[1] - half_height, center[1] + half_height
        if not self.allow_imgpad:
            min_x, min_y = int(max(0, min_x)), int(max(0, min_y))
            max_x, max_y = int(min(w, max_x)), int(min(h, max_y))
        else:
            min_x, min_y = int(min_x), int(min_y)
            max_x, max_y = int(max_x), int(max_y)

        kp_x[kp_x != 0] -= min_x
        kp_y[kp_y != 0] -= min_y
        results['img_shape'] = (max_y - min_y, max_x - min_x)
        old = results.get('crop_quadruple', (0., 0., 1., 1.))
        new = (min_x / w, min_y / h, (max_x - min_x) / w,
               (max_y - min_y) / h)
        results['crop_quadruple'] = (
            old[0] + new[0] * old[2], old[1] + new[1] * old[3],
            new[2] * old[2], new[3] * old[3])
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(padding={self.padding}, '
                f'threshold={self.threshold}, hw_ratio={self.hw_ratio}, '
                f'allow_imgpad={self.allow_imgpad})')

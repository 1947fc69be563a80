"""Frame sampling and decoding transforms.

Port of ``mscl_tpu/datasets/pipelines/loading.py``, the parts the shipped
configs' pipelines run: the clip-offset samplers, ``SampleFrames``
(reference mmaction loading.py:83-270), ``DenseSampleFrames``,
``UntrimmedSampleFrames``, ``RawFrameDecode`` (a frame directory's
``filename_tmpl`` files: RGB frames, or a flow's x and y grey frames
interleaved), ``ImageDecode`` and ``BuildPseudoClip`` (an image as a
one-frame clip, repeated ``clip_len`` times), ``LocalDecode`` (the
reference's NoriDecode, loading.py:1812-1914, re-targeted at the local
filesystem; ``NoriDecode`` is an alias) and ``ArrayDecode``. Frames are
decoded by ``mscl_torch.utils.image_io`` (PNG and JPEG without cv2); flows
are ``.npy`` or ``.np4`` (``mscl_torch.utils.np4``, without msgpack). The
samplers draw from the global ``np.random`` in the JAX package's order.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..builder import PIPELINES
from ...utils.image_io import imread_grey, imread_rgb
from ...utils.np4 import np4_decode


def _sample_train_offsets(num_frames, clip_len, frame_interval, num_clips,
                          keep_tail_frames=False):
    """Train-mode clip offsets (reference loading.py:137-179)."""
    ori_clip_len = clip_len * frame_interval
    if keep_tail_frames:
        avg_interval = (num_frames - ori_clip_len + 1) / float(num_clips)
        if num_frames > ori_clip_len - 1:
            base_offsets = np.arange(num_clips) * avg_interval
            clip_offsets = (base_offsets + np.random.uniform(
                0, avg_interval, num_clips)).astype(np.int64)
        else:
            clip_offsets = np.zeros((num_clips,), dtype=np.int64)
        return clip_offsets
    avg_interval = (num_frames - ori_clip_len + 1) // num_clips
    if avg_interval > 0:
        base_offsets = np.arange(num_clips) * avg_interval
        clip_offsets = base_offsets + np.random.randint(
            avg_interval, size=num_clips)
    elif num_frames > max(num_clips, ori_clip_len):
        clip_offsets = np.sort(np.random.randint(
            num_frames - ori_clip_len + 1, size=num_clips))
    elif avg_interval == 0:
        ratio = (num_frames - ori_clip_len + 1.0) / num_clips
        clip_offsets = np.around(np.arange(num_clips) * ratio)
    else:
        clip_offsets = np.zeros((num_clips,), dtype=np.int64)
    return clip_offsets.astype(np.int64)


def _sample_test_offsets(num_frames, clip_len, frame_interval, num_clips,
                         twice_sample=False):
    """Test-mode clip offsets (reference loading.py:181-204)."""
    ori_clip_len = clip_len * frame_interval
    avg_interval = (num_frames - ori_clip_len + 1) / float(num_clips)
    if num_frames > ori_clip_len - 1:
        base_offsets = np.arange(num_clips) * avg_interval
        clip_offsets = (base_offsets + avg_interval / 2.0).astype(np.int64)
        if twice_sample:
            clip_offsets = np.concatenate(
                [clip_offsets, base_offsets.astype(np.int64)])
    else:
        clip_offsets = np.zeros((num_clips,), dtype=np.int64)
    return clip_offsets


def expand_offsets_to_inds(clip_offsets, clip_len, frame_interval,
                           total_frames, out_of_bound_opt='loop',
                           temporal_jitter=False):
    """Offsets -> flat frame indices with OOB handling
    (reference loading.py:222-253)."""
    frame_inds = clip_offsets[:, None] + np.arange(
        clip_len)[None, :] * frame_interval
    frame_inds = np.concatenate(frame_inds)
    if temporal_jitter:
        perframe_offsets = np.random.randint(
            frame_interval, size=len(frame_inds))
        frame_inds += perframe_offsets
    frame_inds = frame_inds.reshape((-1, clip_len))
    if out_of_bound_opt == 'loop':
        frame_inds = np.mod(frame_inds, total_frames)
    elif out_of_bound_opt == 'repeat_last':
        safe_inds = frame_inds < total_frames
        unsafe_inds = 1 - safe_inds
        last_ind = np.max(safe_inds * frame_inds, axis=1)
        frame_inds = (safe_inds * frame_inds + (unsafe_inds.T * last_ind).T)
    else:
        raise ValueError('Illegal out_of_bound option.')
    return np.concatenate(frame_inds)


@PIPELINES.register_module()
class SampleFrames:
    """Sample clip_len frames x num_clips from a video
    (reference loading.py:83-270)."""

    def __init__(self, clip_len, frame_interval=1, num_clips=1,
                 temporal_jitter=False, twice_sample=False,
                 out_of_bound_opt='loop', test_mode=False,
                 start_index=None, keep_tail_frames=False):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode
        self.keep_tail_frames = keep_tail_frames
        assert self.out_of_bound_opt in ('loop', 'repeat_last')

    def _sample_clips(self, num_frames):
        if self.test_mode:
            return _sample_test_offsets(num_frames, self.clip_len,
                                        self.frame_interval, self.num_clips,
                                        self.twice_sample)
        return _sample_train_offsets(num_frames, self.clip_len,
                                     self.frame_interval, self.num_clips,
                                     self.keep_tail_frames)

    def __call__(self, results):
        total_frames = results['total_frames']
        clip_offsets = self._sample_clips(total_frames)
        frame_inds = expand_offsets_to_inds(
            clip_offsets, self.clip_len, self.frame_interval, total_frames,
            self.out_of_bound_opt, self.temporal_jitter)
        start_index = results['start_index']
        results['frame_inds'] = (frame_inds + start_index).astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = self.num_clips
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(clip_len={self.clip_len}, '
                f'frame_interval={self.frame_interval}, '
                f'num_clips={self.num_clips}, test_mode={self.test_mode})')


@PIPELINES.register_module()
class DenseSampleFrames(SampleFrames):
    """Clips at a fixed interval inside a ``sample_range``-frame window:
    one window at a random start in training, ``num_sample_positions``
    evenly spaced windows in test mode (mmaction DenseSampleFrames)."""

    def __init__(self, *args, sample_range=64, num_sample_positions=10,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.sample_range = sample_range
        self.num_sample_positions = num_sample_positions

    def _get_train_clips(self, num_frames):
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start_idx = 0 if sample_position == 1 else np.random.randint(
            0, sample_position - 1)
        base_offsets = np.arange(self.num_clips) * interval
        return (base_offsets + start_idx) % num_frames

    def _get_test_clips(self, num_frames):
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        start_list = np.linspace(0, sample_position - 1,
                                 num=self.num_sample_positions, dtype=int)
        base_offsets = np.arange(self.num_clips) * interval
        clip_offsets = []
        for start_idx in start_list:
            clip_offsets.extend((base_offsets + start_idx) % num_frames)
        return np.array(clip_offsets)

    def _sample_clips(self, num_frames):
        if self.test_mode:
            return self._get_test_clips(num_frames)
        return self._get_train_clips(num_frames)


@PIPELINES.register_module()
class UntrimmedSampleFrames:
    """Clip centres every ``frame_interval`` frames over an untrimmed
    video, from ``frame_interval // 2``, each widened to ``clip_len``
    frames and clipped to the video (reference loading.py
    UntrimmedSampleFrames)."""

    def __init__(self, clip_len=1, frame_interval=16, start_index=None):
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.start_index = start_index

    def __call__(self, results):
        total_frames = results['total_frames']
        start_index = self.start_index if self.start_index is not None \
            else results.get('start_index', 0)
        clip_centers = np.arange(self.frame_interval // 2, total_frames,
                                 self.frame_interval)
        num_clips = clip_centers.shape[0]
        frame_inds = clip_centers[:, None] + np.arange(
            -(self.clip_len // 2),
            self.clip_len - (self.clip_len // 2))[None, :]
        frame_inds = np.clip(frame_inds, 0, total_frames - 1)
        results['frame_inds'] = (np.concatenate(frame_inds) +
                                 start_index).astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = num_clips
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(clip_len={self.clip_len}, '
                f'frame_interval={self.frame_interval})')


def _fmt_tmpl(tmpl, *args):
    """Filename templates come in both % ('img_%05d.jpg') and str.format
    ('img_{:05}.jpg') styles across the mm configs."""
    return tmpl % args if '%' in tmpl else tmpl.format(*args)


@PIPELINES.register_module()
class RawFrameDecode:
    """Load ``frame_dir``'s ``filename_tmpl`` frames at ``frame_inds``
    (plus ``offset``) (mmaction RawFrameDecode, disk backend): RGB frames
    (each file read once a call), or for 'Flow' the x and y grey frames of
    each index, interleaved; ``gt_bboxes`` and ``proposals`` scaled from
    [0, 1] to pixels."""

    def __init__(self, io_backend='disk', decoding_backend='cv2', **kwargs):
        assert io_backend == 'disk', 'only the disk backend is supported'
        self.io_backend = io_backend
        self.decoding_backend = decoding_backend

    def __call__(self, results):
        directory = results['frame_dir']
        filename_tmpl = results['filename_tmpl']
        if filename_tmpl is None:
            # the JAX RawFrameDecode fails on it too (a TypeError in
            # _fmt_tmpl, mscl_tpu/datasets/pipelines/loading.py:181)
            raise ValueError(f'RawFrameDecode needs a filename_tmpl for the '
                             f'frames of {directory}, not None')
        modality = results['modality']
        if results['frame_inds'].ndim != 1:
            results['frame_inds'] = np.squeeze(results['frame_inds'])
        offset = results.get('offset', 0)
        imgs = []
        cache = {}
        for frame_idx in results['frame_inds']:
            frame_idx = int(frame_idx) + offset
            if modality == 'RGB':
                if frame_idx not in cache:
                    cache[frame_idx] = imread_rgb(osp.join(
                        directory, _fmt_tmpl(filename_tmpl, frame_idx)))
                imgs.append(cache[frame_idx].copy())
            elif modality == 'Flow':
                for axis in ('x', 'y'):
                    imgs.append(imread_grey(osp.join(
                        directory, _fmt_tmpl(filename_tmpl, axis,
                                             frame_idx))))
            else:
                raise NotImplementedError(f'modality {modality}')
        results['imgs'] = imgs
        results['original_shape'] = imgs[0].shape[:2]
        results['img_shape'] = imgs[0].shape[:2]
        if 'gt_bboxes' in results:
            h, w = results['img_shape']
            scale_factor = np.array([w, h, w, h])
            results['gt_bboxes'] = (results['gt_bboxes'] *
                                    scale_factor).astype(np.float32)
            if 'proposals' in results and results['proposals'] is not None:
                results['proposals'] = (results['proposals'] *
                                        scale_factor).astype(np.float32)
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(io_backend={self.io_backend})'


def _load_flow_blob(path):
    """Raw float flow (H, W, 2) from .np4 (lz4+msgpack) or .npy."""
    if path.endswith('.npy'):
        return np.load(path)
    with open(path, 'rb') as f:
        buf = f.read()
    arr = np4_decode(buf)
    if arr is None:
        raise IOError(f'failed to decode flow blob: {path}')
    return arr


@PIPELINES.register_module()
class LocalDecode:
    """Filesystem equivalent of NoriDecode (reference loading.py:1812-1914).

    Reads, at every index in ``frame_inds``:
      - ``img_paths``       -> ``imgs``       (JPEG/PNG, RGB)
      - ``flow_img_paths``  -> ``flow_imgs``  (JPEG/PNG flow visualizations)
      - ``flow_paths``      -> ``flows``      (raw float flow, np4/npy)
      - ``gt_bboxes``       -> per-frame boxes, rescaled to pixel coords
    """
    im_keys = ('img_paths', 'flow_img_paths')
    flow_keys = ('flow_paths',)
    key_map = {'img_paths': 'imgs', 'flow_img_paths': 'flow_imgs',
               'flow_paths': 'flows'}

    def __call__(self, results):
        if results['frame_inds'].ndim != 1:
            results['frame_inds'] = np.squeeze(results['frame_inds'])
        offset = results.get('offset', 0)
        inds = [int(i) + offset for i in results['frame_inds']]
        plan = results.get('moco_plan')
        for im_key in self.im_keys:
            if im_key in results:
                paths = results[im_key]
                if plan is not None and im_key == 'img_paths':
                    results['imgs'] = self._decode_planned(paths, inds,
                                                           results, plan)
                    continue
                results[self.key_map[im_key]] = [
                    imread_rgb(paths[i]) for i in inds]
        for flow_key in self.flow_keys:
            if flow_key in results:
                paths = results[flow_key]
                results[self.key_map[flow_key]] = [
                    _load_flow_blob(paths[i]) for i in inds]
        if 'gt_bboxes' in results:
            boxes = results['gt_bboxes']
            results['gt_bboxes'] = ([boxes[i] for i in inds]
                                    if len(boxes) else np.zeros((0, 4)))
        imgs = results['imgs']
        results['original_shape'] = imgs[0].shape[:2]
        results['img_shape'] = imgs[0].shape[:2]
        if 'gt_bboxes' in results and len(results['gt_bboxes']):
            h, w = results['img_shape']
            scale = np.array([w, h, w, h])
            results['gt_bboxes'] = [
                (b * scale).astype(np.float32) for b in results['gt_bboxes']]
        return results

    def _decode_planned(self, paths, inds, results, plan):
        """Decode the q/k halves at the per-half reduce factor chosen by
        MoCoDecodePlan (half-scale libjpeg decode when that half's
        pre-sampled crop still strictly downsamples to the target).
        Records the per-half decoded shapes for the crop op."""
        n = len(inds)
        if results.get('clip_len') == n:
            # single clip shared by q and k: reduce only if BOTH allow
            f = min(plan['reduce_q'], plan['reduce_k'])
            imgs = [imread_rgb(paths[i], f) for i in inds]
        else:
            h = n // 2
            imgs = ([imread_rgb(paths[i], plan['reduce_q'])
                     for i in inds[:h]] +
                    [imread_rgb(paths[i], plan['reduce_k'])
                     for i in inds[h:]])
        results['img_shape_dec_q'] = imgs[0].shape[:2]
        results['img_shape_dec_k'] = imgs[-1].shape[:2]
        return imgs

    def __repr__(self):
        return f'{self.__class__.__name__}()'


# NoriDecode is accepted as a config alias so reference configs load
# unchanged; it decodes from the local filesystem.
PIPELINES.register_module(name='NoriDecode', module=LocalDecode)


@PIPELINES.register_module()
class ArrayDecode:
    """Pick frames from an in-memory ``array`` (T, H, W, C) at frame_inds —
    used by tests and synthetic benchmarks."""

    def __call__(self, results):
        if results['frame_inds'].ndim != 1:
            results['frame_inds'] = np.squeeze(results['frame_inds'])
        array = results['array']
        imgs = [array[int(i)].copy() for i in results['frame_inds']]
        results['imgs'] = imgs
        results['original_shape'] = imgs[0].shape[:2]
        results['img_shape'] = imgs[0].shape[:2]
        if 'flow_array' in results:
            results['flows'] = [results['flow_array'][int(i)].copy()
                                for i in results['frame_inds']]
        return results


@PIPELINES.register_module()
class ImageDecode:
    """Decode the image at ``filename`` to RGB as a one-frame list
    (mmaction ImageDecode, the OmniSource image sources; the JAX package's
    ``cv2.imread`` then BGR -> RGB, here ``image_io.imread_rgb``)."""

    def __init__(self, io_backend='disk', decoding_backend='cv2', **kwargs):
        self.io_backend = io_backend
        self.decoding_backend = decoding_backend

    def __call__(self, results):
        img = imread_rgb(results['filename'])
        results['imgs'] = [img]
        results['original_shape'] = img.shape[:2]
        results['img_shape'] = img.shape[:2]
        return results


@PIPELINES.register_module()
class BuildPseudoClip:
    """Repeat the single frame into a ``clip_len``-frame clip (one clip)."""

    def __init__(self, clip_len):
        self.clip_len = clip_len

    def __call__(self, results):
        im = results['imgs'][0]
        results['imgs'] = [np.copy(im) for _ in range(self.clip_len)]
        results['clip_len'] = self.clip_len
        results['num_clips'] = 1
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(clip_len={self.clip_len})'

"""MSCL sampling transforms: MatchFlow, AlignIndex, Seg2T, the MDS
samplers, the temporal-shift sampler and FlowToGT.

Port of ``mscl_tpu/datasets/pipelines/loading_mscl.py`` (reference
loading_mscl.py:52-69 MatchFlow, :9-35 AlignIndex, :72-107 Seg2T, :110-176
ChosenSampleFrames, :179-282 TemporalShiftChosenSampleFrames, :286-375
TemporalShiftSampleFrames; FlowToGT). Draws come from the global
``np.random`` in the JAX package's order, so the same seed gives the same
clips.
"""
from __future__ import annotations

import numpy as np

from ..builder import PIPELINES
from .loading import (SampleFrames, _sample_train_offsets,
                      expand_offsets_to_inds)

# local-filesystem keys that track the frame timeline (the reference tracks
# nori ids; we track file paths — same list semantics)
_SEQ_KEY = 'img_paths'
_FLOW_KEYS = ('flow_paths', 'flow_img_paths')


@PIPELINES.register_module()
class MatchFlow:
    """Subsample the RGB frame list onto the flow timeline: keep index
    ``i in range(0, len-adjacent, gap)`` — mirrors the offline extraction
    geometry (reference loading_mscl.py:52-69; extraction
    flow_extraction_meg.py:52-67 with num_flow=8, gap=2, adj=8)."""

    def __init__(self, gap=2, adjacent=8, flow_key='flow_paths'):
        self.gap = gap
        self.adjacent = adjacent
        # reference configs use nids_flow / nids_flow_img; map to local keys
        self.flow_key = {'nids_flow': 'flow_paths',
                         'nids_flow_img': 'flow_img_paths'}.get(
                             flow_key, flow_key)

    def __call__(self, results):
        seq = results[_SEQ_KEY]
        new_seq = [seq[idx]
                   for idx in range(0, len(seq) - self.adjacent, self.gap)]
        results[_SEQ_KEY] = new_seq
        results['total_frames'] = len(new_seq)
        assert len(new_seq) == len(results[self.flow_key]), \
            f'{len(new_seq)} vs {len(results[self.flow_key])}'
        return results

    def __repr__(self):
        return (f'{self.__class__.__name__}(gap={self.gap}, '
                f'adjacent={self.adjacent})')


@PIPELINES.register_module()
class AlignIndex:
    """Check the RGB timeline against the flow's length and align it (every
    ``gap``-th frame short of the last ``adjacent``; reference
    loading_mscl.py:9-35)."""

    def __init__(self, gap, adjacent):
        self.gap = gap
        self.adjacent = adjacent

    def __call__(self, results):
        len_flow = None
        for k in _FLOW_KEYS:
            if k in results:
                if len_flow is not None:
                    assert len(results[k]) == len_flow
                else:
                    len_flow = len(results[k])
        seq = results[_SEQ_KEY]
        len_img = len(seq)
        assert len_flow == (len_img - self.adjacent) // self.gap, \
            f'{len_flow} vs {len_img}'
        seq = seq[0:len_img - self.adjacent:self.gap]
        assert len(seq) == len_flow
        results[_SEQ_KEY] = seq
        results['total_frames'] = len(seq)
        return results


@PIPELINES.register_module()
class Seg2T:
    """Reshape N single-frame segments into one N-frame clip
    (reference loading_mscl.py:72-107; used by the fine-tune configs
    test_ssv2_r18.py:49,64,79)."""

    def __call__(self, results):
        if not isinstance(results['imgs'], np.ndarray):
            results['imgs'] = np.array(results['imgs'])
        imgs = results['imgs']
        num_clips = results['num_clips']
        clip_len = results['clip_len']
        assert clip_len == 1, 'Seg2T requires one frame per clip'
        # [M, H, W, C] with M = N_crops * num_clips * clip_len
        imgs = imgs.reshape((-1, num_clips, clip_len) + imgs.shape[1:])
        # -> N_crops x clip_len x C x num_clips(T) x H x W
        imgs = np.transpose(imgs, (0, 2, 5, 1, 3, 4))
        imgs = imgs.reshape((-1,) + imgs.shape[2:])
        results['imgs'] = imgs
        results['input_shape'] = imgs.shape
        results['num_clips'] = clip_len
        results['clip_len'] = num_clips
        return results

    def __repr__(self):
        return self.__class__.__name__


def _mds_offset(num_frames, clip_len, frame_interval, num_clips, chosen_idx,
                max_attempts=10):
    """Rejection-sample a train clip offset until it lands in chosen_idx
    (Motion Differential Sampling consumption; reference
    loading_mscl.py:119-136/210-232)."""
    chosen = set(int(c) for c in chosen_idx)
    cur_attempt = 0
    while True:
        clip_offsets = _sample_train_offsets(
            num_frames, clip_len, frame_interval, num_clips)
        assert clip_offsets.shape[0] == 1
        if int(clip_offsets[0]) in chosen:
            return clip_offsets
        cur_attempt += 1
        if cur_attempt > 10:
            cur_offset = int(chosen_idx[0]) if len(chosen_idx) else 0
            return np.array([cur_offset], dtype=np.int64)


class _MSCLSampleBase(SampleFrames):
    """Shared __call__ for the MDS samplers: expand offsets, handle OOB,
    write frame_inds/clip_len/frame_interval/num_clips."""

    num_clips_factor = 1

    def _sample_clips_with_chosen(self, total_frames, chosen_idx):
        raise NotImplementedError

    def __call__(self, results):
        total_frames = results['total_frames']
        chosen_idx = results['chosen_idx']
        clip_offsets = self._sample_clips_with_chosen(total_frames,
                                                      chosen_idx)
        frame_inds = expand_offsets_to_inds(
            clip_offsets, self.clip_len, self.frame_interval, total_frames,
            self.out_of_bound_opt, self.temporal_jitter)
        start_index = results['start_index']
        results['frame_inds'] = (frame_inds + start_index).astype(np.int64)
        results['clip_len'] = self.clip_len
        results['frame_interval'] = self.frame_interval
        results['num_clips'] = self.num_clips * self.num_clips_factor
        return results


@PIPELINES.register_module()
class ChosenSampleFrames(_MSCLSampleBase):
    """MDS sampling without the temporal shift (validation path;
    reference loading_mscl.py:110-176)."""

    def _sample_clips_with_chosen(self, total_frames, chosen_idx):
        if self.test_mode:
            raise NotImplementedError('test mode is not supported')
        return _mds_offset(total_frames, self.clip_len, self.frame_interval,
                           self.num_clips, chosen_idx)


@PIPELINES.register_module()
class TemporalShiftChosenSampleFrames(_MSCLSampleBase):
    """MDS + temporal-shift positive pair: the k-clip offset is the q-clip
    offset plus a uniform shift in +-shift_range*clip_len*frame_interval,
    snapped to the nearest chosen_idx; emits num_clips*2 clips so q and k
    come from different times (reference loading_mscl.py:179-282)."""

    num_clips_factor = 2

    def __init__(self, clip_len, frame_interval=1, num_clips=1,
                 temporal_jitter=False, twice_sample=False,
                 out_of_bound_opt='loop', test_mode=False,
                 start_index=None, keep_tail_frames=False, shift_range=1):
        super().__init__(clip_len, frame_interval, num_clips,
                         temporal_jitter, twice_sample, out_of_bound_opt,
                         test_mode, start_index, keep_tail_frames)
        assert self.num_clips == 1
        self.shift_range = shift_range * clip_len * frame_interval

    def _sample_clips_with_chosen(self, total_frames, chosen_idx):
        if self.test_mode:
            raise NotImplementedError('test mode is not supported')
        clip_offsets = _mds_offset(total_frames, self.clip_len,
                                   self.frame_interval, self.num_clips,
                                   chosen_idx)
        cur_shift = np.random.randint(-self.shift_range,
                                      self.shift_range + 1)
        tar_offset = int(clip_offsets[0]) + cur_shift
        # snap to the chosen_idx nearest the shifted target
        new_offset = 0
        for cid in chosen_idx:
            if abs(int(cid) - tar_offset) < abs(int(cid) - new_offset):
                new_offset = int(cid)
        return np.concatenate(
            [clip_offsets, np.array([new_offset], dtype=np.int64)])


@PIPELINES.register_module()
class TemporalShiftSampleFrames(SampleFrames):
    """A temporal-shift positive pair without MDS (reference
    loading_mscl.py:286-375): the second offset is the first plus a uniform
    shift in +-shift_range*clip_len*frame_interval, clamped in bounds."""

    def __init__(self, clip_len, frame_interval=1, num_clips=1,
                 temporal_jitter=False, twice_sample=False,
                 out_of_bound_opt='loop', test_mode=False,
                 start_index=None, keep_tail_frames=False, shift_range=1):
        super().__init__(clip_len, frame_interval, num_clips,
                         temporal_jitter, twice_sample, out_of_bound_opt,
                         test_mode, start_index, keep_tail_frames)
        assert self.num_clips == 1
        self.shift_range = shift_range * clip_len * frame_interval

    def _sample_clips(self, num_frames):
        clip_offsets = super()._sample_clips(num_frames)
        cur_shift = np.random.randint(-self.shift_range,
                                      self.shift_range + 1)
        tar_offset = int(clip_offsets[0]) + cur_shift
        new_offset = max(
            min(tar_offset,
                num_frames - self.clip_len * self.frame_interval), 0)
        return np.concatenate(
            [clip_offsets, np.array([new_offset], dtype=np.int64)])

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
        results['num_clips'] = self.num_clips * 2
        return results


@PIPELINES.register_module()
class FlowToGT:
    """The flow-derived pseudo-boxes (``flow_prposals``, the key as the
    reference spells it) become ``gt_bboxes``."""

    def __call__(self, results):
        if 'gt_bboxes' in results:
            raise NotImplementedError(
                'FlowToGT cannot merge with existing gt_bboxes')
        results['gt_bboxes'] = results['flow_prposals']
        return results

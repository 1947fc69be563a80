"""RawframeDataset: a frame directory a video, listed as
"frame_dir [offset] total_frames label..." lines.

Port of ``mscl_tpu/datasets/rawframe_dataset.py`` ``RawframeDataset``
(reference mmaction rawframe_dataset.py): ``with_offset`` lines, and
``multi_class`` labels turned into a one-hot over ``num_classes``. The
frames' file names are ``filename_tmpl`` (``'img_{:05}.jpg'``; a flow set
names ``'{}_{:05d}.jpg'`` with 'x' and 'y'), numbered from
``start_index``. ``VideoDataset`` is refused by name: its videos need a
video codec, which the port does not have.

``AudioVisualDataset`` adds each video's ``audio_path`` under
``audio_prefix`` (``mscl_tpu/datasets/rawframe_dataset.py:109``).

``ImageDataset`` (the OmniSource web images) lists "path label..." lines,
as the JAX one, which subclasses the JAX ``VideoDataset`` for its list
reader; the port's reads the list itself and needs no codec (its pipeline
decodes each image with ``ImageDecode``).
"""
from __future__ import annotations

import copy
import os.path as osp

import numpy as np

from .base import BaseDataset
from .builder import DATASETS


@DATASETS.register_module()
class RawframeDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, data_prefix=None, test_mode=False,
                 filename_tmpl='img_{:05}.jpg', with_offset=False,
                 multi_class=False, num_classes=None, start_index=1,
                 modality='RGB', sample_by_class=False, power=0.0,
                 dynamic_length=False, **kwargs):
        self.filename_tmpl = filename_tmpl
        self.with_offset = with_offset
        super().__init__(ann_file, pipeline, data_prefix, test_mode,
                         multi_class, num_classes, start_index, modality,
                         sample_by_class=sample_by_class, power=power,
                         dynamic_length=dynamic_length)

    def load_annotations(self):
        video_infos = []
        with open(self.ann_file, 'r') as fin:
            for line in fin:
                line_split = line.strip().split()
                if not line_split:
                    continue
                video_info = {}
                frame_dir = line_split[0]
                if self.data_prefix is not None:
                    frame_dir = osp.join(self.data_prefix, frame_dir)
                video_info['frame_dir'] = frame_dir
                idx = 1
                if self.with_offset:
                    video_info['offset'] = int(line_split[idx])
                    video_info['total_frames'] = int(line_split[idx + 1])
                    idx += 2
                else:
                    video_info['total_frames'] = int(line_split[idx])
                    idx += 1
                label = [int(x) for x in line_split[idx:]]
                assert label, f'missing label in line: {line}'
                if self.multi_class:
                    assert self.num_classes is not None
                    video_info['label'] = label
                else:
                    assert len(label) == 1
                    video_info['label'] = label[0]
                video_infos.append(video_info)
        return video_infos

    def prepare_train_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        if self.multi_class:
            onehot = np.zeros(self.num_classes, dtype=np.float32)
            onehot[results['label']] = 1.
            results['label'] = onehot
        return self.pipeline(results)

    def prepare_test_frames(self, idx):
        return self.prepare_train_frames(idx)


@DATASETS.register_module()
class AudioVisualDataset(RawframeDataset):
    """RawframeDataset lines, each video also given ``audio_path``: its
    frame directory relative to ``data_prefix``, under ``audio_prefix``,
    with '.npy' (a spectrogram or feature map); and with ``video_prefix``
    a ``filename`` (.mp4) that no pipeline of the port decodes (reference
    mmaction audio_visual_dataset.py)."""

    def __init__(self, ann_file, pipeline, audio_prefix, **kwargs):
        self.audio_prefix = audio_prefix
        self.video_prefix = kwargs.pop('video_prefix', None)
        super().__init__(ann_file, pipeline, **kwargs)

    def load_annotations(self):
        video_infos = super().load_annotations()
        for info in video_infos:
            rel = osp.relpath(info['frame_dir'], self.data_prefix) \
                if self.data_prefix else info['frame_dir']
            if self.audio_prefix is not None:
                info['audio_path'] = osp.join(self.audio_prefix,
                                              rel + '.npy')
            if self.video_prefix:
                info['filename'] = osp.join(self.video_prefix,
                                            rel + '.mp4')
        return video_infos


@DATASETS.register_module()
class VideoDataset:
    """Refused: video files need a video codec (decord, PyAV, PIMS or
    OpenCV), which the port does not have."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'VideoDataset reads video files, which need a video codec '
            '(decord, PyAV, PIMS or OpenCV) that the port does not have; '
            'extract the frames and use RawframeDataset')


@DATASETS.register_module()
class ImageDataset(BaseDataset):
    """"filename label..." lines of images (``multi_class``: several
    labels), ``data_prefix`` joined to each; ``start_index`` is always 0."""

    def __init__(self, ann_file, pipeline, **kwargs):
        kwargs.pop('start_index', None)
        super().__init__(ann_file, pipeline, start_index=0, **kwargs)

    def load_annotations(self):
        video_infos = []
        with open(self.ann_file, 'r') as fin:
            for line in fin:
                line_split = line.strip().split()
                if not line_split:
                    continue
                if self.multi_class:
                    assert self.num_classes is not None
                    filename = line_split[0]
                    label = list(map(int, line_split[1:]))
                else:
                    filename, label = line_split
                    label = int(label)
                if self.data_prefix is not None:
                    filename = osp.join(self.data_prefix, filename)
                video_infos.append(dict(filename=filename, label=label))
        return video_infos

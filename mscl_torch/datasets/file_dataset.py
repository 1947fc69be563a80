"""FileRawframeDataset: the MSCL dataset over the local filesystem.

Port of ``mscl_tpu/datasets/file_dataset.py`` (reference
redis_dataset.py:17-402, its storage moved from Redis/nori to files): an
annotation pickle of per-video dicts

  - 'frames'      (or 'nori_id_seq'): list of image file paths
  - 'label'       int
  - 'enc_flows'   list of raw-flow blob paths (np4/npy)   [extra 'nids_flow']
  - 'imflows'     list of flow-image paths       [extra 'nids_flow_img']
  - 'chosen_idx'  list of MDS-chosen clip starts [extra 'chosen_idx']
  - 'bboxs'       per-frame boxes                [extra 'gt_bboxes']

``RedisRawframeDataset`` is an alias taking the reference config's
arguments (redis_url etc. accepted and ignored).
"""
from __future__ import annotations

import copy
import pickle

from .base import BaseDataset
from .builder import DATASETS
from .pipelines import Compose




class DataTransfer:
    """Annotation dict -> pipeline keys (reference
    redis_dataset.py:17-41). nori ids become file paths."""

    # reference extra-key name -> (anno key, pipeline key)
    _MAP = {
        'gt_bboxes': ('bboxs', 'gt_bboxes'),
        'nids_flow': ('enc_flows', 'flow_paths'),
        'nids_flow_img': ('imflows', 'flow_img_paths'),
        'img_key': ('video_name', 'img_key'),
        'chosen_idx': ('chosen_idx', 'chosen_idx'),
    }

    def __init__(self, extra_keys):
        self.extra_keys = extra_keys

    def __call__(self, anno):
        item = {}
        seq = anno.get('frames', anno.get('nori_id_seq'))
        item['img_paths'] = seq
        item['total_frames'] = len(seq)
        item['label'] = anno['label']
        if 'label_str' in anno:
            item['label_str'] = anno['label_str']
        for key in self.extra_keys:
            anno_key, pipe_key = self._MAP[key]
            item[pipe_key] = anno[anno_key]
        return item


@DATASETS.register_module()
class FileRawframeDataset(BaseDataset):

    def __init__(self, pkl_path, pipeline, data_prefix=None, test_mode=False,
                 filename_tmpl='img_{:05}.jpg', with_offset=False,
                 multi_class=False, num_classes=None, start_index=0,
                 modality='RGB', sample_by_class=False, power=0.0,
                 dynamic_length=False, redis_url='', redis_master_url='',
                 extra_keys=(), visual_cfg=None):
        self.pkl_path = pkl_path
        self.filename_tmpl = filename_tmpl
        self.with_offset = with_offset
        self.data_transfer = DataTransfer(list(extra_keys))
        self.visual_cfg = visual_cfg
        # redis_url / redis_master_url accepted for reference-config
        # compatibility; storage is the local filesystem.
        super().__init__(None, pipeline, data_prefix, test_mode, multi_class,
                         num_classes, start_index, modality,
                         sample_by_class=sample_by_class, power=power,
                         dynamic_length=dynamic_length)

    def load_annotations(self):
        with open(self.pkl_path, 'rb') as f:
            metas = pickle.load(f)
        if isinstance(metas, dict):
            # dict-of-videos normalization (reference
            # redis_cache.py:153-178 ActivityRedisCachedPickle)
            metas = list(metas.values())
        return metas

    def _prepare(self, idx):
        results = copy.deepcopy(self.data_transfer(self.video_infos[idx]))
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        if self.multi_class:
            onehot = self.label2array(self.num_classes, results['label'])
            results['label'] = onehot
        return self.pipeline(results)

    def prepare_train_frames(self, idx):
        return self._prepare(idx)

    def prepare_test_frames(self, idx):
        return self._prepare(idx)


# Alias: reference configs say type='RedisRawframeDataset'
DATASETS.register_module(name='RedisRawframeDataset',
                         module=FileRawframeDataset)


@DATASETS.register_module()
class FileRawframe2BranchDataset(FileRawframeDataset):
    """Runs two pipelines on the same annotation and returns both
    (reference RedisRawframe2BranchDataset redis_dataset.py:286-402)."""

    def __init__(self, pkl_path, pipeline, pipeline2, **kwargs):
        super().__init__(pkl_path, pipeline, **kwargs)
        self.pipeline2 = Compose(pipeline2)

    def _prepare(self, idx):
        results = copy.deepcopy(self.data_transfer(self.video_infos[idx]))
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        results2 = copy.deepcopy(results)
        out1 = self.pipeline(results)
        out2 = self.pipeline2(results2)
        out1.update({f'{k}2': v for k, v in out2.items()})
        return out1


DATASETS.register_module(name='RedisRawframe2BranchDataset',
                         module=FileRawframe2BranchDataset)

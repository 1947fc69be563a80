"""The localization and HVU data steps (port of the JAX package's
``LoadLocalizationFeature``, ``GenerateLocalizationLabels``,
``LoadProposals`` and ``LoadHVULabel`` in
``mscl_tpu/datasets/pipelines/loading.py``, the same numpy).

``ActivityNetDataset`` reads and resizes ``raw_feature`` and gives the
normalised ``gt_bbox`` itself, so the first two only check and cast what
it gave; ``LoadProposals`` reads BSN's proposal generation's files (a
``.csv`` of proposals and a ``.npy`` of their features a video, the
``top_k`` first rows of each: fewer when a video has fewer);
``LoadHVULabel`` turns HVU's tag dict into the flat one-hot target with
its tag and category masks.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..builder import PIPELINES


@PIPELINES.register_module()
class LoadLocalizationFeature:
    """Reference-config compatibility (reference pipelines/loading.py
    LoadLocalizationFeature): ActivityNetDataset here loads and
    temporally resizes ``raw_feature`` in prepare_* (the data plane keeps
    IO in the dataset); this transform validates/casts."""

    def __init__(self, raw_feature_ext='.csv', **kwargs):
        self.raw_feature_ext = raw_feature_ext

    def __call__(self, results):
        assert 'raw_feature' in results, (
            'LoadLocalizationFeature expects the dataset to provide '
            'raw_feature (ActivityNetDataset.prepare_train_frames)')
        results['raw_feature'] = np.asarray(results['raw_feature'],
                                            np.float32)
        return results


@PIPELINES.register_module()
class GenerateLocalizationLabels:
    """Reference-config compatibility: normalized gt segments are
    produced by ActivityNetDataset (gt_bbox); validate presence."""

    def __call__(self, results):
        assert 'gt_bbox' in results
        results['gt_bbox'] = np.asarray(results['gt_bbox'], np.float32)
        return results


@PIPELINES.register_module()
class LoadProposals:
    """Load top-k PGM proposals + BSP features for BSN-PEM training
    (reference loading.py LoadProposals; columns follow the PGM csv:
    tmin, tmax, tmin_score, tmax_score, score, match_iou — produced
    by mscl_torch/localization/bsn_utils.py)."""

    def __init__(self, top_k, pgm_proposals_dir, pgm_features_dir,
                 proposal_ext='.csv', feature_ext='.npy'):
        if proposal_ext != '.csv' or feature_ext != '.npy':
            raise NotImplementedError(
                f'ext {proposal_ext}/{feature_ext} not supported')
        self.top_k = top_k
        self.pgm_proposals_dir = pgm_proposals_dir
        self.pgm_features_dir = pgm_features_dir
        self.proposal_ext = proposal_ext
        self.feature_ext = feature_ext

    def __call__(self, results):
        video_name = results['video_name']
        proposals = np.loadtxt(
            osp.join(self.pgm_proposals_dir,
                     video_name + self.proposal_ext),
            dtype=np.float32, delimiter=',', skiprows=1)
        proposals = np.array(proposals[:self.top_k])
        results['tmin'] = proposals[:, 0]
        results['tmax'] = proposals[:, 1]
        results['tmin_score'] = proposals[:, 2]
        results['tmax_score'] = proposals[:, 3]
        results['reference_temporal_iou'] = proposals[:, 5]
        feature = np.load(
            osp.join(self.pgm_features_dir,
                     video_name + self.feature_ext)).astype(np.float32)
        results['bsp_feature'] = feature[:self.top_k, :]
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(top_k={self.top_k})'


@PIPELINES.register_module()
class LoadHVULabel:
    """Convert the HVU per-category tag dict into flat one-hot label +
    tag/category masks (reference loading.py LoadHVULabel)."""

    def __init__(self, **kwargs):
        self.hvu_initialized = False

    def init_hvu_info(self, categories, category_nums):
        self.categories = list(categories)
        self.category_nums = list(category_nums)
        self.num_categories = len(categories)
        self.num_tags = sum(category_nums)
        self.category2num = dict(zip(categories, category_nums))
        start_idx = [0]
        for num in self.category_nums[:-1]:
            start_idx.append(start_idx[-1] + num)
        self.category2startidx = dict(zip(categories, start_idx))
        self.hvu_initialized = True

    def __call__(self, results):
        if not isinstance(results['label'], dict):
            # HVUDataset has already made the tags a one-hot array; the JAX
            # LoadHVULabel fails on it (mscl_tpu/datasets/pipelines/
            # loading.py:651)
            raise TypeError(
                'LoadHVULabel takes the tag dict {category: [tags]}, got '
                f'{type(results["label"]).__name__}: HVUDataset has already '
                'made the one-hot target')
        if not self.hvu_initialized:
            self.init_hvu_info(results['categories'],
                               results['category_nums'])
        onehot = np.zeros(self.num_tags, np.float32)
        onehot_mask = np.zeros(self.num_tags, np.float32)
        category_mask = np.zeros(self.num_categories, np.float32)
        for category, tags in results['label'].items():
            category_mask[self.categories.index(category)] = 1.0
            start = self.category2startidx[category]
            num = self.category2num[category]
            onehot[[start + t for t in tags]] = 1.0
            onehot_mask[start:start + num] = 1.0
        results['label'] = onehot
        results['mask'] = onehot_mask
        results['category_mask'] = category_mask
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}()'

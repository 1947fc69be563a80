"""Dataset and pipeline registries and builders.

Port of ``mscl_tpu/datasets/builder.py`` (reference mmaction
datasets/builder.py): one loader assembles the global batch of
``videos_per_gpu`` x the number of cards; in data-parallel training each
rank's loader decodes its own rows of it (``datasets/loader.py``).
"""
from __future__ import annotations

from ..registry import Registry, build_from_cfg

DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')
BLENDINGS = Registry('blending')


def build_dataset(cfg, default_args=None):
    """A dataset, or the RepeatDataset / ConcatDataset wrapper of the ones
    its config lists (reference datasets/builder.py:28-40)."""
    if cfg['type'] == 'RepeatDataset':
        from .dataset_wrappers import RepeatDataset
        return RepeatDataset(build_dataset(cfg['dataset'], default_args),
                             cfg['times'])
    if cfg['type'] == 'ConcatDataset':
        from .dataset_wrappers import ConcatDataset
        return ConcatDataset([build_dataset(c, default_args)
                              for c in cfg['datasets']])
    return build_from_cfg(cfg, DATASETS, default_args)


def build_dataloader(dataset, videos_per_gpu, workers_per_gpu=0,
                     num_gpus=1, shuffle=True, seed=None, drop_last=False,
                     prefetch=2, sampler=None, workers_mode='thread',
                     rank=0, pad_last=False):
    """A NumpyLoader over global batches of ``videos_per_gpu * num_gpus``
    (the reference's lr-per-batch-size semantics), rank ``rank``'s rows of
    each when ``num_gpus`` > 1; ``pad_last`` tiles a short last batch;
    ``sampler`` (a PK sampler's config) and a dataset's
    ``sample_by_class`` choose the epoch's order (``NumpyLoader``)."""
    from .loader import NumpyLoader
    return NumpyLoader(dataset, batch_size=videos_per_gpu * num_gpus,
                       shuffle=shuffle, seed=seed, drop_last=drop_last,
                       num_workers=workers_per_gpu, prefetch=prefetch,
                       workers_mode=workers_mode, world=num_gpus, rank=rank,
                       pad_last=pad_last, sampler=sampler)

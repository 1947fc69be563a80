"""Compose — chains transforms over a ``results`` dict.

Port of ``mscl_tpu/datasets/pipelines/compose.py`` (mmaction's Compose):
each transform is a callable taking and returning the results dict;
returning None aborts the sample.
"""
from __future__ import annotations

from collections.abc import Sequence

from ..builder import PIPELINES
from ...registry import build_from_cfg


@PIPELINES.register_module()
class Compose:

    def __init__(self, transforms):
        assert isinstance(transforms, Sequence)
        self.transforms = []
        for transform in transforms:
            if isinstance(transform, dict):
                self.transforms.append(build_from_cfg(transform, PIPELINES))
            elif callable(transform):
                self.transforms.append(transform)
            else:
                raise TypeError(f'transform must be callable or a dict, '
                                f'got {type(transform)}')

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        body = '\n    '.join(repr(t) for t in self.transforms)
        return f'{self.__class__.__name__}(\n    {body}\n)'

"""Formatting transforms: ToTensor and Collect.

Port of part of ``mscl_tpu/datasets/pipelines/formatting.py`` (reference
mmaction formating.py): a "tensor" here is a contiguous numpy array, as in
the JAX package; the loader batches them and ``apis.to_torch`` copies the
batch to the device once a step.
"""
from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from ..builder import PIPELINES


def to_tensor(data):
    """Convert to a numpy array (reference formating.py:12-28 converts to
    torch.Tensor; numpy is the host-side equivalent here)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data)
    if isinstance(data, Sequence) and not isinstance(data, str):
        return np.asarray(data)
    if isinstance(data, int):
        return np.asarray([data], dtype=np.int64)
    if isinstance(data, float):
        return np.asarray([data], dtype=np.float32)
    raise TypeError(f'type {type(data)} cannot be converted to an array.')


def batched_to_tensor(data):
    """Element-wise to_tensor on lists (reference formating.py:30-47,
    used with batched=True for the [q, k] pair lists)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data)
    if isinstance(data, Sequence) and not isinstance(data, str):
        return [to_tensor(d) for d in data]
    return to_tensor(data)


@PIPELINES.register_module()
class ToTensor:
    """reference formating.py:49-76 (``batched=True`` tensorizes each
    element of a [q, k] list)."""

    def __init__(self, keys, batched=False):
        self.keys = keys
        self.batched = batched
        self._fn = batched_to_tensor if batched else to_tensor

    def __call__(self, results):
        for key in self.keys:
            results[key] = self._fn(results[key])
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(keys={self.keys})'



@PIPELINES.register_module()
class Collect:
    """Keep only the requested keys (+ optional img_metas dict).

    Parity: mmaction Collect — our meta is a plain dict (no DataContainer;
    that abstraction only exists for torch pin-memory/scatter, which has no
    TPU counterpart).
    """

    def __init__(self, keys,
                 meta_keys=('filename', 'label', 'original_shape',
                            'img_shape', 'pad_shape', 'flip_direction',
                            'img_norm_cfg'),
                 meta_name='img_metas', nested=False):
        self.keys = keys
        self.meta_keys = meta_keys
        self.meta_name = meta_name
        self.nested = nested

    def __call__(self, results):
        data = {}
        for key in self.keys:
            data[key] = results[key]
        if len(self.meta_keys) != 0:
            meta = {k: results[k] for k in self.meta_keys if k in results}
            data[self.meta_name] = meta
        if self.nested:
            for k in data:
                data[k] = [data[k]]
        return data

    def __repr__(self):
        return (f'{self.__class__.__name__}(keys={self.keys}, '
                f'meta_keys={self.meta_keys}, nested={self.nested})')



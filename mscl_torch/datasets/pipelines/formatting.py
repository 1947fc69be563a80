"""Formatting transforms: ToTensor, Collect, Rename, FormatShape,
Transpose, ImageToTensor and ToDataContainer.

Port of ``mscl_tpu/datasets/pipelines/formatting.py`` (reference mmaction
formating.py): a "tensor" here is a contiguous numpy array, as in the JAX
package; the loader batches them and ``apis.to_torch`` copies the batch to
the device once a step. ``FormatShape`` gives the JAX package's arrays in
all six layouts; the recognizers take NCTHW (``NTHWC`` clips are refused
by ``Recognizer3D``, where the JAX package reads them wrongly).
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
class Rename:
    """Rename keys in results (reference formating.py:79-103)."""

    def __init__(self, mapping):
        self.mapping = mapping

    def __call__(self, results):
        for key, value in self.mapping.items():
            if key in results:
                assert isinstance(key, str) and isinstance(value, str)
                assert value not in results
                results[value] = results.pop(key)
        return results


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




@PIPELINES.register_module()
class FormatShape:
    """Stack ``imgs`` (M x H x W x C, M = crops x clips x clip_len) into
    ``input_format`` (mmaction FormatShape): NCTHW and NTHWC (crops x
    clips first), NCHW, NCHW_Flow (x and y stacked over the clip),
    NCTHW_Heatmap (pose heatmaps; the leading -1 takes
    GeneratePoseTarget(double=True)'s flipped copies) and NPTCHW (by
    proposal); ``collapse`` drops a leading 1."""

    def __init__(self, input_format, collapse=False):
        self.input_format = input_format
        self.collapse = collapse
        if self.input_format not in ['NCTHW', 'NCHW', 'NCHW_Flow',
                                     'NPTCHW', 'NTHWC',
                                     'NCTHW_Heatmap']:
            raise ValueError(f'input format {input_format} is invalid')

    def __call__(self, results):
        if not isinstance(results['imgs'], np.ndarray):
            results['imgs'] = np.array(results['imgs'])
        imgs = results['imgs']
        if self.collapse:
            assert results['num_clips'] == 1

        if self.input_format in ('NCTHW', 'NTHWC', 'NCTHW_Heatmap'):
            num_clips = results['num_clips']
            clip_len = results['clip_len']
            imgs = imgs.reshape((-1, num_clips, clip_len) + imgs.shape[1:])
            if self.input_format != 'NTHWC':
                imgs = np.transpose(imgs, (0, 1, 5, 2, 3, 4))
            imgs = imgs.reshape((-1,) + imgs.shape[2:])
        elif self.input_format == 'NCHW':
            imgs = np.transpose(imgs, (0, 3, 1, 2))
        elif self.input_format == 'NCHW_Flow':
            num_clips = results['num_clips']
            clip_len = results['clip_len']
            imgs = imgs.reshape((-1, num_clips, clip_len) + imgs.shape[1:])
            imgs = np.transpose(imgs, (0, 1, 2, 5, 3, 4))
            imgs = imgs.reshape((-1, imgs.shape[2] * imgs.shape[3]) +
                                imgs.shape[4:])
        elif self.input_format == 'NPTCHW':
            num_proposals = results['num_proposals']
            num_clips = results['num_clips']
            clip_len = results['clip_len']
            imgs = imgs.reshape((num_proposals, num_clips * clip_len) +
                                imgs.shape[1:])
            imgs = np.transpose(imgs, (0, 1, 4, 2, 3))

        if self.collapse:
            assert imgs.shape[0] == 1
            imgs = imgs.squeeze(0)

        results['imgs'] = imgs
        results['input_shape'] = imgs.shape
        return results

    def __repr__(self):
        return f"{self.__class__.__name__}(input_format='{self.input_format}')"


@PIPELINES.register_module()
class Transpose:
    """Transpose the arrays of ``keys`` to ``order``."""

    def __init__(self, keys, order):
        self.keys = keys
        self.order = order

    def __call__(self, results):
        for key in self.keys:
            results[key] = results[key].transpose(self.order)
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """HWC image -> contiguous CHW array for ``keys`` (reference
    formating.py ImageToTensor)."""

    def __init__(self, keys):
        self.keys = keys

    def __call__(self, results):
        for key in self.keys:
            results[key] = np.ascontiguousarray(
                results[key].transpose(2, 0, 1))
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(keys={self.keys})'


@PIPELINES.register_module()
class ToDataContainer:
    """mmcv's DataContainer wraps samples for its scatter; the loader
    batches numpy arrays, so this only checks that the wrapped keys are
    there (reference formating.py ToDataContainer)."""

    def __init__(self, fields):
        self.fields = fields

    def __call__(self, results):
        for field in self.fields:
            key = field.get('key')
            keys = key if isinstance(key, list) else [key]
            for k in keys:
                assert k in results, f'ToDataContainer: missing {k}'
        return results

    def __repr__(self):
        return f'{self.__class__.__name__}(fields={self.fields})'

"""Checkpoints of the JAX package (``<work_dir>/epoch_N.ckpt``), read
without JAX, flax or the ``msgpack`` package.

``mscl_tpu.core.save_checkpoint`` writes ``flax.serialization
.msgpack_serialize`` of its TrainState's state dict: msgpack maps, arrays,
strs, bins, ints, floats, nil and bools, with flax's extension types

  1  an ndarray: msgpack of (shape, dtype name, C-order bytes)
  2  a Python complex: msgpack of (real, imag)
  3  a numpy scalar: as an ndarray of shape ()

and every array over ``MAX_CHUNK_SIZE`` bytes as a dict
``{'__msgpack_chunked_array__': True, 'shape': {'0': ...}, 'chunks':
{'0': ..., '1': ...}}`` of flat pieces. ``read_ckpt`` gives what
``flax.serialization.msgpack_restore`` gives, leaf for leaf (bfloat16
leaves widened to float32, which is exact, since numpy has no bfloat16).
``load_jax_checkpoint`` turns the model's collections (``params``,
``batch_stats``, ``moco_state``) into the port's state_dict through
``convert.jax_to_state_dict``, with the ``.meta.json`` beside the file.
"""
from __future__ import annotations

import json
import os.path as osp
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..convert import jax_to_state_dict
from ..utils.np4 import _Reader

JAX_FORMAT = 'mscl_tpu.msgpack'
CHUNKED = '__msgpack_chunked_array__'


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = _Reader(data).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == 'bfloat16':
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape, order='C')


class _FlaxReader(_Reader):
    """The np4 reader with strs decoded and flax's extension types."""

    _STR = {0xD9: '>B', 0xDA: '>H', 0xDB: '>I'}
    _FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    _EXT = {0xC7: '>B', 0xC8: '>H', 0xC9: '>I'}

    def value(self):
        tag = self.buf[self.pos] if self.pos < len(self.buf) else None
        if tag is not None and (0xA0 <= tag <= 0xBF or tag in self._STR):
            self.pos += 1
            n = tag & 0x1F if tag <= 0xBF else self.unpack(self._STR[tag])
            return self.take(n).decode()
        if tag in self._FIXEXT or tag in self._EXT:
            self.pos += 1
            n = self._FIXEXT[tag] if tag in self._FIXEXT else \
                self.unpack(self._EXT[tag])
            code = struct.unpack('>b', self.take(1))[0]
            return self._ext(code, self.take(n))
        return super().value()

    @staticmethod
    def _ext(code: int, data: bytes):
        if code == 1:
            return _ndarray(data)
        if code == 2:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        if code == 3:
            return _ndarray(data)[()]
        raise ValueError(f'unknown msgpack extension type {code}')


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts back to
    arrays."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_ckpt(path: str) -> Any:
    """A ``.ckpt`` file -> what ``flax.serialization.msgpack_restore``
    returns: nested dicts of numpy arrays and Python values."""
    with open(path, 'rb') as f:
        reader = _FlaxReader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f'{path}: trailing bytes after the msgpack tree')
    return _unchunk(tree)


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """A JAX ``.ckpt`` -> ``{'format': JAX_FORMAT, 'state_dict': the port's
    names -> tensors, 'meta': its .meta.json}``."""
    tree = read_ckpt(path)
    if not isinstance(tree, dict) or 'params' not in tree:
        raise ValueError(f'{path} holds no params: not a checkpoint of the '
                         f'JAX package')
    collections = {k: tree[k] for k in ('params', 'batch_stats',
                                        'moco_state')
                   if isinstance(tree.get(k), dict) and tree[k]}
    sd = {k: torch.from_numpy(v)
          for k, v in jax_to_state_dict(collections).items()}
    meta = {}
    if osp.exists(path + '.meta.json'):
        with open(path + '.meta.json') as f:
            meta = json.load(f)
    return {'format': JAX_FORMAT, 'state_dict': sd, 'meta': meta,
            'path': path}

"""The compute dtype of a model, by explicit casts.

The JAX models take flax's ``dtype``: parameters, gradients, BN statistics
and MoCo queues stay float32, and each layer casts its input and its
parameters to ``dtype`` and computes in it. The port does the same with
explicit casts in each module (``torch.autocast`` would be another
computation: its per-op policy keeps BN in float32 and has its own matmul
rules). In float32 the helpers make the layer's own call (bias inside),
so a float32 model runs exactly as it did before the option existed.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def resolve_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    """None -> float32; a float torch dtype as it is."""
    if dtype is None:
        return torch.float32
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise TypeError(f'compute dtype must be a float dtype, got {dtype}')
    return dtype


def linear(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax Dense(dtype): x @ W^T in dtype, then + b in dtype."""
    if dtype == torch.float32:
        return F.linear(x, layer.weight, layer.bias)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def conv3d(conv: nn.Conv3d, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """A Conv3d in dtype: x and the kernel cast, the bias added after."""
    if dtype == torch.float32:
        return F.conv3d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                        conv.dilation, conv.groups)
    y = F.conv3d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y if conv.bias is None else \
        y + conv.bias.to(dtype)[None, :, None, None, None]


def conv(layer: nn.modules.conv._ConvNd, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """Any Conv1d/2d/3d in dtype: x and the kernel cast, the bias added
    after (the layer's own call in float32)."""
    if dtype == torch.float32:
        return layer._conv_forward(x, layer.weight, layer.bias)
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    return y if layer.bias is None else \
        y + layer.bias.to(dtype).reshape((1, -1) + (1,) * (y.dim() - 2))

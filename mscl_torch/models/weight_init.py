"""flax's default kernel init, shared by the port's modules that take it."""
from __future__ import annotations

import math

import torch
from torch import nn

# the std of a unit normal truncated at 2 std
_TRUNCATED_STD = .87962566103423978


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax's default Dense and Conv kernel init, in place: a normal
    truncated at 2 std whose std after truncation is 1 / sqrt(fan_in)
    (fan_in: a torch weight's input channels times its kernel taps)."""
    std = 1.0 / math.sqrt(weight[0].numel()) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=gen)

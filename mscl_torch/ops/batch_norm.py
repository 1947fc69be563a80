"""BatchNorm with the JAX package's running-statistics rule, in float32
(``BatchNorm3d``) and in a lower compute dtype (``LowPrecisionBatchNorm``).

The JAX models (``mscl_tpu/ops/split_bn.py``, flax ``nn.BatchNorm``) update
``running = 0.9 * running + 0.1 * batch_stat`` with the *biased* batch
variance; ``nn.BatchNorm3d`` folds in the unbiased one. The normalisation
itself is torch's (cuDNN on the card); only the variance that enters the
running average is corrected, on (C,)-sized tensors. Parameter and buffer
names are torch's (``weight``, ``bias``, ``running_mean``, ``running_var``).

In a process group (``parallel/dist.py``) train mode normalises with the
global batch's statistics, as the JAX package's mesh does: both kinds
all-reduce ``[sum x, sum x^2, n]`` in float32 once a call, take the mean and
the biased variance E[x^2] - E[x]^2 from it, normalise with ``_BNTrainApply``
and all-reduce ``[sum dy, sum dy*xhat]`` in its backward, so dx is the
global batch's; d_weight and d_bias stay the rank's sums, which the
gradient all-reduce adds up. With no group nothing changes. Inside
``local_statistics`` they take their own input's statistics in a group too
(ShuffleBN's key groups).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist


_LOCAL = [False]


@contextlib.contextmanager
def local_statistics():
    """Train-mode BN inside normalises with the statistics of its own input,
    also in a process group: ShuffleBN's key groups, which every rank runs
    on the whole gathered key batch."""
    prev, _LOCAL[0] = _LOCAL[0], True
    try:
        yield
    finally:
        _LOCAL[0] = prev


def _global_statistics() -> bool:
    return dist.is_distributed() and not _LOCAL[0]


class BatchNorm3d(nn.Module):
    eps = 1e-5
    momentum = 0.1          # flax momentum 0.9, in torch's convention

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if _global_statistics():
            return _global_bn_train(self, x)
        # F.batch_norm updates the running stats it is given in place and
        # autograd saves them, so it gets copies; the buffers are then set
        # from the copies with the unbiased variance made biased again.
        mean = self.running_mean.clone()
        var = self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = (1.0 - self.momentum) * self.running_var
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
            self.running_mean.copy_(mean)
        return y


def _batch_stats(x: torch.Tensor):
    """float32 mean and biased variance over all axes but 1, as
    E[x^2] - E[x]^2 (the JAX package's formula)."""
    axes = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    mean32 = xf.mean(axes)
    return mean32, (xf * xf).mean(axes) - mean32 * mean32


def _global_batch_stats(x: torch.Tensor):
    """``_batch_stats`` over the process group's global batch: the float32
    ``[sum x, sum x^2, n]`` all-reduced, then the same formula. Returns
    (mean, biased variance, n)."""
    axes = (0,) + tuple(range(2, x.dim()))
    c = x.shape[1]
    with torch.no_grad():
        xf = x.float()
        sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes),
                          xf.new_full((1,), x.numel() // c)])
        dist.all_reduce_([sums], tag='bn_forward')
        n = sums[2 * c]
        mean32 = sums[:c] / n
        return mean32, sums[c:2 * c] / n - mean32 * mean32, n


def _global_bn_train(bn: 'BatchNorm3d', x: torch.Tensor) -> torch.Tensor:
    """Train-mode BN of either kind in a process group: global statistics,
    ``_BNTrainApply`` with the reduced backward, the running averages
    updated with the biased variance."""
    mean32, var32, n = _global_batch_stats(x)
    y = _BNTrainApply.apply(x, bn.weight, bn.bias, mean32, var32, bn.eps, n)
    with torch.no_grad():
        keep = 1.0 - bn.momentum
        bn.running_mean.mul_(keep).add_(bn.momentum * mean32)
        bn.running_var.mul_(keep).add_(bn.momentum * var32)
    return y


class _BNTrainApply(torch.autograd.Function):
    """Train-mode normalize with the batch statistics, in x's dtype:
    y = (x - m) rstd scale + bias, m and rstd from the float32 statistics
    (computed once by the caller, which also folds them into the running
    averages). The backward's batch reductions (d_bias, d_scale) accumulate
    in float32 (``bn_train_apply`` of the JAX package). Given the global
    batch's count ``n`` (a process group's statistics), the backward
    all-reduces them for dx over the global batch."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean32, var32, eps, n=None):
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        m = mean32.to(dt).reshape(shape)
        rstd = torch.rsqrt(var32 + eps).to(dt).reshape(shape)
        ctx.global_n = n
        ctx.save_for_backward(x, scale, m, rstd)
        return (x - m) * rstd * scale.to(dt).reshape(shape) + \
            bias.to(dt).reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x, scale, m, rstd = ctx.saved_tensors
        dt = x.dtype
        axes = (0,) + tuple(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        xhat = (x - m) * rstd
        s1 = dy.float().sum(axes)                              # d_bias
        s2 = (dy.float() * xhat.float()).sum(axes)             # d_scale
        g1, g2 = s1, s2
        if ctx.global_n is not None:
            n = ctx.global_n
            sums = torch.cat([s1, s2])
            dist.all_reduce_([sums], tag='bn_backward')
            g1, g2 = sums[:s1.numel()], sums[s1.numel():]
        k = scale.to(dt).reshape(shape) * rstd
        dx = k * (dy - (g1 / n).to(dt).reshape(shape) -
                  xhat * (g2 / n).to(dt).reshape(shape))
        return dx, s2, s1, None, None, None, None


class LowPrecisionBatchNorm(BatchNorm3d):
    """The JAX package's default BN (``LowPrecisionBatchNorm`` of
    ``mscl_tpu/ops/split_bn.py``) for a compute dtype other than float32:
    float32 statistics and running averages, the normalize in the input's
    dtype, float32-accumulated backward reductions. In eval mode the scale
    and offset are folded in float32 and cast once."""

    def __init__(self, num_features: int, dtype: torch.dtype):
        super().__init__(num_features)
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.compute_dtype))
        dt = x.dtype
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if not self.training:
            a32 = self.weight * torch.rsqrt(self.running_var + self.eps)
            b32 = self.bias - self.running_mean * a32
            return (x * a32.to(dt).reshape(shape) +
                    b32.to(dt).reshape(shape)).to(self.compute_dtype)
        if _global_statistics():
            return _global_bn_train(self, x).to(self.compute_dtype)
        with torch.no_grad():
            mean32, var32 = _batch_stats(x)
        y = _BNTrainApply.apply(x, self.weight, self.bias, mean32, var32,
                                self.eps)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(self.momentum * mean32)
            self.running_var.mul_(keep).add_(self.momentum * var32)
        return y.to(self.compute_dtype)

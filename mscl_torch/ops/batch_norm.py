"""BatchNorm with the JAX package's running-statistics rule.

The JAX models (``mscl_tpu/ops/split_bn.py``, flax ``nn.BatchNorm``) update
``running = 0.9 * running + 0.1 * batch_stat`` with the *biased* batch
variance; ``nn.BatchNorm3d`` folds in the unbiased one. The normalisation
itself is torch's (cuDNN on the card); only the variance that enters the
running average is corrected, on (C,)-sized tensors. Parameter and buffer
names are torch's (``weight``, ``bias``, ``running_mean``, ``running_var``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


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

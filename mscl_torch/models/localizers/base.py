"""The localizers' loss parsing (port of
``mscl_tpu/models/localizers/base.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def parse_losses_localizer(losses: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Each entry's mean for logging; the total is the ``loss`` entry."""
    log_vars = {k: v.mean() for k, v in losses.items()}
    return log_vars['loss'], log_vars


def to_numpy(x):
    """A tensor (any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Loss parsing (port of ``mscl_tpu/models/recognizers/base.py``
``parse_losses``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def parse_losses(losses: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean each entry for logging; the total sums the keys holding 'loss'."""
    log_vars = {name: value.mean() for name, value in losses.items()}
    loss = sum(v for k, v in log_vars.items() if 'loss' in k)
    log_vars['loss'] = loss
    return loss, log_vars

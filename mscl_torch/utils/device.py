"""The port's device policy: the card unless the caller names the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None means the card. Raises when a CUDA device is asked for and
    there is none; the CPU is used only when the caller names it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('mscl_torch runs on a CUDA device and none is '
                           "available; pass device='cpu' to run on the CPU")
    return device

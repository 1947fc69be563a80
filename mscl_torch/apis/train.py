"""Model construction (port of ``mscl_tpu/apis/train.py``
``build_model_from_cfg``)."""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..models import RECOGNIZERS
from ..models.recognizers.moco import KEY_PATTERNS

# key towers follow the query towers by EMA, not by the optimizer
MOCO_FREEZE = KEY_PATTERNS


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """None means the card. Raises when a CUDA device is asked for and
    there is none; the CPU is used only when the caller names it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('mscl_torch runs on a CUDA device and none is '
                           "available; pass device='cpu' to run on the CPU")
    return device


def build_model_from_cfg(model_cfg: Dict, device=None, seed: int = 0):
    """Build a recognizer from its config, initialise it from a
    ``torch.Generator`` seeded with ``seed``, and move it to ``device``.

    Float32 throughout: TF32 is switched off for both matmuls and cuDNN
    convolutions, so the card computes what the CPU reference computes.
    """
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(model_cfg)
    cls = RECOGNIZERS.get(cfg.pop('type'))
    if cls is None:
        raise KeyError(f'unknown recognizer {model_cfg["type"]}')
    model = cls(**cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device)


def to_torch(batch, device) -> Dict:
    """numpy batch (dict of arrays or lists of arrays) -> tensors on device."""
    def conv(x):
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return {k: conv(v) for k, v in batch.items()}

from .flagship import (FLAGSHIP_AUG, FLAGSHIP_CONFIG, flagship_batch,
                       flagship_model_cfg, load_flagship_config,
                       narrow_flagship_cfg)
from .train import MOCO_FREEZE, build_model_from_cfg, resolve_device, to_torch

__all__ = ['FLAGSHIP_AUG', 'FLAGSHIP_CONFIG', 'flagship_batch',
           'flagship_model_cfg', 'load_flagship_config', 'narrow_flagship_cfg',
           'MOCO_FREEZE',
           'build_model_from_cfg', 'resolve_device', 'to_torch']

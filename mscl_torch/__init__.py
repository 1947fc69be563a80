"""mscl_torch — the PyTorch/CUDA port of mscl_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; the TPU package's Pallas kernels become
kernels written by hand for sm_90a under ``csrc/``, built with nvcc at first
use. The package imports nothing of JAX and nothing of mscl_tpu.
"""

__version__ = '0.1.0'

from .config import Config, ConfigDict
from .registry import Registry, build_from_cfg

__all__ = ['Config', 'ConfigDict', 'Registry', 'build_from_cfg',
           '__version__']

"""Device augmentation and motion maps (``ssl_aug``, ``motion_map``)."""
from . import ssl_aug  # noqa: F401
from .motion_map import MotionMapCalculator
from .ssl_aug import FlowVisualizer, flow_uv_to_colors

__all__ = ['MotionMapCalculator', 'FlowVisualizer', 'flow_uv_to_colors']

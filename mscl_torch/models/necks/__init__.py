from .base_moco import BaseMoCo, TPNMoCo, gap3d
from .fpn import FPN, torch_nearest_resize
from .fpn_video import TPNSingle
from .sepc import SEPC, PConv3D, trilinear_resize

__all__ = ['BaseMoCo', 'TPNMoCo', 'gap3d', 'FPN', 'torch_nearest_resize',
           'TPNSingle', 'SEPC', 'PConv3D', 'trilinear_resize']

from .base_moco import (BaseMoCo, BaseMoCo_TwoR5, MixBaseMoCo, TPNMoCo,
                        TPNProjMoCo, TPNProjMoCoV2, gap3d)
from .fpn import FPN, torch_nearest_resize
from .fpn_video import TemporalModulation, TPNSingle
from .sepc import SEPC, PConv3D, trilinear_resize
from .tpn import TPN, LevelFusion

__all__ = ['BaseMoCo', 'BaseMoCo_TwoR5', 'MixBaseMoCo', 'TPNMoCo',
           'TPNProjMoCo', 'TPNProjMoCoV2', 'gap3d', 'FPN',
           'torch_nearest_resize', 'TemporalModulation', 'TPNSingle', 'SEPC',
           'PConv3D', 'trilinear_resize', 'TPN', 'LevelFusion']

from .resnet3d import (BasicBlock3d, Bottleneck3d, ConvModule, ResNet3d,
                       ResNet3dSlowOnly, ResNet3dSlowOnly_TwoR5)
from .video_resnet import BasicBlock3D, Bottleneck3D, ConvBN, VideoResNet

__all__ = ['BasicBlock3D', 'Bottleneck3D', 'ConvBN', 'VideoResNet',
           'BasicBlock3d', 'Bottleneck3d', 'ConvModule', 'ResNet3d',
           'ResNet3dSlowOnly', 'ResNet3dSlowOnly_TwoR5']

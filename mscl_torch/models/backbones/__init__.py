from .extern_2d import (BottleneckX, DenseLayer, DenseNet, PatchMerging,
                        ResNeXt, SwinBlock, SwinTransformer)
from .mobilenet_v2 import MobileNetV2, MobileNetV2TSM
from .resnet_audio import ConvAudio, ResNetAudio
from .resnet2d import C3D, ResNet, ResNetTSM, temporal_shift
from .resnet3d import (BasicBlock3d, Bottleneck3d, ConvModule, CSNBottleneck,
                       NonLocal3d, ResNet3d, ResNet3dCSN, ResNet3dLayer,
                       ResNet3dSlowFast, ResNet3dSlowOnly,
                       ResNet3dSlowOnly_TwoR5)
from .s3d import S3D
from .timesformer import TimeSformer
from .resnet_tin import ResNetTIN, linear_sampler, tin_shift
from .tanet import TAM, TANet
from .video_resnet import (BasicBlock3D, Bottleneck3D, ConvBN, ResNet2Plus1d,
                           VideoResNet)
from .x3d import X3D

__all__ = ['ConvAudio', 'ResNetAudio', 'BasicBlock3D', 'Bottleneck3D', 'ConvBN', 'VideoResNet',
           'BasicBlock3d', 'Bottleneck3d', 'ConvModule', 'NonLocal3d',
           'ResNet3d', 'ResNet3dSlowOnly', 'ResNet3dSlowOnly_TwoR5', 'ResNet',
           'ResNetTSM', 'C3D', 'temporal_shift', 'MobileNetV2',
           'MobileNetV2TSM', 'ResNetTIN', 'linear_sampler', 'tin_shift', 'TAM',
           'TANet', 'CSNBottleneck', 'ResNet3dCSN', 'ResNet3dLayer',
           'ResNet3dSlowFast', 'S3D', 'TimeSformer', 'ResNet2Plus1d', 'X3D',
           'BottleneckX', 'ResNeXt', 'DenseLayer', 'DenseNet', 'SwinBlock',
           'PatchMerging', 'SwinTransformer']

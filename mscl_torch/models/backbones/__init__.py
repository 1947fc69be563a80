from .video_resnet import BasicBlock3D, ConvBN, VideoResNet

__all__ = ['BasicBlock3D', 'ConvBN', 'VideoResNet']

"""Model registries and build functions.

Port of ``mscl_tpu/models/builder.py``: one shared MODELS registry exposed as
BACKBONES/NECKS/HEADS/RECOGNIZERS/LOSSES, and a separate SSL_AUGS registry
for the device augmentations.
"""
from __future__ import annotations

from ..registry import Registry, build_from_cfg

MODELS = Registry('models')
BACKBONES = MODELS
NECKS = MODELS
HEADS = MODELS
RECOGNIZERS = MODELS
LOSSES = MODELS
SSL_AUGS = Registry('ssl_augs')


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg):
    return NECKS.build(cfg)


def build_head(cfg):
    return HEADS.build(cfg)


def build_loss(cfg):
    return LOSSES.build(cfg)


def build_ssl_aug(cfg):
    return build_from_cfg(cfg, SSL_AUGS)

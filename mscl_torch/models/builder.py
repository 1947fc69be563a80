"""Model registries and build functions.

Port of ``mscl_tpu/models/builder.py``: one shared MODELS registry exposed as
BACKBONES/NECKS/HEADS/RECOGNIZERS/LOSSES.
"""
from __future__ import annotations

from ..registry import Registry

MODELS = Registry('models')
BACKBONES = MODELS
NECKS = MODELS
HEADS = MODELS
RECOGNIZERS = MODELS
LOSSES = MODELS


def build_backbone(cfg):
    return BACKBONES.build(cfg)


def build_neck(cfg):
    return NECKS.build(cfg)


def build_head(cfg):
    return HEADS.build(cfg)


def build_loss(cfg):
    return LOSSES.build(cfg)


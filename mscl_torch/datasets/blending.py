"""Batch blending: MixUp and CutMix on a batch on the device.

Port of ``mscl_tpu/datasets/blending.py`` (reference mmaction
blending_utils.py). The JAX functions draw from a key; these draw from a
``torch.Generator`` (λ from Beta(alpha, alpha) as a ratio of two Gamma
draws, the permutation, CutMix's box centre) and then blend through
``mix``, which takes the draws themselves, so that a test can hand it
JAX's. Clips are NCTHW, so CutMix's box lies on the last two axes. As in
the JAX package, no train step calls them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .builder import BLENDINGS


def _gamma(alpha: float, gen: Optional[torch.Generator]) -> float:
    """One Gamma(alpha, 1) draw (Marsaglia and Tsang; alpha < 1 through
    Gamma(alpha + 1) * U^(1 / alpha))."""
    boost = 1.0
    if alpha < 1:
        boost = torch.rand((), generator=gen, dtype=torch.float64).item() \
            ** (1 / alpha)
        alpha += 1
    d = alpha - 1 / 3
    c = 1 / math.sqrt(9 * d)
    while True:
        x = torch.randn((), generator=gen, dtype=torch.float64).item()
        v = (1 + c * x) ** 3
        if v <= 0:
            continue
        u = torch.rand((), generator=gen, dtype=torch.float64).item()
        if math.log(u) < 0.5 * x * x + d - d * v + d * math.log(v):
            return d * v * boost


class BaseMiniBatchBlending:

    def __init__(self, num_classes, alpha=0.2):
        self.num_classes = num_classes
        self.alpha = alpha

    def beta(self, gen: Optional[torch.Generator]) -> float:
        a = _gamma(self.alpha, gen)
        return a / (a + _gamma(self.alpha, gen))

    def __call__(self, imgs: torch.Tensor, labels: torch.Tensor,
                 gen: Optional[torch.Generator] = None):
        """imgs (B, ...) and integer labels (B,) -> the blended imgs and
        soft labels (B, num_classes)."""
        draws = self.draw(imgs, gen)
        return self.mix(imgs, F.one_hot(labels.long(), self.num_classes)
                        .to(imgs.dtype), **draws)


@BLENDINGS.register_module()
class MixupBlending(BaseMiniBatchBlending):
    """λ x + (1 − λ) x[perm], and the labels alike."""

    def draw(self, imgs, gen):
        lam = self.beta(gen)
        perm = torch.randperm(imgs.shape[0], generator=gen)
        return dict(lam=lam, perm=perm.to(imgs.device))

    @staticmethod
    def mix(imgs, label, lam, perm):
        mixed = lam * imgs + (1 - lam) * imgs[perm]
        return mixed, lam * label + (1 - lam) * label[perm]


@BLENDINGS.register_module()
class CutmixBlending(BaseMiniBatchBlending):
    """x[perm] inside a box of side sqrt(1 − λ) about a random centre, x
    outside; the labels by the box's share."""

    def draw(self, imgs, gen):
        lam = self.beta(gen)
        perm = torch.randperm(imgs.shape[0], generator=gen)
        h, w = imgs.shape[-2:]
        cy = int(torch.randint(0, h, (), generator=gen))
        cx = int(torch.randint(0, w, (), generator=gen))
        return dict(lam=lam, perm=perm.to(imgs.device), cy=cy, cx=cx)

    @staticmethod
    def mix(imgs, label, lam, perm, cy, cx):
        h, w = imgs.shape[-2:]
        # the box's sides in float32, as the JAX function sizes them
        cut_rat = torch.sqrt(1 - torch.tensor(lam, dtype=torch.float32))
        cut_h, cut_w = int(h * cut_rat), int(w * cut_rat)

        def clip(lo, hi, size):
            return min(max(lo, 0), size), min(max(hi, 0), size)
        y1, y2 = clip(cy - cut_h // 2, cy + cut_h // 2, h)
        x1, x2 = clip(cx - cut_w // 2, cx + cut_w // 2, w)
        mixed = imgs.clone()
        mixed[..., y1:y2, x1:x2] = imgs[perm][..., y1:y2, x1:x2]
        lam_adj = 1.0 - ((y2 - y1) * (x2 - x1)) / (h * w)
        return mixed, lam_adj * label + (1 - lam_adj) * label[perm]

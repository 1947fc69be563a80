"""BMN's and BSN's losses (port of ``mscl_tpu/models/losses/bmn_loss.py``,
reference mmaction losses/bmn_loss.py and
binary_logistic_regression_loss.py): the class-balanced binary logistic
loss of the start, end (and action) curves, and BMN's proposal losses:
the regression MSE over a balanced random sample of the map's cells and
the classification logistic loss.

The balanced sample draws two uniforms the size of the map. The JAX loss
draws them from a key; here they come from ``draw_uniforms`` on a
``torch.Generator`` (the model's, seeded and saved with its checkpoint),
so they are not JAX's numbers: a test that holds the loss against JAX's
replays JAX's draws through ``draw_uniforms``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...parallel import dist
from ..builder import LOSSES


def binary_logistic_regression_loss(reg_score: torch.Tensor,
                                    label: torch.Tensor, threshold=0.5,
                                    ratio_range=(1.05, 21), eps=1e-5
                                    ) -> torch.Tensor:
    """The class-balanced binary logistic loss over every entry."""
    score = reg_score.reshape(-1)
    label = label.reshape(-1)
    pmask = (label > threshold).to(score.dtype)
    num_positive = pmask.sum().clamp(min=1.0)
    ratio = (label.shape[0] / num_positive).clamp(ratio_range[0],
                                                  ratio_range[1])
    coef_0 = 0.5 * ratio / (ratio - 1)
    coef_1 = 0.5 * ratio
    loss = coef_1 * pmask * torch.log(score + eps) + \
        coef_0 * (1.0 - pmask) * torch.log(1.0 - score + eps)
    return -loss.mean()


@LOSSES.register_module()
class BinaryLogisticRegressionLoss:

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, reg_score, label, threshold=0.5,
                 ratio_range=(1.05, 21), eps=1e-5):
        return self.loss_weight * binary_logistic_regression_loss(
            reg_score, label, threshold, ratio_range, eps)


def draw_uniforms(generator: Optional[torch.Generator], shape,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two uniform [0, 1) tensors of ``shape`` (a batch first) from
    ``generator``: in a process group the global batch's draws, alike on
    every rank, and the rank's rows of them, so n ranks draw what one
    device draws."""
    shape = (shape[0] * dist.world_size(),) + tuple(shape[1:])
    return tuple(dist.rank_rows(torch.rand(
        shape, generator=generator, device=device, dtype=torch.float32))
        for _ in range(2))


@LOSSES.register_module()
class BMNLoss:
    """``__call__(pred_bm, pred_start, pred_end, gt_iou_map, gt_start,
    gt_end, bm_mask, generator)`` -> (total, tem, pem_reg, pem_cls);
    ``pred_bm`` is (B, T, T, 2) (channel last, as the JAX module gives it)
    or (B, 2, T, T)."""

    @staticmethod
    def tem_loss(pred_start, pred_end, gt_start, gt_end):
        return binary_logistic_regression_loss(pred_start, gt_start) + \
            binary_logistic_regression_loss(pred_end, gt_end)

    @staticmethod
    def pem_reg_loss(uniforms, pred_score, gt_iou_map, mask,
                     high_temporal_iou_threshold=0.7,
                     low_temporal_iou_threshold=0.3):
        """``uniforms``: the two draws of the map's shape."""
        dt = pred_score.dtype
        u_hmask = (gt_iou_map > high_temporal_iou_threshold).to(dt)
        u_mmask = ((gt_iou_map <= high_temporal_iou_threshold) &
                   (gt_iou_map > low_temporal_iou_threshold)).to(dt)
        u_lmask = ((gt_iou_map <= low_temporal_iou_threshold) &
                   (gt_iou_map > 0.)).to(dt) * mask
        num_h = u_hmask.sum()
        num_m = u_mmask.sum().clamp(min=1.0)
        num_l = u_lmask.sum().clamp(min=1.0)
        u1, u2 = (u.to(dt) for u in uniforms)
        u_smmask = (u_mmask * u1 > (1.0 - num_h / num_m)).to(dt)
        u_slmask = (u_lmask * u2 > (1.0 - num_h / num_l)).to(dt)
        weights = u_hmask + u_smmask + u_slmask
        mse = ((pred_score * weights - gt_iou_map * weights) ** 2).mean()
        return 0.5 * mse * weights.numel() / weights.sum().clamp(min=1.0)

    @staticmethod
    def pem_cls_loss(pred_score, gt_iou_map, mask, threshold=0.9,
                     ratio_range=(1.05, 21), eps=1e-5):
        dt = pred_score.dtype
        pmask = (gt_iou_map > threshold).to(dt)
        nmask = (gt_iou_map <= threshold).to(dt) * mask
        num_positive = pmask.sum().clamp(min=1.0)
        num_entries = num_positive + nmask.sum()
        ratio = (num_entries / num_positive).clamp(ratio_range[0],
                                                   ratio_range[1])
        coef_0 = 0.5 * ratio / (ratio - 1)
        coef_1 = 0.5 * ratio
        loss_pos = coef_1 * torch.log(pred_score + eps) * pmask
        loss_neg = coef_0 * torch.log(1.0 - pred_score + eps) * nmask
        return -(loss_pos.sum() + loss_neg.sum()) / num_entries

    def __call__(self, pred_bm, pred_start, pred_end, gt_iou_map, gt_start,
                 gt_end, bm_mask, generator=None, weight_tem=1.0,
                 weight_pem_reg=10.0, weight_pem_cls=1.0):
        if pred_bm.shape[-1] == 2:
            pred_bm_reg, pred_bm_cls = pred_bm[..., 0], pred_bm[..., 1]
        else:
            pred_bm_reg, pred_bm_cls = pred_bm[:, 0], pred_bm[:, 1]
        gt_iou_map = gt_iou_map.to(pred_bm.dtype) * bm_mask
        uniforms = draw_uniforms(generator, gt_iou_map.shape,
                                 gt_iou_map.device)
        pem_reg = self.pem_reg_loss(uniforms, pred_bm_reg, gt_iou_map,
                                    bm_mask)
        pem_cls = self.pem_cls_loss(pred_bm_cls, gt_iou_map, bm_mask)
        tem = self.tem_loss(pred_start, pred_end, gt_start, gt_end)
        total = weight_tem * tem + weight_pem_reg * pem_reg + \
            weight_pem_cls * pem_cls
        return total, tem, pem_reg, pem_cls

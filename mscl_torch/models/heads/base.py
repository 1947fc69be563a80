"""Top-k accuracy for the heads (port of ``mscl_tpu/models/heads/base.py``)."""
from __future__ import annotations

import torch


@torch.no_grad()
def topk_accuracy(cls_score: torch.Tensor, labels: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """Sort-free top-k accuracy: the label's rank is the number of logits
    strictly greater than its own; ties count as hits, as in the JAX one."""
    labels = labels.reshape(-1).long()
    k = min(k, cls_score.shape[-1])
    label_logit = cls_score.gather(-1, labels[:, None])
    rank = (cls_score > label_logit).sum(dim=-1)
    return (rank < k).float().mean()

"""MoCoV2 tower: two encoders, a decayed negative queue, InfoNCE.

Port of ``mscl_tpu/models/recognizers/moco.py``:
  - query and key encoder + neck + MLP; the key side takes no gradient and
    follows the query side by an EMA run before the forward, with the
    cosine-annealed momentum of ``iters`` (samples seen);
  - the queue (dim, K), its ``queue_ptr``, the per-column age ``count`` and
    ``iters`` are buffers;
  - InfoNCE logits [l_pos | q . (queue * t_decay**count)] / T, label 0, with
    the negative product in the decayed-InfoNCE kernel;
  - a compute ``dtype`` (flax's semantics, ``models/compute_dtype.py``) for
    the encoders, necks and MLPs: q, k and l_pos are in it, l_neg promotes
    to float32 as the JAX einsum of q with the float32 queue does (so the
    kernel takes q in float32), and the queue stays float32;
  - key BN statistics over the global batch (no ShuffleBN), as in the JAX
    package;
  - the key side's multi-level features are not computed: no head reads
    them (LMCL reads the query side's), and its embedding is pooled from the
    backbone's last stage, so the key neck's pyramid would be dead work
    (under jit, XLA drops it from the reference too). ``neck_k`` keeps its
    parameters for the EMA and the weight converter.

The enqueue is out of place: each one makes a new queue tensor. The
negative products of this pass, and the cross-modal head later in the step,
hold the pre-enqueue queue through autograd and through the returned
``bank``; an in-place write would change them under their feet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import compute_dtype
from ..builder import RECOGNIZERS, build_backbone, build_head, build_neck
from ...ops.decayed_infonce import decay_weights, decayed_neg

Q2K_PAIRS = (('encoder_q', 'encoder_k'), ('neck_q', 'neck_k'),
             ('mlp_q', 'mlp_k'))
KEY_PATTERNS = tuple(k for _, k in Q2K_PAIRS)


def check_identity_aug(aug):
    """A MoCoV2 tower on its own (its own ``train_step``, not ported yet)
    would run its aug; inside MSCLWithAug the composite runs it."""
    if aug is not None and dict(aug).get('type') != 'IdentityAug':
        raise NotImplementedError(
            f"a MoCoV2 tower's own aug {dict(aug).get('type')} is not ported "
            "yet; use dict(type='IdentityAug') (MSCLWithAug runs its aug)")


class MLP(nn.Module):
    """MoCo v2 projection: Linear-ReLU-Linear (or one Linear)."""

    def __init__(self, dim_in: int, dim: int, mlp: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = mlp
        self.dtype = dtype
        if mlp:
            self.fc1 = nn.Linear(dim_in, dim_in)
            self.fc2 = nn.Linear(dim_in, dim)
        else:
            self.fc1 = nn.Linear(dim_in, dim)
        self.dim_in = dim_in

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """torch Linear default init; every bias bound is 1/sqrt(dim_in)."""
        bound = self.dim_in ** -0.5
        for m in (self.fc1, self.fc2) if self.mlp else (self.fc1,):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=gen)
            nn.init.uniform_(m.bias, -bound, bound, generator=gen)

    def forward(self, x):
        def fc(layer, t):
            return compute_dtype.linear(layer, t, self.dtype)

        if self.mlp:
            return fc(self.fc2, F.relu(fc(self.fc1, x)))
        return fc(self.fc1, x)


@RECOGNIZERS.register_module()
class MoCoV2(nn.Module):

    def __init__(self, backbone, neck, moco_head, im_key='imgs', dim_in=512,
                 dim=128, K=65536, m_base=0.994, t_decay=0.99999,
                 max_iters=1, T=0.07, mlp=False, aux_info=(), aug=None,
                 train_cfg=None, test_cfg=None, dtype=None):
        super().__init__()
        check_identity_aug(aug)
        self.dtype = compute_dtype.resolve_dtype(dtype)
        bb_cfg = dict(backbone, dtype=self.dtype)
        bb_cfg.pop('pretrained', None)
        self.encoder_q = build_backbone(bb_cfg)
        self.encoder_k = build_backbone(bb_cfg)
        self.neck_q = build_neck(dict(neck, dtype=self.dtype))
        self.neck_k = build_neck(dict(neck, dtype=self.dtype))
        self.mlp_q = MLP(dim_in, dim, mlp, self.dtype)
        self.mlp_k = MLP(dim_in, dim, mlp, self.dtype)
        self.moco_head = build_head(dict(moco_head))
        for kn in KEY_PATTERNS:
            getattr(self, kn).requires_grad_(False)
        self.K, self.T, self.t_decay = K, T, t_decay
        self.m_base, self.max_iters = m_base, max_iters
        self.register_buffer('queue', torch.zeros(dim, K))
        self.register_buffer('count', torch.zeros(K, dtype=torch.long))
        self.register_buffer('queue_ptr', torch.zeros((), dtype=torch.long))
        self.register_buffer('iters', torch.zeros((), dtype=torch.long))

    # ------------------------------------------------------------ state
    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """Query side from ``gen``, a column-normalised randn queue, then
        the key side copied from the query side."""
        self.encoder_q.init_weights(gen)
        self.neck_q.init_weights(gen)
        self.mlp_q.init_weights(gen)
        queue = torch.randn(self.queue.shape, generator=gen)
        self.queue = queue / queue.norm(dim=0, keepdim=True)
        self.sync_key()

    @torch.no_grad()
    def sync_key(self):
        """k <- q for parameters and BN statistics."""
        for qn, kn in Q2K_PAIRS:
            getattr(self, kn).load_state_dict(getattr(self, qn).state_dict())

    def momentum(self) -> torch.Tensor:
        """m = 1 - (1 - m_base) (cos(pi min(iters / max_iters, 1)) + 1) / 2."""
        factor = torch.clamp(self.iters.float() / self.max_iters, max=1.0)
        return 1.0 - 0.5 * (1.0 - self.m_base) * (
            torch.cos(math.pi * factor) + 1.0)

    @torch.no_grad()
    def ema_(self, m: torch.Tensor):
        """k = k * m + q * (1 - m) over every key-side parameter."""
        for qn, kn in Q2K_PAIRS:
            ks = list(getattr(self, kn).parameters())
            qs = list(getattr(self, qn).parameters())
            if ks:
                torch._foreach_mul_(ks, m)
                torch._foreach_add_(ks, torch._foreach_mul(qs, 1.0 - m))

    @torch.no_grad()
    def _enqueue(self, k: torch.Tensor):
        b = k.shape[0]
        if self.K % b:
            raise ValueError(f'K={self.K} % global batch={b} != 0')
        cols = self.queue_ptr + torch.arange(b, device=k.device)
        self.queue = self.queue.index_copy(1, cols, k.T.to(self.queue.dtype))
        idx = torch.arange(self.K, device=k.device)
        in_window = (idx >= self.queue_ptr) & (idx < self.queue_ptr + b)
        self.count = torch.where(in_window, 1, self.count + 1)
        self.queue_ptr = (self.queue_ptr + b) % self.K

    # ---------------------------------------------------------- forward
    def extract_feat(self, im_q, im_k):
        q_emb, q_mlvl = self.neck_q(self.encoder_q(im_q))
        q = F.normalize(self.mlp_q(q_emb), dim=1, eps=1e-12)
        with torch.no_grad():
            k_emb, _ = self.neck_k(self.encoder_k(im_k), mlvl=False)
            k = F.normalize(self.mlp_k(k_emb), dim=1, eps=1e-12)
        return q, q_mlvl, k

    def forward_train(self, im_q, im_k, update_queue: bool = True):
        """im_q/im_k: (B, C, T, H, W). Returns (losses, features); features
        carry ``bank`` = (queue, decay) as they were before the enqueue."""
        q, q_mlvl, k = self.extract_feat(im_q, im_k)
        l_pos = (q * k).sum(dim=1, keepdim=True)
        decay = decay_weights(self.count, self.t_decay)
        bank = (self.queue, decay)
        l_neg = decayed_neg(q.float(), *bank)
        logits = torch.cat([l_pos.float(), l_neg], dim=1) / self.T
        labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
        if update_queue:
            self._enqueue(k)
        if self.training:
            self.iters = self.iters + k.shape[0]
        losses = self.moco_head.loss(logits, labels)
        return losses, dict(q=q, q_mlvl=q_mlvl, k=k, q_neg=l_neg,
                            bank=bank)


def build_ema_fn(model):
    """A callable that EMA-updates both key towers of an MSCLWithAug in
    place before the forward (the JAX ``build_ema_fn``).

    MSCLWithAug runs its flow tower twice a step and the reference updates
    the key encoder inside every forward, so the flow tower's step momentum
    is m**2."""
    rgb, flow = model.recognizer, model.recognizer_flow

    def fn():
        rgb.ema_(rgb.momentum())
        flow.ema_(flow.momentum() ** 2)
    return fn

"""MoCo towers: two encoders, a decayed negative queue, InfoNCE.

Port of ``mscl_tpu/models/recognizers/moco.py`` (``_MoCoBase`` as
``MoCoBase``, ``MoCo``, ``MoCoV2``):
  - query and key encoder + neck + MLP; the key side takes no gradient and
    follows the query side by an EMA run before the forward, with the
    fixed momentum ``m`` (MoCo) or the cosine-annealed momentum of
    ``iters``, the samples seen (MoCoV2);
  - a tower trained on its own (the plain-MoCo configs) runs its config's
    device aug before the forward, drawn from its own generator
    (``AugGenerator``, as MSCLWithAug's), and its ``train_step`` takes the
    ``[q, k]`` pair of ``batch[im_key]``; inside MSCLWithAug the composite
    runs the aug and a tower's own must be IdentityAug;
  - the queue (dim, K), its ``queue_ptr``, the per-column age ``count`` and
    ``iters`` are buffers;
  - InfoNCE logits [l_pos | q . (queue * t_decay**count)] / T, label 0, with
    the negative product in the decayed-InfoNCE kernel;
  - a compute ``dtype`` (flax's semantics, ``models/compute_dtype.py``) for
    the encoders, necks and MLPs: q, k and l_pos are in it, l_neg promotes
    to float32 as the JAX einsum of q with the float32 queue does (so the
    kernel takes q in float32), and the queue stays float32;
  - key BN statistics over the global batch, as in the JAX package; or,
    with ``shuffle_bn = g > 1``, ShuffleBN: a permutation of the global key
    batch drawn from the aug's generator after the aug's draws (the JAX
    step's 'moco' stream), the key encoder, neck and MLP run per group of
    B/g rows of it, each group with its own BN statistics and running-stat
    update (in a process group too: ``batch_norm.local_statistics``), and
    the keys put back in order;
  - ``forward_train_pair``: two passes (MSCLWithAug's base and rotated
    flow) as one forward at a batch of 2B, so their BN statistics are
    joint, then the loss and the queue bookkeeping per pass, in order;
  - the key side's multi-level features are not computed: no head reads
    them (LMCL reads the query side's), and its embedding is pooled from the
    backbone's last stage, so the key neck's pyramid would be dead work
    (under jit, XLA drops it from the reference too). ``neck_k`` keeps its
    parameters for the EMA and the weight converter.

In a process group (``parallel/dist.py``) each rank holds its rows of the
global batch: its q against the replicated queue, the keys of every rank
gathered in rank order for the enqueue (as the JAX step's global batch holds
them), and ``iters`` advanced by the global batch, so the queue state stays
the same on every rank. ShuffleBN gathers the key clips and every rank runs
every group on the global batch (the key side takes no gradient), so the
groups and their running statistics are those of one device.

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
from ..builder import (RECOGNIZERS, build_backbone, build_head, build_neck,
                       build_ssl_aug)
from ...ops import batch_norm as bn_ops
from ...ops.decayed_infonce import decay_weights, decayed_neg
from ...parallel import dist
from .base import parse_losses

Q2K_PAIRS = (('encoder_q', 'encoder_k'), ('neck_q', 'neck_k'),
             ('mlp_q', 'mlp_k'))
KEY_PATTERNS = tuple(k for _, k in Q2K_PAIRS)


class AugGenerator:
    """A model's device aug (``self.aug``), drawn from the model's own
    ``torch.Generator`` (the JAX step's 'moco' stream): made on the batch's
    device from ``aug_seed`` at first use, saved in checkpoints by
    ``aug_state`` and put back by ``set_aug_state``, so validation by loss
    and resume leave the draws as they were."""
    aug_seed, _aug_gen = 0, None

    def seed_aug(self, seed: int):
        """Restart the aug's draws from seed (on the device of the next
        batch)."""
        self.aug_seed, self._aug_gen = seed, None

    def aug_generator(self, device: torch.device) -> torch.Generator:
        """The aug's generator, made on device from aug_seed at first use
        (and again if the batch moves to another device)."""
        if self._aug_gen is None or self._aug_gen.device != device:
            self._aug_gen = torch.Generator(device=device).manual_seed(
                self.aug_seed)
        return self._aug_gen

    def aug_state(self):
        """The aug generator's state (a CPU byte tensor), None before the
        first batch made it."""
        return None if self._aug_gen is None else self._aug_gen.get_state()

    def set_aug_state(self, state) -> None:
        """Put the aug generator back as ``aug_state`` gave it, on the
        model's device (None: made from aug_seed at the next batch)."""
        self._aug_gen = None
        if state is not None:
            device = next(self.parameters()).device
            self.aug_generator(device).set_state(state)


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


class MoCoBase(AugGenerator, nn.Module):

    def __init__(self, backbone, neck, moco_head, im_key='imgs', dim_in=512,
                 dim=128, K=65536, m=0.999, m_base=0.994, t_decay=0.99999,
                 max_iters=1, T=0.07, mlp=False, aux_info=(), aug=None,
                 train_cfg=None, test_cfg=None, shuffle_bn=0, dtype=None):
        super().__init__()
        self.shuffle_bn = shuffle_bn
        self.dtype = compute_dtype.resolve_dtype(dtype)
        self.aug = build_ssl_aug(dict(aug or dict(type='IdentityAug')))
        self.im_key = im_key
        self.aux_info = tuple(aux_info)
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
        self.m, self.m_base, self.max_iters = m, m_base, max_iters
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
        """The EMA momentum of this step."""
        raise NotImplementedError

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
        """k: this rank's keys; every rank's are enqueued, in rank order."""
        k = dist.all_gather_rows(k, tag='moco_keys')
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
    def extract_feat(self, im_q, im_k, gen=None, parts=1):
        """q, q's multi-level features and k. ``gen`` draws ShuffleBN's
        permutation (default: this tower's aug generator); ``parts`` says
        how many passes the rows hold, one after another (2 in
        forward_train_pair), so that ShuffleBN permutes the global batch
        as one device holds it."""
        q_emb, q_mlvl = self.neck_q(self.encoder_q(im_q))
        q = F.normalize(self.mlp_q(q_emb), dim=1, eps=1e-12)
        with torch.no_grad():
            if self.training and self.shuffle_bn > 1:
                k = self._shuffled_keys(im_k, gen, parts)
            else:
                k = self._key_forward(im_k)
        return q, q_mlvl, k

    def _key_forward(self, im_k):
        k_emb, _ = self.neck_k(self.encoder_k(im_k), mlvl=False)
        return F.normalize(self.mlp_k(k_emb), dim=1, eps=1e-12)

    def draw_shuffle(self, gen, b, device) -> torch.Tensor:
        """ShuffleBN's permutation of a global key batch of b."""
        return torch.randperm(b, generator=gen, device=device)

    def _shuffled_keys(self, im_k, gen, parts):
        """ShuffleBN: the global key batch permuted, the key side run per
        group of B/g of it with the group's own BN statistics, the keys put
        back in order; this rank's rows."""
        if gen is None:
            gen = self.aug_generator(im_k.device)
        x = torch.cat([dist.all_gather_rows(part, tag='shuffle_bn')
                       for part in im_k.chunk(parts)])
        b, g = x.shape[0], self.shuffle_bn
        if b % g:
            raise ValueError(f'batch {b} % shuffle_bn groups {g} != 0')
        perm = self.draw_shuffle(gen, b, x.device)
        with bn_ops.local_statistics():
            k = torch.cat([self._key_forward(part)
                           for part in x[perm].chunk(g)])
        k = k[torch.argsort(perm)]
        return torch.cat([dist.rank_rows(part) for part in k.chunk(parts)])

    def _instance_loss(self, q, q_mlvl, k, update_queue, aux_info):
        """The decayed-queue InfoNCE, the enqueue and ``iters``, the head's
        loss: everything after the forward, shared by forward_train and
        forward_train_pair."""
        l_pos = (q * k).sum(dim=1, keepdim=True)
        decay = decay_weights(self.count, self.t_decay)
        bank = (self.queue, decay)
        l_neg = decayed_neg(q.float(), *bank)
        logits = torch.cat([l_pos.float(), l_neg], dim=1) / self.T
        labels = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
        if update_queue:
            self._enqueue(k)
        if self.training:
            self.iters = self.iters + k.shape[0] * dist.world_size()
        losses = self.moco_head.loss(logits, labels, **(aux_info or {}))
        return losses, dict(q=q, q_mlvl=q_mlvl, k=k, q_neg=l_neg,
                            bank=bank)

    def forward_train(self, im_q, im_k, update_queue: bool = True,
                      aux_info=None, gen=None):
        """im_q/im_k: (B, C, T, H, W), after the aug. Returns (losses,
        features); features carry ``bank`` = (queue, decay) as they were
        before the enqueue. ``aux_info`` goes on to the head's loss; ``gen``
        draws ShuffleBN's permutation."""
        q, q_mlvl, k = self.extract_feat(im_q, im_k, gen)
        return self._instance_loss(q, q_mlvl, k, update_queue, aux_info)

    def forward_train_pair(self, im_q_a, im_k_a, im_q_b, im_k_b,
                           update_queue_b: bool = True, aux_info=None,
                           gen=None):
        """Two forward_train passes with one forward at a batch of 2B: the
        BN statistics are joint over both passes (the JAX package's opt-in
        divergence from the reference, which takes them per pass); the
        loss and queue bookkeeping then run per pass, a first (it
        enqueues), b after it (it enqueues only if update_queue_b), so b's
        negatives are the queue a left. Returns ((losses, features) of a,
        of b)."""
        b = im_q_a.shape[0]
        q2, q_mlvl2, k2 = self.extract_feat(torch.cat([im_q_a, im_q_b]),
                                            torch.cat([im_k_a, im_k_b]), gen,
                                            parts=2)
        return (self._instance_loss(q2[:b], [m[:b] for m in q_mlvl2], k2[:b],
                                    True, aux_info),
                self._instance_loss(q2[b:], [m[b:] for m in q_mlvl2], k2[b:],
                                    update_queue_b, aux_info))

    def train_step(self, batch):
        """A tower trained on its own: ``batch[im_key]`` is the [q, k] pair
        of NCTHW tensors, cast to the compute dtype, then the aug; the
        ``aux_info`` keys of the batch go on to the aug and the head.
        Returns (total loss, log_vars)."""
        im_q, im_k = (x.to(self.dtype) for x in batch[self.im_key])
        aux_info = {item: batch[item] for item in self.aux_info}
        im_q, im_k, aux_info = self.aug(self.aug_generator(im_q.device),
                                        im_q, im_k, aux_info)
        losses, _ = self.forward_train(im_q, im_k, aux_info=aux_info)
        return parse_losses(losses)


@RECOGNIZERS.register_module()
class MoCo(MoCoBase):
    """Fixed momentum ``m``."""

    def momentum(self) -> torch.Tensor:
        return torch.tensor(self.m, dtype=torch.float32,
                            device=self.iters.device)


@RECOGNIZERS.register_module()
class MoCoV2(MoCoBase):
    """Cosine-annealed momentum."""

    def momentum(self) -> torch.Tensor:
        """m = 1 - (1 - m_base) (cos(pi min(iters / max_iters, 1)) + 1) / 2."""
        factor = torch.clamp(self.iters.float() / self.max_iters, max=1.0)
        return 1.0 - 0.5 * (1.0 - self.m_base) * (
            torch.cos(math.pi * factor) + 1.0)


def build_ema_fn(model):
    """A callable that EMA-updates the key towers in place before the
    forward (the JAX ``build_ema_fn``): a tower on its own with its step's
    momentum; both towers of a composite (MSCLWithAug, MSCL, MoDist).

    MSCLWithAug runs its flow tower twice a step and the reference updates
    the key encoder inside every forward, so the flow tower's step momentum
    is m**2 (also with batch_flow_passes, as in JAX); MSCL and MoDist run
    it once. The JAX function tells them apart by the class's name, and so
    does this one."""
    if isinstance(model, MoCoBase):
        def tower_fn():
            model.ema_(model.momentum())
        return tower_fn
    rgb, flow = model.recognizer, model.recognizer_flow
    flow_passes = 2 if type(model).__name__ == 'MSCLWithAug' else 1

    def fn():
        rgb.ema_(rgb.momentum())
        flow.ema_(flow.momentum() ** flow_passes)
    return fn

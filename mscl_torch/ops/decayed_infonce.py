"""Decayed-InfoNCE negatives: ``l_neg = q @ (queue * t_decay**count)``.

Port of ``mscl_tpu/ops/decayed_infonce.py``. On a CUDA tensor both products
run in the hand-written Hopper kernels of ``csrc/decayed_infonce.cu``
(forward ``l_neg``, backward ``dq``; the source note there gives what bounds
them and how). On a CPU tensor they run their plain PyTorch versions below,
which are also what the kernels are checked against. A CUDA call never falls
back to the plain version: it launches the kernel or raises.

queue and count get no gradient (the reference's ``weight.clone().detach()``).
The autograd function saves queue and decay with ``save_for_backward``, so an
in-place change to either between forward and backward is caught by torch's
version counter; the MoCo tower therefore enqueues out of place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

FWD_TILE_K = 128           # forward K-tile: K=65536 gives 512 blocks
DQ_TILE_K = 512            # backward split-K slab: 128 partial (B, C) sums
MAX_C = 256                # widest feature the kernels' shared tiles take


def decay_weights(count: torch.Tensor, t_decay: float) -> torch.Tensor:
    """Per-column decay ``t_decay ** count`` in float32, shape (K,)."""
    return torch.pow(t_decay, count.to(torch.float32))


def l_neg_plain(q, queue, decay):
    return q @ (queue * decay[None, :])


def dq_plain(g, queue, decay):
    return g @ (queue * decay[None, :]).T


def _tiles(name, k):
    """The forward and backward K-tiles for a queue of K columns. Both
    kernels take whole tiles only (the TPU forward asserts it; its backward
    silently dropped a ragged tail), and both wrappers check both tiles, so
    a K the backward would refuse fails in the forward already."""
    tiles = min(FWD_TILE_K, k), min(DQ_TILE_K, k)
    for tile in tiles:
        if k % tile:
            raise ValueError(f'{name}: K={k} is not a multiple of the '
                             f'K-tile {tile}')
    return tiles


def _check(name, q_like, cols, queue, decay):
    """What the kernels take: a (B, cols) and a (C, K) float32 matrix and a
    (K,) decay, contiguous and on one device, with C <= MAX_C; cols is C for
    the forward's q and K for the backward's g."""
    if q_like.dim() != 2 or queue.dim() != 2:
        raise ValueError(f'{name}: 2-D operands only')
    b, c = q_like.shape[0], queue.shape[0]
    k = queue.shape[1]
    for t in (q_like, queue, decay):
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: float32 tensors only, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
        if t.device != q_like.device:
            raise ValueError(f'{name}: operands on {t.device} and '
                             f'{q_like.device}')
    if q_like.shape[1] != {'C': c, 'K': k}[cols]:
        raise ValueError(f'{name}: {tuple(q_like.shape)} does not fit a '
                         f'queue of {tuple(queue.shape)}')
    if decay.shape != (k,):
        raise ValueError(f'{name}: decay shape {tuple(decay.shape)} != ({k},)')
    if c > MAX_C:
        raise ValueError(f'{name}: C={c} > {MAX_C}')
    return b, c, k


def _on_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('decayed_infonce')
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.decayed_infonce_l_neg.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.decayed_infonce_l_neg.restype = i
    lib.decayed_infonce_dq.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.decayed_infonce_dq.restype = i
    return lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {err}')


def l_neg(q: torch.Tensor, queue: torch.Tensor,
          decay: torch.Tensor) -> torch.Tensor:
    """(B,C) @ ((C,K) * (K,)) -> (B,K): kernel on CUDA, plain on CPU."""
    tile, _ = _tiles('l_neg', queue.shape[1])
    if not _on_cuda(q):
        return l_neg_plain(q, queue, decay)
    q = q.contiguous()
    b, c, k = _check('l_neg', q, 'C', queue, decay)
    out = torch.empty((b, k), device=q.device, dtype=torch.float32)
    err = _lib().decayed_infonce_l_neg(
        _ptr(q), _ptr(queue), _ptr(decay), _ptr(out), b, c, k, tile,
        _stream(q.device))
    _raise_on(err, 'decayed_infonce_l_neg')
    l_neg.launches += 1
    return out


def dq(g: torch.Tensor, queue: torch.Tensor,
       decay: torch.Tensor) -> torch.Tensor:
    """(B,K) @ ((C,K) * (K,))^T -> (B,C): split-K kernel on CUDA."""
    _, tile = _tiles('dq', queue.shape[1])
    if not _on_cuda(g):
        return dq_plain(g, queue, decay)
    g = g.contiguous()
    b, c, k = _check('dq', g, 'K', queue, decay)
    partial = torch.empty((k // tile, b, c), device=g.device,
                          dtype=torch.float32)
    out = torch.empty((b, c), device=g.device, dtype=torch.float32)
    err = _lib().decayed_infonce_dq(
        _ptr(g), _ptr(queue), _ptr(decay), _ptr(partial), _ptr(out), b, c,
        k, tile, _stream(g.device))
    _raise_on(err, 'decayed_infonce_dq')
    dq.launches += 1
    return out


# kernel launches made by each wrapper (the chip check reads and resets them)
l_neg.launches = 0
dq.launches = 0


class DecayedNeg(torch.autograd.Function):
    """l_neg with the dq kernel as its backward; queue/decay are constants."""

    @staticmethod
    def forward(ctx, q, queue, decay):
        ctx.save_for_backward(queue, decay)
        return l_neg(q, queue, decay)

    @staticmethod
    def backward(ctx, g):
        queue, decay = ctx.saved_tensors
        return dq(g, queue, decay), None, None


def decayed_neg(q, queue, decay):
    """Differentiable in q only: ``q @ (queue * decay)``, with decay from
    ``decay_weights(count, t_decay)``."""
    return DecayedNeg.apply(q, queue.detach(), decay.detach())
